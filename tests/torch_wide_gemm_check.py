"""The wide path's layer GEMM (csrc/wide.cu's wd_gemm, ops/kernels/wide.py's
``gemm``) on seeded operands against float64 sums of the same bf16 inputs,
at every epilogue it runs: shared by the card test
(tests/test_torch_kernels_cuda.py::test_wide_gemm_matches_float64) and
chip_smoke.py's phase 20. Imports no JAX. On the CPU, the replay's
``gemm`` (tests/torch_wide_replay.py) takes wide.gemm's place."""

import numpy as np
import torch


# the wide path's layer GEMM (wd_gemm) alone: name -> (rows, device count
# or None, base, n, kc0, kc1, the epilogue's parts)
WIDE_GEMM_CASES = {
    "130 rows, n 64": (130, None, 0, 64, 2, 0, ("bias", "relu", "out", "st")),
    "40,000 rows, n 192, kc1 2": (40000, None, 0, 192, 3, 2, ("bias", "relu", "out", "f32")),
    "40,000 rows, n 256, K3 backward": (40000, None, 0, 256, 4, 0,
                                        ("ga", "mask", "bp", "out", "st")),
    "count past base, n 640, kc1 1": (4096, 9000, 6000, 640, 10, 1,
                                      ("bias", "relu", "out", "st", "f32_add")),
    "count 0": (4096, 100, 500, 256, 4, 0, ("bias", "relu", "out", "st")),
}


def wide_gemm_case(name, dev, gemm):
    """Runs one WIDE_GEMM_CASES case twice through ``gemm`` (``wide.gemm``'s
    signature) on seeded bf16 operands on ``dev``; returns (the first
    call's outputs, whether the second call's are bit for bit the same,
    {output: the largest error beyond its bar}, {output: its max abs
    error}) against float64 sums of the same bf16 inputs. The bar: one
    bf16 step of the value (bf16 outputs) plus an fp32 sum's bound,
    gamma(K + 2) (|A| @ |W| + |bias| + |alpha term|), and for the bias
    partials the bound of a 128-term fp32 sum on top; rows past the count
    are compared nowhere, and with none every output is left as it was."""
    from adanerf_tpu_torch.ops.kernels import nerf_train as nt
    from adanerf_tpu_torch.ops.kernels.megakernel_compact import _Packer
    from adanerf_tpu_torch.ops.kernels.nerf_train_check import gamma
    from adanerf_tpu_torch.ops.kernels import wide
    from torch_wide_replay import from_tiles, to_tiles
    rows, count, base, n, kc0, kc1, parts = WIDE_GEMM_CASES[name]
    R, K = wide.pad_rows(rows), 64 * (kc0 + kc1)
    M = rows if count is None else max(0, min(count - base, rows))
    rng = np.random.default_rng(rows + n + K)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    A = bf(rng.uniform(-1, 1, (R, K)))
    W = bf(rng.standard_normal((K, n)) / np.sqrt(K))
    pk = _Packer()
    pk.layer([(W[:64 * kc0].float().numpy(), None)] +
             ([(W[64 * kc0:].float().numpy(), None)] if kc1 else []), n)
    ins = {"a0": to_tiles(A[:, :64 * kc0]), "w": bf(np.concatenate(pk.w)),
           "a1": to_tiles(A[:, 64 * kc0:]) if kc1 else None}
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    ga = torch.from_numpy(rng.standard_normal((rows, 4)).astype(np.float32))
    wa = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    mask = bf(rng.integers(0, 2, (R, n)))
    f32_cols, ldf = n - 42, n - 30
    pre = torch.from_numpy(rng.standard_normal((rows, ldf)).astype(np.float32))
    kw = dict(relu="relu" in parts, kc1=kc1, base=base, ldf=ldf, f32_cols=f32_cols,
              f32_add="f32_add" in parts, ldbp=n + 16)
    for part in ("bias", "ga", "wa", "mask"):
        if part in parts or (part == "wa" and "ga" in parts):
            kw[part] = {"bias": bias, "ga": ga, "wa": wa, "mask": nt.tile_rows(mask, R // 64)}[part]
    if count is not None:
        kw["count"] = torch.tensor([count], dtype=torch.int32)

    def outputs():  # sentinels where nothing is written
        o = {}
        for part in parts:
            if part in ("out", "st"):
                o[part] = torch.full((R * n,), 7.0, dtype=torch.bfloat16)
            elif part in ("f32", "f32_add"):
                o["f32"] = pre.clone() if part == "f32_add" else torch.full((rows, ldf), 7.0)
            elif part == "bp":
                o["bp"] = torch.full((R // 128, n + 16), 7.0)
        return {k: v.to(dev) for k, v in o.items()}
    runs = []
    for _ in range(2):
        o = outputs()
        gemm(dev, ins["a0"].to(dev), kc0, ins["w"].to(dev), n, rows,
             a1=None if ins["a1"] is None else ins["a1"].to(dev),
             **{k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}, **o)
        runs.append({k: v.cpu() for k, v in o.items()})
    same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    got = runs[0]
    if M == 0:
        fresh = outputs()
        err = {k: 0.0 if torch.equal(v, fresh[k].cpu()) else float("inf") for k, v in got.items()}
        return got, same, err, dict(err)

    a, w = A.double(), W.double()
    z = a @ w
    size = a.abs() @ w.abs()
    if "ga" in parts:
        t = torch.zeros(R, dtype=torch.float64)
        t[:M] = ga[:M, 3].to(torch.bfloat16).double()
        z += t[:, None] * wa.double()
        size += (t[:, None] * wa.double()).abs()
    if "bias" in parts:
        z += bias.double()
        size += bias.double().abs()
    bound = gamma(K + 2) * size
    if "relu" in parts:
        z = z.clamp(min=0)
    if "mask" in parts:
        z[mask == 0] = 0.0
    err, max_abs = {}, {}

    def excess(g, ref, bar, key):
        d = (g.double() - ref).abs()
        max_abs[key] = float(d.max())
        err[key] = float((d - bar).max())
    if "out" in got:
        excess(from_tiles(got["out"], R, n)[:M], z[:M], 2.0 ** -8 * z[:M].abs() + bound[:M], "out")
    if "st" in got:
        excess(nt.untile_rows(got["st"], R // 64, n, R)[:M], z[:M],
               2.0 ** -8 * z[:M].abs() + bound[:M], "st")
    if "f32" in got:
        ref = z[:M, :f32_cols] + (pre[:M, :f32_cols].double() if "f32_add" in parts else 0)
        excess(got["f32"][:M, :f32_cols], ref, bound[:M, :f32_cols] + 2.0 ** -23 * ref.abs(),
               "f32")
    if "bp" in got:
        T = -(-M // 128)
        zt, bt = z.view(R // 128, 128, n)[:T], bound.view(R // 128, 128, n)[:T]
        ref = zt.sum(1)
        bar = (bt + 2.0 ** -24 * zt.abs()).sum(1) + gamma(128) * zt.abs().sum(1)
        excess(got["bp"][:T, :n], ref, bar, "bp")
    return got, same, err, max_abs
