"""Times of the port's kernels on one NVIDIA card: the bf16 frame
renderers K1 and K2, and the train step's K3.

  python adanerf_tpu_torch/frame_times.py [--root DIR] [--only frames|k3|gemm|wide|sparse]

Frames: renders ``demo/trained_mscene_export`` at 800x800 from
chip_smoke.py's pose through K1 (``MegakernelCompact``) and K2
(``MegakernelDense``) in bf16, at the export's threshold, at 0.01 and at
1e-4, and prints for each the times of the ``stages`` ladder
(``frame_ms``: the whole frame, the front, front + shade), the timing
chip_smoke.py's phases 7, 11 and 13 use too. K3: the export's NeRF through
``NerfTrainKernel`` at the dense step's 524,288 rows (seeded inputs in the
encoding's range): the forward and the backward as the train step calls
them (the autograd function, packing included; the median of ROUNDS means
of REPS calls), and the dense step itself (``train.main`` on
``configs/dense_training.ini`` and ``demo/mscene``, bf16, the NeRF
unlocked: the mean and median of K3_STEPS steps after K3_WARMUP).
``gemm``: the wide path's layer GEMM (``wide.gemm``, csrc/wide.cu's
``wd_gemm``) alone at GEMM_ROWS rows on each of GEMM_SHAPES (a W x W layer;
K3's forward epilogue, or its backward one: relu mask, bias partials,
scratch), with its TFLOP/s, bound, a digest of its outputs (two versions
that compute bit for bit alike print the same) and ``torch.addmm``'s time
on bf16 operands of the same shape as the yardstick. ``wide``: K1 and K2 at
800x800 on seeded exports of each of WIDE_WIDTHS, S=16 and every slot live
(the port's fine export at that width sits at the cap), and K3 at
K3_ROWS rows at each of those widths, on whichever route the checkout
takes them. ``sparse``: K1 at 800x800 on phase 20's seeded 640-wide export
(S=8, threshold 0.2, a few live slots a ray), its wide shade launching
the live rows' chunks only, and (where the checkout reads its live count,
``MegakernelCompact._live_rows``) every chunk of the frame's slots.
``--root`` imports the port from another checkout (its
``adanerf_tpu_torch``, built into its own ``_build``), so two versions can
be timed in turns on one card: run it for each, in the order A, B, B, A.
The card's clocks, power and processes (``card_state``) are printed before
and after. The last line is one JSON object with every number. Exits
non-zero where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    # run as a script, this file's directory leads sys.path: drop it, so that
    # the port's subpackages (config, data, utils) shadow no other module
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") !=
                   os.path.dirname(os.path.abspath(__file__))]

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROUNDS, REPS = 5, 4  # ladder rounds; launches per timed mean
K3_ROWS = 2 * 2048 * 128  # the dense step's shading rows
K3_WARMUP, K3_STEPS = 3, 10
GEMM_ROWS = K3_ROWS
# name: (K, n, epilogue): K3's forward layer (bias, relu, out) or the
# backward's cotangent layer (relu mask, bias partials, out, scratch)
GEMM_SHAPES = {"512": (512, 512, "forward"), "640": (640, 640, "forward"),
               "1024": (1024, 1024, "forward"), "1024 backward": (1024, 1024, "backward")}
WIDE_WIDTHS = (384, 512)
PEAK_BF16, HBM_BPS = 989e12, 3.35e12  # H100 SXM (NVIDIA data sheet, dense)


def time_ms(fn, reps):
    """Mean ms of `reps` calls of fn on the current stream (CUDA events),
    after one warm-up call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def frame_ms(k, dirs, pose, rot):
    """{"ms", "front_ms", "front_shade_ms"} of a render kernel's stage
    ladder (3: the whole frame, 1: the front, 2: front + shade): for each,
    the median over ROUNDS rounds, the three interleaved in each, of the
    mean of REPS launches."""
    times = {1: [], 2: [], 3: []}
    for _ in range(ROUNDS):
        for st in times:
            times[st].append(time_ms(lambda: k(dirs, pose, rot, stages=st), REPS))
    med = {st: float(np.median(v)) for st, v in times.items()}
    return {"ms": med[3], "front_ms": med[1], "front_shade_ms": med[2]}


def _smi(*args):
    """nvidia-smi's csv answer, or None where it gives none."""
    try:
        r = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except OSError:
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def card_state():
    """One line from nvidia-smi: the SM clock and its maximum, the memory
    clock, power draw and limit, temperature, the active clock event
    (throttle) reasons, and the compute processes on the card."""
    fields = ["clocks.sm", "clocks.max.sm", "clocks.mem", "power.draw", "power.limit",
              "temperature.gpu"]
    state = None
    for reasons in ("clocks_event_reasons.active", "clocks_throttle_reasons.active", None):
        state = _smi("--query-gpu=" + ",".join(fields + ([reasons] if reasons else [])))
        if state is not None:
            break
    if state is None:
        return "nvidia-smi read nothing"
    vals = [v.strip() for v in state.splitlines()[0].split(",")]
    line = (f"SM {vals[0]} of {vals[1]}, memory {vals[2]}, {vals[3]} of {vals[4]}, "
            f"{vals[5]} C, clock event reasons "
            f"{vals[6] if len(vals) > 6 else 'not read'}")
    apps = _smi("--query-compute-apps=pid,used_memory")
    apps = [a for a in (apps or "").splitlines() if a.strip()]
    return f"{line}; compute processes {len(apps)}: {'; '.join(apps) or 'none listed'}"


def digest(t: torch.Tensor) -> int:
    """A position-weighted sum of a tensor's bits: two tensors that are bit
    for bit equal give the same number."""
    v = t.reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
    total = 0
    for c in range(0, v.numel(), 1 << 24):
        part = v[c:c + (1 << 24)].to(torch.int64)
        w = torch.arange(c, c + part.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
        total += int((part * w).sum())
    return total


def gemm_times(dev) -> dict:
    """wd_gemm alone on seeded operands at GEMM_ROWS rows on each of GEMM_SHAPES,
    through ``wide.gemm``: ms (median of ROUNDS means of REPS), TFLOP/s, the
    bound (operations at the bf16 peak, or each input read and each output
    written once at the HBM rate), the outputs' digests; the plain
    version's ms (the same product and epilogue in PyTorch on row-major
    operands: bf16 values, fp32 sums); and torch.addmm's ms on bf16
    row-major operands of the same shape (bias added, no epilogue beyond),
    the yardstick."""
    from adanerf_tpu_torch.ops.kernels import wide
    out, rows = {}, GEMM_ROWS
    for name, (K, n, epi) in GEMM_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(K + n)
        bf = dict(dtype=torch.bfloat16, device=dev)
        a = torch.randn(rows * K, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(K * n, generator=gen, device=dev) / K ** 0.5).to(torch.bfloat16)
        bias = torch.randn(n, generator=gen, device=dev)
        o = torch.empty(rows * n, **bf)
        kw = dict(bias=bias, relu=True, out=o)
        nbytes = (rows * K + K * n + rows * n) * 2 + n * 4
        if epi == "backward":
            mask = torch.relu(torch.randn(rows * n, generator=gen, device=dev)).to(torch.bfloat16)
            st = torch.empty(rows * n, **bf)
            bp = torch.empty((rows // 128) * n, dtype=torch.float32, device=dev)
            kw = dict(mask=mask, bp=bp, ldbp=n, out=o, st=st)
            nbytes += 2 * rows * n * 2 + (rows // 128) * n * 4 - n * 4

        def run():
            wide.gemm(dev, a, K // 64, w, n, rows, **kw)
        run()
        torch.cuda.synchronize()
        digests = {k: digest(v) for k, v in kw.items() if k in ("out", "st", "bp")}
        ms = float(np.median([time_ms(run, REPS) for _ in range(ROUNDS)]))
        del a, w
        ar = torch.randn((rows, K), generator=gen, device=dev).to(torch.bfloat16)
        wr = (torch.randn((K, n), generator=gen, device=dev) / K ** 0.5).to(torch.bfloat16)
        br = bias.to(torch.bfloat16)
        lib = float(np.median([time_ms(lambda: torch.addmm(br, ar, wr), REPS)
                               for _ in range(ROUNDS)]))
        a32, w32 = ar.float(), wr.float()
        if epi == "backward":
            keep = (torch.randn((rows, n), generator=gen, device=dev) > 0).float()

            def plain():  # the masked cotangent, its column sums a 128-row tile, bf16
                z = (a32 @ w32) * keep
                return z.view(-1, 128, n).sum(1), z.to(torch.bfloat16)
        else:
            def plain():
                return torch.relu(torch.addmm(bias, a32, w32)).to(torch.bfloat16)
        plain_ms = time_ms(plain, 2)
        del a32, w32
        ops = 2.0 * rows * K * n
        bo, bb = ops / PEAK_BF16 * 1e3, nbytes / HBM_BPS * 1e3
        out[name] = {"rows": rows, "K": K, "n": n, "epilogue": epi, "ms": ms,
                     "tflops": ops / ms / 1e9, "plain_ms": plain_ms, "bound_ms": max(bo, bb),
                     "bound_by": "operations" if bo >= bb else "bytes", "library_ms": lib,
                     "library_tflops": ops / lib / 1e9, "digests": digests}
        print(f"wd_gemm {name} ({rows} x {K} -> {n}, {epi} epilogue): {ms:.3f} ms, "
              f"{ops / ms / 1e9:.1f} TFLOP/s, bound {max(bo, bb):.3f} ms; plain {plain_ms:.3f} ms; "
              f"torch.addmm {lib:.3f} ms "
              f"({ops / lib / 1e9:.1f} TFLOP/s); digests {digests}", flush=True)
        del ar, wr, kw, o
        torch.cuda.empty_cache()
    return out


def seeded_export(dst: str, width, seed: int, **kw) -> str:
    """tests/torch_wide_export.py's seeded export (of this file's checkout)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_wide_export import write_wide_export
    return write_wide_export(dst, width, seed, **kw)


def at_cap(text: str) -> str:
    """An export's config at S=16 with every slot live (threshold 1e-4: a
    seeded oracle's logits lie around 0)."""
    return text.replace("numRaymarchSamples = [8, 8]", "numRaymarchSamples = [16, 16]") \
        .replace("adaptiveSamplingThreshold = 0.2", "adaptiveSamplingThreshold = 0.0001")


def render_times(dev, export: str, kinds, size: int = 800) -> dict:
    """frame_ms of each of ``kinds`` ({name: wrapper class or a callable
    taking the renderer}) on an export at size x size, bf16."""
    from adanerf_tpu_torch import viewer
    rt, scene = viewer.build_renderer_from_export(export, dtype_str="bf16", device=dev)
    pose = viewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 8)[1]
    rot = np.eye(3, dtype=np.float32)
    dirs = viewer.frame_directions(scene, size, size, dev)
    out = {}
    for name, make in kinds.items():
        k = make(rt)
        _, counts = k(dirs, pose, rot)
        rec = dict(frame_ms(k, dirs, pose, rot), samples_per_px=float(counts.float().mean()))
        rec["route"] = ("front " + ("wide" if k.front_wide else "fused") + ", shade " +
                        ("wide" if k.shade_wide else "fused"))
        out[name] = rec
        print(f"{name}: {rec['ms']:.3f} ms/frame (front {rec['front_ms']:.3f}, front+shade "
              f"{rec['front_shade_ms']:.3f}), samples/px {rec['samples_per_px']:.4f}; "
              f"{rec['route']}", flush=True)
        del k
        torch.cuda.empty_cache()
    return out


def k3_alone_times(dev, width: int, rows: int = K3_ROWS) -> dict:
    """K3's forward and backward (ms) on a seeded 8 x width NeRF at rows
    rows, through the autograd function the train step calls."""
    from adanerf_tpu_torch.models.mlp import NeRFDef
    from adanerf_tpu_torch.ops.kernels.nerf_train import NerfTrainKernel
    nerf = NeRFDef(8, width, 63, 27, 4, (4,))
    nerf.reset_parameters(torch.Generator().manual_seed(width))
    nerf = nerf.to(dev)
    k3 = NerfTrainKernel(nerf)
    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.uniform(-1, 1, (rows, 90)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((rows, 4)).astype(np.float32)).to(dev) / (4 * rows)
    leaves = list(nerf.parameters())
    xr = x.clone().requires_grad_(True)
    y = k3(xr)
    fwd, bwd = [], []
    for _ in range(ROUNDS):
        with torch.no_grad():
            fwd.append(time_ms(lambda: k3(x), REPS))
        bwd.append(time_ms(lambda: torch.autograd.grad(y, [xr] + leaves, g, retain_graph=True),
                           REPS))
    rec = {"rows": rows, "route": "wide" if k3.wide else "fused",
           "forward_ms": float(np.median(fwd)), "backward_ms": float(np.median(bwd))}
    print(f"K3 at {width}, {rows} rows ({rec['route']}): forward {rec['forward_ms']:.3f} ms, "
          f"backward {rec['backward_ms']:.3f} ms", flush=True)
    del y, xr, x, g, k3, nerf
    torch.cuda.empty_cache()
    return rec


def k3_times(dev, export: str) -> dict:
    """K3's forward, backward and dense step times (ms), through the
    entry points the train step uses."""
    import tempfile
    from adanerf_tpu_torch import train
    from adanerf_tpu_torch.models.mlp import NeRFDef
    from adanerf_tpu_torch.ops.kernels.nerf_train import NerfTrainKernel
    from adanerf_tpu_torch.utils.weights import load_export_weights
    nerf = load_export_weights(NeRFDef(), os.path.join(export, "model1.weights")).to(dev)
    k3 = NerfTrainKernel(nerf)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (K3_ROWS, 90)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((K3_ROWS, 4)).astype(np.float32)).to(dev) / (4 * K3_ROWS)
    leaves = list(nerf.parameters())
    xr = x.clone().requires_grad_(True)
    out = k3(xr)
    fwd, bwd = [], []
    for _ in range(ROUNDS):
        with torch.no_grad():
            fwd.append(time_ms(lambda: k3(x), REPS))
        bwd.append(time_ms(lambda: torch.autograd.grad(out, [xr] + leaves, g, retain_graph=True),
                           REPS))
    del out, xr, x, g
    torch.cuda.empty_cache()
    steps = K3_WARMUP + K3_STEPS
    with tempfile.TemporaryDirectory(prefix="frame_times_logs_") as log_dir:
        stats = train.main([
            "-c", os.path.join(HERE, "configs", "dense_training.ini"),
            "-data", os.path.join(HERE, "demo", "mscene"), "-log", log_dir, "--bf16",
            "--epochs", str(1 + steps), "--randomSeed", "0",
            # one value per network (an append option): neither is locked
            "--epochsLockWeightsBefore", "-1", "--epochsLockWeightsBefore", "-1",
            "--epochsRender", "1000000", "--epochsValidate", "1000000",
            "--epochsCheckpoint", "1000000", "--no-performEvaluation", "--verboseEvery", "1000"])
    step_ms = [float(v) for v in stats["step_ms"][K3_WARMUP:]]
    return {"rows": K3_ROWS, "forward_ms": float(np.median(fwd)), "backward_ms": float(np.median(bwd)),
            "forward_rounds": fwd, "backward_rounds": bwd, "step_ms_mean": float(np.mean(step_ms)),
            "step_ms_median": float(np.median(step_ms)), "steps": step_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose adanerf_tpu_torch to time")
    ap.add_argument("--only", choices=("frames", "k3", "gemm", "wide", "sparse"),
                    help="time only these kernels (frames and k3 by default)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # import the port from `root`
    if not torch.cuda.is_available():
        print("frame_times: no CUDA device", file=sys.stderr)
        return 2
    from adanerf_tpu_torch import viewer
    from adanerf_tpu_torch.ops.kernels.megakernel_compact import MegakernelCompact
    from adanerf_tpu_torch.ops.kernels.megakernel_dense import MegakernelDense

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{card}; port from {root}", flush=True)
    print(f"card before: {card_state()}", flush=True)
    dev = torch.device("cuda")
    export = os.path.join(HERE, "demo", "trained_mscene_export")
    rt, scene = viewer.build_renderer_from_export(export, dtype_str="bf16", device=dev)
    pose = viewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 8)[1]
    rot = np.eye(3, dtype=np.float32)
    dirs = viewer.frame_directions(scene, 800, 800, dev)
    out = {"card": card, "root": root, "rounds": ROUNDS, "reps": REPS, "times": {}}
    if args.only in ("gemm", "wide", "sparse"):
        import tempfile
        if args.only == "gemm":
            out["gemm"] = gemm_times(dev)
        with tempfile.TemporaryDirectory(prefix="frame_times_exports_") as tmp:
            if args.only == "wide":
                for w in WIDE_WIDTHS:
                    exp = seeded_export(os.path.join(tmp, str(w)), w, 11, depth=(8, 8),
                                        config_edit=at_cap)
                    out["times"][str(w)] = render_times(dev, exp, {
                        f"K1 {w}": MegakernelCompact, f"K2 {w}": MegakernelDense})
                    out["times"][f"K3 {w}"] = k3_alone_times(dev, w)
            if args.only == "sparse":
                exp = seeded_export(os.path.join(tmp, "640"), 640, 11, depth=(8, 8))
                kinds = {"K1 640": MegakernelCompact}
                if hasattr(MegakernelCompact, "_live_rows"):
                    class EveryChunk(MegakernelCompact):
                        def _live_rows(self, counter, total):
                            return total
                    kinds["K1 640 every chunk"] = EveryChunk
                out["times"].update(render_times(dev, exp, kinds))
        print(f"card after: {card_state()}", flush=True)
        print(json.dumps(out), flush=True)
        return 0
    for thr in (rt.threshold, 0.01, 1e-4) if args.only != "k3" else ():
        rt.threshold = thr
        for name, cls in (("K1", MegakernelCompact), ("K2", MegakernelDense)):
            k = cls(rt)
            _, counts = k(dirs, pose, rot)
            rec = dict(frame_ms(k, dirs, pose, rot), samples_per_px=float(counts.float().mean()))
            out["times"][f"{name} {thr}"] = rec
            print(f"{name} threshold {thr}: {rec['ms']:.3f} ms/frame (front {rec['front_ms']:.3f}, "
                  f"front+shade {rec['front_shade_ms']:.3f}), samples/px "
                  f"{rec['samples_per_px']:.4f}", flush=True)
    if args.only != "frames":
        out["k3"] = k3_times(dev, export)
        k = out["k3"]
        print(f"K3 at {k['rows']} rows: forward {k['forward_ms']:.3f} ms, backward "
              f"{k['backward_ms']:.3f} ms; dense step {k['step_ms_mean']:.3f} ms (mean of "
              f"{len(k['steps'])}, median {k['step_ms_median']:.3f})", flush=True)
    print(f"card after: {card_state()}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
