"""K3 (``nerf_train.NerfTrainKernel``) held against its plain version on one
input, on the card: the comparison that ``chip_smoke.py`` (phase 8) and
``tests/test_torch_kernels_cuda.py`` both make.

Both sides round the same values to bf16 and sum in fp32, but each sums a
layer's products in its own order (the kernel on the tensor cores, the
plain version in fp32 GEMMs). So a sum that lies within rounding of a bf16
boundary may round the other way on one side, and a pre-activation within
rounding of 0 may take the other relu sign; such a flip moves the rest of
its row on either side. Against float64 sums of the same bf16 roundings
the plain version is as far off as the kernel (``compare`` prints both).
The check therefore has three parts, each on every row:

* every bf16 output of the kernel's recomputed forward (trunk, feature,
  views) is relu(z) rounded to bf16, z the float64 sum of the layer's own
  bf16 inputs, within one bf16 step plus the error bound of an fp32 sum,
  and its relu sign is z's wherever |z| exceeds that bound;
* the plain version run with the kernel's bf16 layer outputs forced in
  (relu signs included) is held to the kernel at the plain bars: the
  forward within ``FWD_BAR`` of the output scale, every parameter leaf and
  every dX element within ``GRAD_BAR`` of the max |ref|. This holds the
  forward kernel's heads and the whole backward;
* the kernel against the plain version itself: the forward within
  ``FWD_BAR`` on the rows where every layer's bf16 output agrees, and
  within ``FWD_DIFFER_BAR`` on the others, which may be at most
  ``DIFFER_SHARE`` of the rows; every parameter leaf within ``GRAD_BAR``;
  dX within ``GRAD_BAR`` of max |dX| except in the rows where the relu
  signs differ, at most ``FLIP_SHARE`` of the rows and held within
  ``DX_FLIP_BAR`` there (or, where the caller gives one, an absolute bar
  on every dX element).

The looser bars for the rows that flip were set from readings on an
NVIDIA H100 at 130 to 524,288 rows (PERF.md §6): forward on rows whose bf16
outputs differ 1.1e-3 to 5.7e-3 of the output scale in 10.7% to 19.2% of
the rows (the plain version alone is 1.1e-3 to 5.7e-3 from float64 sums of
the same roundings); dX in rows whose relu signs differ up to 9.1e-2 of
max |dX|, in 0.19% to 0.96% of the rows. Those readings are of the 8x256
NeRF, and the caps hold from 128 to 256. A wider NeRF gives each row
more units whose bf16 rounding or relu sign can differ, and a difference
in an early layer carries into every later one: on the same card at 384
and 512 columns, 4,096 rows, 25% to 38% of the rows differed and 4.6% to
8.5% flipped, with dX in flipped rows up to 2.2e-1 of max |dX| (PERF.md
§6), while the kernel's layers stayed within their float64 bound and the
plain version with the kernel's bf16 outputs stayed within the plain
bars on every row. ``WIDE_CAPS`` are the caps above 256 up to 512.
``BIG_CAPS`` are those of a NeRF wider than 512 or deeper than the 8
layers the other caps were read at: such a row has more units again, and
a flip in a deep trunk carries through more layers into the leaves of the
early ones. On an NVIDIA H100 (the card tests at the new shapes,
tests/test_torch_kernels_cuda.py, PR 15), at 4,096 rows, 49% / 62% / 82%
of the rows differed at 640 / 768 / 1,024 columns (85% at 1,024 and 130
rows; 50.03% at 640 and 40,000 rows) and 10.7% / 15.7% / 28.8% flipped
(26% at 130 rows), dX in flipped rows within 1.03e-1 of max |dX|; an
unforced leaf 1.7e-2 / 2.3e-2 / 2.8e-2 of its max (4.9e-2 at 1,024 and 130
rows), and 4.8e-2 at 20 x 256 (6.2% of the rows flipped); through it all
every layer of the kernel stayed within its float64 bound, and the plain
version with the kernel's bf16 outputs forced in within 6.5e-3 to 1.1e-2
of every leaf and of dX, inside ``GRAD_BAR``. At 20 x 256 and 524,288
rows (chip_smoke.py phase 20, PR 15) a differing row's output lay up to
1.809e-2 from the plain version's, each side that far from float64 sums
of the same roundings (the kernel 1.809e-2, the plain version 1.448e-2):
twenty layers of bf16 roundings, the forced comparison 2.4e-7. So above
512 columns or 8 layers a differing row is not capped in number and held
within ``BIG_DIFFER_BAR``, at most 40% of the rows may flip, and an
unforced leaf is held within ``BIG_LEAF_BAR``; the bars on agreeing rows,
and the forced comparison on every leaf, are the same at every shape.
"""

from typing import Callable, Dict, List, Optional, Tuple

import torch

U = 2.0 ** -24  # unit roundoff of fp32
FWD_BAR = 4e-3  # forward, of the output scale: the TPU kernel's own bar
GRAD_BAR = 2e-2  # a leaf's max abs error, of its max |ref|: the TPU kernel's own bar
FWD_DIFFER_BAR = 1e-2  # forward on rows where some layer's bf16 output differs
DIFFER_SHARE = 0.25  # the most such rows, as a share of all rows
DX_FLIP_BAR = 2e-1  # dX, of max |dX|, in rows whose relu signs differ
FLIP_SHARE = 0.02  # the most such rows, as a share of all rows
REPORT_LINES = 40  # relu sign differences listed in the report
# (DIFFER_SHARE, FLIP_SHARE, DX_FLIP_BAR) for a NeRF of 384 or 512 columns
WIDE_CAPS = (0.5, 0.12, 0.4)
# the same, the forward bar on differing rows and the bar of a leaf against
# the plain version's, for a NeRF wider than 512 or deeper than 8 layers
BIG_CAPS = (1.0, 0.4, 0.4)
BIG_DIFFER_BAR = 4e-2
BIG_LEAF_BAR = 0.1


def caps(width: int, depth: int = 8) -> Tuple[float, float, float, float, float]:
    """(the forward bar on rows whose bf16 layer outputs differ, the share
    of such rows, the share of rows whose relu signs differ, the dX bar in
    those rows, the bar of a leaf against the plain version's) at a NeRF
    width and depth."""
    if width > 512 or depth > 8:
        return (BIG_DIFFER_BAR,) + BIG_CAPS + (BIG_LEAF_BAR,)
    shares = WIDE_CAPS if width > 256 else (DIFFER_SHARE, FLIP_SHARE, DX_FLIP_BAR)
    return (FWD_DIFFER_BAR,) + shares + (GRAD_BAR,)


def gamma(n: int) -> float:
    """Bound on the relative error of an n-term fp32 sum (Higham's gamma_n)."""
    return n * U / (1 - n * U)


def _f64(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bf16 rounding, in float64."""
    return t.detach().to(torch.bfloat16).to(torch.float64)


def compare(k3, x: torch.Tensor, cot: Callable[[torch.Tensor], torch.Tensor]) -> Dict:
    """K3 and its plain version on x (N, n_in), each differentiated through
    cot(out), the cotangent of its output; then the kernel's backward once
    more on the kernel side's cotangent with a scratch, whose bf16 layer
    outputs are checked layer by layer and forced into a third run of the
    plain version. Returns a dict: ``out`` and ``grads`` ({"x": dX, leaf:
    grad}) for the sides k (kernel), p (plain) and f (plain with the
    kernel's bf16 layer outputs); ``launched`` (forward, backward) by the
    kernel side; ``deterministic`` (the second backward equals the first
    bit for bit); ``layer_faults`` (elements outside the layer check);
    ``flips`` and ``differ``, the rows where the relu signs and where any
    bf16 layer output differ between k and p; ``report`` lines."""
    nerf, N = k3.nerf, x.shape[0]
    names = [n for n, _ in nerf.named_parameters()]
    leaves = [p for _, p in nerf.named_parameters()]
    hooked = list(nerf.pts) + [nerf.feature] + list(nerf.views)  # call order
    relu = [True] * len(nerf.pts) + [False] + [True] * len(nerf.views)

    def run(fn, hook=None):
        hooks = [m.register_forward_hook(hook) for m in hooked] if hook else []
        xr = x.clone().requires_grad_(True)
        out = fn(xr)
        for h in hooks:
            h.remove()
        g = cot(out)
        grads = torch.autograd.grad(out, [xr] + leaves, g)
        return out.detach(), g.detach(), dict(zip(["x"] + names, grads))

    res = {"out": {}, "grads": {}, "report": [], "width": nerf.width, "depth": nerf.depth}
    f0, b0 = type(k3).forward_launches, type(k3).backward_launches
    res["out"]["k"], g_k, res["grads"]["k"] = run(k3)
    res["launched"] = (type(k3).forward_launches - f0, type(k3).backward_launches - b0)
    pre = []  # the plain version's layer outputs before any relu, in call order
    res["out"]["p"], _, res["grads"]["p"] = run(k3.plain, lambda m, a, z: pre.append(z.detach()))

    scratch = k3.new_scratch(N, x.device)
    dx, again = k3.backward_kernel(x, g_k, k3.pack(dict(nerf.named_parameters()), x.device),
                                   scratch)
    gk = res["grads"]["k"]
    res["deterministic"] = torch.equal(dx, gk["x"]) and all(
        torch.equal(again[n], gk[n]) for n in names)
    del dx, again
    relu_k = k3.relu_outputs(scratch, N)
    outs_k = relu_k[:-1] + [k3.scratch_matrix(scratch, N, "feat"), relu_k[-1]]

    # each layer's inputs, the kernel's own: x's bf16 rounding and the
    # previous layer's bf16 output
    ic, n_in = nerf.input_ch, k3.n_in
    xb = _f64(x)
    inputs = []
    for i in range(len(nerf.pts)):
        if i == 0:
            inputs.append(lambda: xb[:, :ic])
        elif (i - 1) in nerf.skips:
            inputs.append(lambda i=i: torch.cat([xb[:, :ic], outs_k[i - 1].double()], 1))
        else:
            inputs.append(lambda i=i: outs_k[i - 1].double())
    inputs.append(lambda: outs_k[len(nerf.pts) - 1].double())
    inputs.append(lambda: torch.cat([outs_k[-2].double(), xb[:, ic:n_in]], 1))
    layer_names = [f"pts.{i}" for i in range(len(nerf.pts))] + ["feature", "views.0"]

    flips = torch.zeros(N, dtype=torch.bool, device=x.device)
    differ = flips.clone()
    faults, n_round, n_flip = 0, 0, 0
    for name, a_of, layer, o_k, z_p, r in zip(layer_names, inputs, hooked, outs_k, pre, relu):
        a = a_of()
        w, b = _f64(layer.w), layer.b.detach().double()
        z = a @ w + b
        bound = gamma(a.shape[1] + 1) * (a.abs() @ w.abs() + b.abs())
        del a, w
        h = o_k.double()
        ref = z.clamp(min=0) if r else z
        bad = (h - ref).abs() > 2.0 ** -8 * ref.abs() + bound
        if r:
            bad |= ((h > 0) != (z > 0)) & (z.abs() > bound)
            sign = (h > 0) != (z_p > 0)
            flips |= sign.any(1)
            n_flip += int(sign.sum())
            for row, c in sign.nonzero()[:REPORT_LINES - len(res["report"])].tolist():
                res["report"].append(
                    f"row {row}: {name} unit {c}: pre-activation {float(z[row, c]):.3e} "
                    f"(float64 of the kernel's inputs), {float(z_p[row, c]):.3e} (plain), "
                    f"fp32 bound {float(bound[row, c]):.3e}")
        faults += int(bad.sum())
        d = o_k != (torch.relu(z_p) if r else z_p).to(torch.bfloat16)
        differ |= d.any(1)
        n_round += int(d.sum())
        del z, bound, h, ref, bad, d
    differ |= flips
    res.update(layer_faults=faults, flips=flips, differ=differ)
    res["report"].append(
        f"relu sign differences: {n_flip} units in {int(flips.sum())} rows (listed: the first "
        f"{min(n_flip, REPORT_LINES)}); bf16 layer outputs that differ between the two sides: "
        f"{n_round} elements in {int(differ.sum())} rows; elements of the kernel's layers "
        f"outside their float64 bound: {faults}")

    # both sides' distance to float64 sums of the same bf16 roundings
    h = xb[:, :ic]
    for i, layer in enumerate(nerf.pts):
        h = _f64(torch.relu(h @ _f64(layer.w) + layer.b.detach().double()))
        if i in nerf.skips:
            h = torch.cat([xb[:, :ic], h], 1)
    alpha = h @ _f64(nerf.alpha.w) + nerf.alpha.b.detach().double()
    feat = _f64(h @ _f64(nerf.feature.w) + nerf.feature.b.detach().double())
    hv = _f64(torch.relu(torch.cat([feat, xb[:, ic:n_in]], 1) @ _f64(nerf.views[0].w)
                         + nerf.views[0].b.detach().double()))
    out64 = torch.cat([hv @ _f64(nerf.rgb.w) + nerf.rgb.b.detach().double(), alpha], 1)
    res["report"].append(
        f"forward max abs distance to float64 sums of the same bf16 roundings: kernel "
        f"{float((res['out']['k'] - out64).abs().max()):.3e}, plain "
        f"{float((res['out']['p'] - out64).abs().max()):.3e}")
    del xb, h, alpha, feat, hv, out64

    targets = iter(zip(outs_k, relu))

    def force(m, a, z):  # the layer's output becomes the kernel's bf16 value
        o_k, r = next(targets)
        o_k = o_k.float()
        t = torch.where(o_k > 0, o_k, -z.abs()) if r else o_k
        return z + (t - z).detach()
    res["out"]["f"], _, res["grads"]["f"] = run(k3.plain, force)
    del scratch, relu_k, outs_k, pre
    return res


def _leaf_errors(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]
                 ) -> Dict[str, Tuple[float, float]]:
    """{name: (max |ref - got| / max |ref|, max |ref - got|)}."""
    out = {}
    for k, a in ref.items():
        diff = float((a - got[k]).abs().max())
        out[k] = (diff / (float(a.abs().max()) + 1e-12), diff)
    return out


def verdict(res: Dict, scale: float = 1.0, dx_abs: Optional[float] = None
            ) -> Tuple[bool, List[str]]:
    """(ok, report lines): ``compare``'s result against the bars. scale:
    what the forward's errors are divided by (1 for O(1) outputs, max |out|
    where they are large); dx_abs: an absolute bar on every dX element in
    place of the relative one with its relu-sign rows."""
    out, grads = res["out"], res["grads"]
    N = out["k"].shape[0]
    differ_bar, differ_share, flip_share, dx_flip_bar, leaf_bar = caps(res.get("width", 256),
                                                                       res.get("depth", 8))
    flips, differ = res["flips"], res["differ"]
    row_err = (out["k"] - out["p"]).abs().max(1).values / scale
    agree = ~differ
    fwd_agree = float(row_err[agree].max()) if bool(agree.any()) else 0.0
    fwd_differ = float(row_err[differ].max()) if bool(differ.any()) else 0.0
    fwd_f = float((out["k"] - out["f"]).abs().max()) / scale
    errs = _leaf_errors(grads["p"], grads["k"])
    errs_f = _leaf_errors(grads["f"], grads["k"])
    worst = max((v[0], k) for k, v in errs.items() if k != "x")
    worst_f = max((v[0], k) for k, v in errs_f.items())  # dX included
    dx_p, dx_k = grads["p"]["x"], grads["k"]["x"]
    dx_rel = (dx_k - dx_p).abs() / float(dx_p.abs().max())
    bad_rows = (dx_rel > GRAD_BAR).any(1)
    unexplained = int((bad_rows & ~flips).sum())
    lines = [
        f"forward, of the output scale {scale:.4g}: {fwd_agree:.3e} on the {int(agree.sum())} "
        f"rows whose bf16 layer outputs agree (allowed {FWD_BAR}), {fwd_differ:.3e} on the "
        f"{int(differ.sum())} others ({100 * float(differ.float().mean()):.2f}% of {N}; allowed "
        f"{differ_bar} in at most {100 * differ_share:.0f}%); with the kernel's bf16 layer "
        f"outputs {fwd_f:.3e} on every row (allowed {FWD_BAR})",
        f"grads: worst parameter leaf {worst[1]} {worst[0]:.3e} of its max (allowed {leaf_bar}); "
        f"with the kernel's bf16 layer outputs worst leaf {worst_f[1]} {worst_f[0]:.3e}, dX "
        f"included (allowed {GRAD_BAR})"]
    ok = (res["layer_faults"] == 0 and res["deterministic"] and fwd_agree <= FWD_BAR
          and fwd_differ <= differ_bar and float(differ.float().mean()) <= differ_share
          and fwd_f <= FWD_BAR and worst[0] <= leaf_bar and worst_f[0] <= GRAD_BAR)
    if dx_abs is not None:
        lines.append(f"dX max abs err {errs['x'][1]:.3e} on every element (allowed {dx_abs}), "
                     f"max |dX| {float(dx_p.abs().max()):.3e}")
        ok = ok and errs["x"][1] <= dx_abs
    else:
        lines.append(
            f"dX of max |dX| {float(dx_p.abs().max()):.3e}: {float(dx_rel.max()):.3e}; beyond "
            f"{GRAD_BAR}: {int((dx_rel > GRAD_BAR).sum())} elements in {int(bad_rows.sum())} rows, "
            f"{unexplained} of them without a relu sign difference (allowed 0); rows with relu "
            f"sign differences {int(flips.sum())} ({100 * float(flips.float().mean()):.2f}%; "
            f"allowed {100 * flip_share:.0f}%, dX there within {dx_flip_bar})")
        ok = ok and unexplained == 0 and float(flips.float().mean()) <= flip_share \
            and float(dx_rel.max()) <= dx_flip_bar
    lines.append(f"kernel layers within their float64 bound on every element: "
                 f"{res['layer_faults'] == 0}; a second backward bit for bit equal: "
                 f"{res['deterministic']}")
    return ok, lines
