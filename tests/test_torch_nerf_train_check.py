"""The check that holds K3 against its plain version on the card
(ops/kernels/nerf_train_check.py), run here against a stand-in for the
kernel: the plain version itself, whose bf16 layer outputs fill the
scratch that the check reads. The stand-in agrees with every bar; a
stand-in with one wrong element in one layer, one wrong forward row or one
wrong dX row is caught."""

import numpy as np
import pytest
import torch

from adanerf_tpu_torch.models.mlp import NeRFDef
from adanerf_tpu_torch.ops.kernels import nerf_train_check as check

ROWS = 96


class PlainStandIn:
    """The kernel's interface as the check uses it, computed by the plain
    version; ``corrupt`` changes what it reports: ("layer", i) one element
    of layer i's stored output, ("forward", row) one output row, ("dx",
    row) one row of dX."""

    forward_launches = backward_launches = 0

    def __init__(self, nerf, corrupt=None):
        self.nerf, self.corrupt = nerf, corrupt
        self.n_in = nerf.input_ch + nerf.input_ch_views

    def plain(self, x):
        return self.nerf(x, dtype=torch.bfloat16)

    def __call__(self, x):
        out = self.plain(x)
        if self.corrupt and self.corrupt[0] == "forward":
            bump = torch.zeros_like(out)
            bump[self.corrupt[1]] = 0.5
            out = out + bump
        if self.corrupt and self.corrupt[0] == "dx":
            out = _DxBump.apply(out, x, self.corrupt[1])
        return out

    def pack(self, named, device):
        return None

    def new_scratch(self, N, device):
        return {}

    def backward_kernel(self, x, g, packed, scratch):
        hooked = list(self.nerf.pts) + [self.nerf.feature] + list(self.nerf.views)
        names = [f"h.{i}" for i in range(self.nerf.depth)] + ["feat", "hv"]
        order = iter(names)

        def keep(m, a, z):
            name = next(order)
            o = z if name == "feat" else torch.relu(z)
            scratch[name] = o.detach().to(torch.bfloat16)
        hooks = [m.register_forward_hook(keep) for m in hooked]
        xr = x.clone().requires_grad_(True)
        out = self(xr)
        for h in hooks:
            h.remove()
        leaves = [p for _, p in self.nerf.named_parameters()]
        grads = torch.autograd.grad(out, [xr] + leaves, g)
        if self.corrupt and self.corrupt[0] == "layer":
            h = scratch[f"h.{self.corrupt[1]}"]
            h[5, 7] = h[5, 7] * 2 + 1
        names = [n for n, _ in self.nerf.named_parameters()]
        return grads[0], dict(zip(names, grads[1:]))

    def scratch_matrix(self, scratch, N, name):
        return scratch[name]

    def relu_outputs(self, scratch, N):
        return [scratch[f"h.{i}"] for i in range(self.nerf.depth)] + [scratch["hv"]]


class _DxBump(torch.autograd.Function):
    """Identity forward; adds 1 to one row of dX in the backward."""

    @staticmethod
    def forward(ctx, out, x, row):
        ctx.row = row
        return out.clone()

    @staticmethod
    def backward(ctx, g):
        dx = torch.zeros((g.shape[0], 90), dtype=g.dtype)
        dx[ctx.row] = 1.0
        return g, dx, None


def _run(corrupt=None):
    nerf = NeRFDef(4, 32, 63, 27, 4, (1,))
    nerf.reset_parameters(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (ROWS, 90)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((ROWS, 4)).astype(np.float32))
    res = check.compare(
        PlainStandIn(nerf, corrupt), x,
        lambda out: torch.autograd.grad(torch.mean((out - t) ** 2), out, retain_graph=True)[0])
    return res, check.verdict(res)


def test_the_plain_version_passes_every_bar():
    res, (ok, lines) = _run()
    assert ok, lines
    assert res["layer_faults"] == 0 and res["deterministic"]
    assert not bool(res["differ"].any()) and not bool(res["flips"].any())
    assert torch.equal(res["out"]["k"], res["out"]["p"])
    assert torch.equal(res["out"]["k"], res["out"]["f"])


@pytest.mark.parametrize("corrupt", [("layer", 0), ("layer", 2), ("forward", 11), ("dx", 17)])
def test_one_wrong_row_is_caught(corrupt):
    res, (ok, lines) = _run(corrupt)
    assert not ok, lines
    if corrupt[0] == "layer":
        assert res["layer_faults"] >= 1
