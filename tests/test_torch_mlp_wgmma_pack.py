"""The bf16 weight stream of K1 and K2 (ops/kernels/megakernel_compact.py).

For bf16 the packer writes each MLP as one stream of weight chunks, in the
order the tensor-core kernels walk them (stream_plan, the mirror of
csrc/megakernel.cuh::tc_plan) and in the swizzled byte layout of their
shared-memory stages (swizzle128, the mirror of csrc/mlp_wgmma.cuh::sw128),
so each chunk arrives by one linear bulk copy. The kernels run only on the
card; these tests hold the layout they read here: walking the stream by the
plan un-tiles every matrix of both MLPs bit for bit, with zero padding; the
swizzle is a bijection on each chunk; every chunk sits where the bulk copy
and the swizzle need it."""

import os

import numpy as np
import pytest
import torch

from adanerf_tpu_torch import viewer as tviewer
from adanerf_tpu_torch.ops.kernels import megakernel_compact as mc
from torch_wide_export import write_wide_export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORTS = {"mscene": os.path.join(ROOT, "demo", "trained_mscene_export"),
           "ndc": os.path.join(ROOT, "demo", "trained_ndc_export")}
STAGE_BYTES = 256 * mc.TC_KC * 2  # csrc/mlp_wgmma.cuh TC_STAGE_BYTES


def _packed(name, dtype="bf16"):
    rt, _ = tviewer.build_renderer_from_export(EXPORTS[name], dtype_str=dtype, device="cpu")
    return rt, mc.MegakernelCompact(rt)


def _bits(a):
    """bf16 bit patterns (int16) of a float array, rounded as the packer's
    ``.to(torch.bfloat16)`` rounds."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16) \
        .view(torch.int16).numpy()


def _pad(a, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _expected_layers(rt, P):
    """Per layer of the front's and the shade's plans, the matrices of its
    two inputs (None where the layer has no second input), padded as the
    kernel reads them."""
    ow, nw = mc._numpy_state(rt.oracle), mc._numpy_state(rt.nerf)
    in_ch, in_views, W = rt.nerf.input_ch, rt.nerf.input_ch_views, rt.nerf.width
    front = []
    for i in range(rt.oracle.depth):
        w = ow[f"{i}.w"]
        rows = P.in0 if i == 0 else w.shape[0]
        front.append((_pad(w, rows, 128 if i == rt.oracle.depth - 1 else W), None))
    shade = [(_pad(nw["pts.0.w"], P.in1, W), None)]
    for i in range(1, rt.nerf.depth):
        w = nw[f"pts.{i}.w"]
        if (i - 1) in rt.nerf.skips:
            shade.append((w[in_ch:], _pad(w[:in_ch], P.in1, W)))
        else:
            shade.append((w, None))
    shade.append((nw["feature.w"], None))
    wv = nw["views.0.w"]
    wvd = np.zeros((P.in1, W // 2), np.float32)
    wvd[in_ch:in_ch + in_views] = wv[W:]
    shade.append((wv[:W], wvd))
    return front, shade


@pytest.mark.parametrize("name", ["mscene", "ndc"])
def test_bf16_stream_untiles_to_every_matrix(name):
    rt, mk = _packed(name)
    P, L = mk.params, mk.layers
    assert mk.weights.dtype == torch.bfloat16
    assert (P.in0, P.in1) == ({"mscene": 128, "ndc": 64}[name], 128)
    flat = mk.weights.view(torch.int16).numpy()
    want_front, want_shade = _expected_layers(rt, P)
    for front, start, want in ((True, L.o_w[0], want_front), (False, L.n_w[0], want_shade)):
        plan = mc.stream_plan(mk, front)
        assert len(plan) == len(want)
        off = start
        for l, ((kc0, kc1, n), (m0, m1)) in enumerate(zip(plan, want)):
            # the packer's offsets are where the kernel's walk finds each matrix
            if front:
                assert off == L.o_w[l]
            elif l < rt.nerf.depth:
                assert off == L.n_w[l]
            else:
                assert off == (P.n_wf if l == rt.nerf.depth else P.n_wvf)
            for kc, m in ((kc0, m0), (kc1, m1)):
                if m is None:
                    assert kc == 0
                    continue
                assert kc * mc.TC_KC == m.shape[0] and n == m.shape[1]
                if not front and l == rt.nerf.depth + 1 and m is m1:
                    assert off == P.n_wvd
                elif not front and m is m1:
                    assert off == L.n_wx[l]
                got = mc.unpack_chunks(flat, off, kc * mc.TC_KC, n)
                np.testing.assert_array_equal(got, _bits(m))
                off += kc * mc.TC_KC * n
        assert (off - start) * 2 == mc.stream_bytes(mk, front)
    # the oracle's stream runs straight into the NeRF's
    assert L.n_w[0] == L.o_w[0] + mc.stream_bytes(mk, True) // 2
    # the heads stay row-major after the streams
    nw = mc._numpy_state(rt.nerf)
    for off, key in ((P.n_wa, "alpha.w"), (P.n_wrgb, "rgb.w")):
        w = nw[key]
        np.testing.assert_array_equal(flat[off:off + w.size].reshape(w.shape), _bits(w))


@pytest.mark.parametrize("width", [128, 384, 512])
def test_bf16_stream_untiles_at_other_widths(tmp_path, width):
    """At the other widths K1 and K2 take (128 on the fused kernels, 384
    and 512 on the wide path, whose GEMMs read the same stream): walking
    each layer pass by pass (a layer wider than 256 columns comes in
    passes of 256, each pass's chunks of every input in turn:
    megakernel_compact.unpack_layer) un-tiles every
    matrix bit for bit; every chunk is one bulk copy of at most a stage,
    1024-byte aligned; the oracle's stream runs into the NeRF's."""
    export = write_wide_export(tmp_path / "export", width, width)
    rt, _ = tviewer.build_renderer_from_export(export, dtype_str="bf16", device="cpu")
    mk = mc.MegakernelCompact(rt)
    assert (mk.front_wide, mk.shade_wide) == (width > 256,) * 2
    P, L = mk.params, mk.layers
    flat = mk.weights.view(torch.int16).numpy()
    want_front, want_shade = _expected_layers(rt, P)
    for front, start, want in ((True, L.o_w[0], want_front), (False, L.n_w[0], want_shade)):
        plan = mc.stream_plan(mk, front)
        assert len(plan) == len(want)
        off = start
        for (kc0, kc1, n), (m0, m1) in zip(plan, want):
            assert n in (128, width, width // 2)
            got, end = mc.unpack_layer(flat, off, (kc0, kc1), n)
            for g, m in zip(got, (m0, m1)):
                assert (g is None) == (m is None)
                if m is not None:
                    np.testing.assert_array_equal(g, _bits(m))
            for _, np_ in mc.passes(n):
                assert np_ * mc.TC_KC * 2 <= STAGE_BYTES and (off * 2) % 1024 == 0
                off += (kc0 + kc1) * mc.TC_KC * np_
            assert off == end
        assert (off - start) * 2 == mc.stream_bytes(mk, front)
    assert L.n_w[0] == L.o_w[0] + mc.stream_bytes(mk, True) // 2


@pytest.mark.parametrize("n_rows", [128, 256])
def test_swizzle128_is_a_bijection_on_a_chunk(n_rows):
    idx = mc.swizzle128(n_rows)
    assert idx.shape == (n_rows, mc.TC_KC)
    # csrc/mlp_wgmma.cuh::sw128: group k // 8 of row n at group (k // 8) ^ (n % 8)
    assert [int(idx[5, 8 * g]) - 5 * mc.TC_KC for g in range(8)] == \
        [8 * g for g in (5, 4, 7, 6, 1, 0, 3, 2)]
    assert idx[3, 9] == 3 * mc.TC_KC + 2 * 8 + 1 and idx[8, 63] == 8 * mc.TC_KC + 63
    assert np.array_equal(np.sort(idx.reshape(-1)), np.arange(n_rows * mc.TC_KC))
    # each row keeps its own 128 bytes, and 16-byte groups stay whole
    assert np.array_equal(idx // mc.TC_KC, np.broadcast_to(np.arange(n_rows)[:, None], idx.shape))
    assert np.array_equal(idx % 8, np.broadcast_to(np.arange(mc.TC_KC)[None, :] % 8, idx.shape))
    # within each 8-row group (1024 bytes) a column's 16-byte group lands in
    # 8 different bank groups
    groups = (idx % mc.TC_KC) // 8
    for r0 in range(0, n_rows, 8):
        for k in range(0, mc.TC_KC, 8):
            assert len(set(groups[r0:r0 + 8, k])) == 8


@pytest.mark.parametrize("name", ["mscene", "ndc"])
def test_bf16_chunks_sit_where_the_bulk_copy_and_swizzle_need_them(name):
    _, mk = _packed(name)
    P, L = mk.params, mk.layers
    for front, start in ((True, L.o_w[0]), (False, L.n_w[0])):
        off = start * 2  # bytes
        for kc0, kc1, n in mc.stream_plan(mk, front):
            chunk = n * mc.TC_KC * 2
            # one bulk copy per chunk: 16-byte aligned source and size, at
            # most a stage; the stage it lands in is 1024-byte aligned, and
            # so is every chunk start within the stream (8 rows of 128
            # bytes, the swizzle's period), which keeps the copy's bytes in
            # swizzle order
            assert chunk % 1024 == 0 and chunk <= STAGE_BYTES
            for _ in range(kc0 + kc1):
                assert off % 1024 == 0
                off += chunk


@pytest.mark.parametrize("name", ["mscene", "ndc"])
def test_fp32_packing_stays_row_major(name):
    rt, mk = _packed(name, "fp32")
    P, L = mk.params, mk.layers
    assert mk.weights.dtype == torch.float32
    assert P.in0 % 32 == 0 and P.in1 % 32 == 0 and P.in1 == 96
    flat = mk.weights.numpy()
    ow, nw = mc._numpy_state(rt.oracle), mc._numpy_state(rt.nerf)
    for i in range(rt.oracle.depth):
        w = ow[f"{i}.w"]
        rows = P.in0 if i == 0 else w.shape[0]
        cols = 128 if i == rt.oracle.depth - 1 else w.shape[1]
        np.testing.assert_array_equal(flat[L.o_w[i]:L.o_w[i] + rows * cols].reshape(rows, cols),
                                      _pad(w, rows, cols))
    # every NeRF matrix, at its own offset, in the order the bf16 stream
    # and its heads take (the FMA layer reads each by its offset)
    _, shade = _expected_layers(rt, P)
    offs = []
    for l, (m0, m1) in enumerate(shade):
        if l < rt.nerf.depth:
            offs.append((L.n_w[l], m0))
            if m1 is not None:
                offs.append((L.n_wx[l], m1))
        elif l == rt.nerf.depth:
            offs.append((P.n_wf, m0))
        else:
            offs += [(P.n_wvf, m0), (P.n_wvd, m1)]
    offs += [(P.n_wa, nw["alpha.w"]), (P.n_wrgb, nw["rgb.w"])]
    assert [o for o, _ in offs] == sorted(o for o, _ in offs)
    for off, w in offs:
        np.testing.assert_array_equal(flat[off:off + w.size].reshape(w.shape), w)
