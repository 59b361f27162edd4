"""A JPEG decoder in numpy, the port's counterpart of
``imageio.v2.imread`` on a JPEG file (imageio reads it through PIL, which
decodes with libjpeg-turbo); the machine that runs the port on the GPU has
neither.

Formats: baseline, extended sequential and progressive DCT, Huffman- or
arithmetic-coded (SOF0, SOF1, SOF2, SOF9, SOF10), and lossless Huffman
(SOF3); 8-bit samples, 1 component (greyscale, returned (h, w) uint8), 3
(YCbCr, or RGB under an Adobe transform 0 or 'R', 'G', 'B' component ids;
returned (h, w, 3) uint8) or 4 (CMYK, or YCCK under an Adobe transform
other than 0, as libjpeg infers it; returned (h, w, 4) uint8 as Pillow
returns it: every channel inverted, Adobe's polarity, after libjpeg's YCCK
-> CMYK), sampling factors 1-4 whose ratios to the largest are whole
(4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, 4:1:0, ...), interleaved or one scan
per component, restart intervals (DRI), 8- or 16-bit quantization tables;
every process takes every layout, lossless too. A progressive file's
scans (spectral selection, successive approximation: DC first and
refinement, AC first and refinement with their end-of-band runs and
correction bits, restart intervals inside any of them) build up each
block's coefficients, which then decode as a sequential file's. APPn and
COM segments are skipped, EXIF included; as imageio, no EXIF orientation
is applied. What imageio refuses too raises a ``ValueError`` that names
the format: arithmetic-coded lossless (SOF11), the hierarchical processes
(SOF5-7, SOF13-15), samples of other than 8 bits, a lossless file that
libjpeg reads as YCbCr or YCCK (a JFIF marker or an Adobe transform other
than 0: libjpeg-turbo has no lossless colour conversion), 2 or more than 4
components (Pillow maps none to a mode), sampling factors outside 1-4, a
ratio to the largest that is not whole (libjpeg-turbo: "fractional
sampling not implemented") or more than 10 blocks in an MCU, and a file
that ends inside its entropy-coded data (ROADMAP Queue 1, item 23).

The pixels are libjpeg-turbo's under its defaults: the integer "islow"
inverse DCT (``jidctint.c``), fancy (triangle) upsampling of 2x chroma
(``jdsample.c``: h2v1 and h2v2 only on planes wider than 2 samples, box
replication otherwise; h1v2 always; every other whole ratio, and every
ratio of a lossless frame, by replication, ``int_upsample``) and the
fixed-point YCbCr -> RGB tables of ``jdcolor.c``, so they equal PIL's.

The Huffman decode is the one sequential part. It reads each restart
interval's unstuffed bytes through 64-bit windows (one per byte offset,
built in numpy a chunk at a time) and a 65,536-entry lookahead table per
Huffman table, which gives for the next 16 bits the code's length, the
AC run and, where code and value bits fit in the 16, the decoded
coefficient, so most coefficients cost one table lookup; a progressive
scan reads the same tables through ``_Bits``, and a DC refinement scan,
one bit a block, is read in numpy. Dequantization, the IDCT, upsampling
and colour conversion run in numpy over all blocks.

Arithmetic-coded scans decode through the QM coder of ``jdarith.c`` (ITU
T.81 Annex D: the Qe table ``_QM``, one binary decision at a time, each
restart interval starting with fresh statistics), with DC conditioning on
the previous difference's category (the DAC segment's L and U) and AC
magnitude contexts split at Kx, into the same coefficient arrays. A
lossless scan Huffman-decodes one difference a sample (``jdlhuff.c``)
and undoes the prediction (``jdlossls.c``: predictors 1-7, the first row
of each restart interval from the left and the first column from above,
the point transform's left shift) a row at a time in numpy, predictors 6
and 7 a sample at a time.
"""

from __future__ import annotations

import functools
import re
import struct
from array import array

import numpy as np

_ITEM = "ROADMAP Queue 1, item 23"  # what imageio refuses too
# zigzag position k -> natural (row-major) index of the 8x8 block
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_NATURAL = np.argsort(_ZIGZAG)  # natural index -> zigzag position
# baseline, extended sequential, progressive, lossless; arithmetic-coded
# sequential and progressive
_FRAMES = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)
_REFUSED = {
    0xC5: "differential sequential DCT (SOF5, hierarchical)",
    0xC6: "differential progressive DCT (SOF6, hierarchical)",
    0xC7: "differential lossless (SOF7, hierarchical)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential DCT (SOF13)",
    0xCE: "arithmetic-coded differential progressive DCT (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}
_CHUNK = 1 << 16  # bytes of 64-bit windows built at a time
_SLACK = 256  # a block reads at most 64 x 27 bits = 216 bytes, plus a window


def is_jpeg(head: bytes) -> bool:
    """Whether a file's first bytes are a JPEG's (SOI then a marker)."""
    return head[:3] == b"\xff\xd8\xff"


def read_jpeg(path: str) -> np.ndarray:
    """Decode a JPEG file: (h, w, 3) uint8 RGB, (h, w, 4) CMYK or (h, w)
    greyscale."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def _refuse(name, what):
    """A format that imageio (libjpeg-turbo) refuses too."""
    raise ValueError(f"{name}: unsupported JPEG format: {what}, which imageio (libjpeg-turbo, "
                     f"the JAX package's reader) refuses too ({_ITEM})")


@functools.lru_cache(maxsize=64)
def _huffman_table(kind: int, counts: bytes, symbols: bytes):
    """The lookahead table of one Huffman table (``kind`` 0 DC, 1 AC),
    indexed by the next 16 bits of the stream.

    DC entries are (t, v): t > 0 is the code and value bits' length and v
    the decoded difference; t == 0 a code whose value bits overrun the 16
    (v: the code's length); t == -1 no code. AC entries are (t, r, v): t >
    0 a coefficient v after a run of r zeros, t bits in all; t == 0 with r
    == -1 end of block, -2 a run of 16 zeros, -3 a value past the 16 bits
    (v: the code's length in these three), -4 no code. Also returns each
    index's symbol, for the long codes."""
    length = np.zeros(1 << 16, np.int64)
    symbol = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            if code >= 1 << n:
                raise ValueError("corrupt JPEG: bad Huffman table")
            lo, hi = code << (16 - n), (code + 1) << (16 - n)
            length[lo:hi] = n
            symbol[lo:hi] = symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    idx = np.arange(1 << 16, dtype=np.int64)
    size = symbol & 15 if kind else symbol
    fits = (length > 0) & (length + size <= 16)
    shift = np.where(fits, 16 - length - size, 0)
    raw = (idx >> shift) & ((1 << size) - 1)
    value = np.where(raw < (1 << np.maximum(size - 1, 0)), raw - (1 << size) + 1, raw)
    value = np.where(size == 0, 0, value)
    if not kind:
        t = np.where(length == 0, -1, np.where(fits, length + size, 0))
        v = np.where(fits, value, length)
        return list(zip(t.tolist(), v.tolist())), symbol.tolist()
    run = symbol >> 4
    t = np.where(fits & (size > 0), length + size, 0)
    r = np.select([length == 0, size > 0, run == 15], [-4, np.where(fits, run, -3), -2], -1)
    v = np.where(t > 0, value, length)
    return list(zip(t.tolist(), r.tolist(), v.tolist())), symbol.tolist()


def _segments(data: bytes, start: int, name: str):
    """The entropy-coded data of a scan from ``start``: its restart
    intervals' bytes (stuffing removed) and the offset of the marker that
    ends the scan."""
    segs, seg_start = [], start
    for m in re.finditer(rb"\xff(?=[\x01-\xff])", data[start:]):
        p = start + m.start()
        b = data[p + 1]
        if b == 0xFF:
            continue  # a fill byte before a marker
        if 0xD0 <= b <= 0xD7:
            segs.append(data[seg_start:p].rstrip(b"\xff").replace(b"\xff\x00", b"\xff"))
            seg_start = p + 2
            continue
        segs.append(data[seg_start:p].rstrip(b"\xff").replace(b"\xff\x00", b"\xff"))
        return segs, p
    raise ValueError(f"{name}: truncated JPEG: the file ends inside its entropy-coded data")


def _windows(buf: np.ndarray, b0: int) -> list:
    """64-bit big-endian windows of ``buf`` (zero-padded uint8) at byte
    offsets b0, b0 + 1, ... as Python ints."""
    n = min(_CHUNK, buf.size - 8 - b0)
    if n <= 0:
        return []
    a = buf[b0:b0 + n + 8].astype(np.uint64)
    w = np.zeros(n, np.uint64)
    for k in range(8):
        w = (w << np.uint64(8)) | a[k:k + n]
    return w.tolist()


def _decode_interval(seg: bytes, blocks, tables, coefs, name):
    """Huffman-decode one restart interval's blocks. ``blocks`` is a list
    of (component, offset) in scan order, ``tables`` per component (DC
    table, AC table, DC symbols, AC symbols); each block's 64 coefficients
    go to ``coefs[component][offset:offset + 64]`` in zigzag order."""
    buf = np.frombuffer(seg + bytes(_SLACK + 8), np.uint8)
    nbits = 8 * len(seg)
    pos, base = 0, 0
    win = _windows(buf, 0)
    limit = (len(win) - _SLACK) * 8
    pred = {}
    for ci, off in blocks:
        if pos - base > limit:
            base = pos & ~7
            win = _windows(buf, base >> 3)
            limit = (len(win) - _SLACK) * 8
        dctab, actab, dcsym, acsym = tables[ci]
        out = coefs[ci]
        # DC
        p = pos - base
        w = win[p >> 3]
        t, v = dctab[(w >> (48 - (p & 7))) & 0xFFFF]
        if t > 0:
            pos += t
        elif t == 0:  # v: the code's length
            s = dcsym[(w >> (48 - (p & 7))) & 0xFFFF]
            pos += v + s
            v = (w >> (64 - (p & 7) - v - s)) & ((1 << s) - 1)
            if v < 1 << (s - 1):
                v -= (1 << s) - 1
        else:
            raise ValueError(f"{name}: corrupt JPEG: bad Huffman code")
        v += pred.get(ci, 0)
        pred[ci] = v
        out[off] = v
        # AC
        k = 1
        while k < 64:
            p = pos - base
            w = win[p >> 3]
            t, r, v = actab[(w >> (48 - (p & 7))) & 0xFFFF]
            if t:
                k += r
                out[off + k] = v
                k += 1
                pos += t
            elif r == -1:
                pos += v
                break
            elif r == -2:
                pos += v
                k += 16
            elif r == -3:
                rs = acsym[(w >> (48 - (p & 7))) & 0xFFFF]
                s = rs & 15
                x = (w >> (64 - (p & 7) - v - s)) & ((1 << s) - 1)
                if x < 1 << (s - 1):
                    x -= (1 << s) - 1
                k += rs >> 4
                out[off + k] = x
                k += 1
                pos += v + s
            else:
                raise ValueError(f"{name}: corrupt JPEG: bad Huffman code")
        if k > 64:
            raise ValueError(f"{name}: corrupt JPEG: a block runs past 64 coefficients")
    if pos > nbits:
        raise ValueError(f"{name}: corrupt or truncated JPEG: the entropy-coded data ends "
                         f"before its blocks")


# jidctint.c, CONST_BITS = 13, PASS1_BITS = 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x):
    """One pass of ``jpeg_idct_islow`` over the 8 inputs ``x`` (arrays):
    its 8 outputs before the pass's descale."""
    z1 = (x[2] + x[6]) * _F0541
    tmp2 = z1 - x[6] * _F1847
    tmp3 = z1 + x[2] * _F0765
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


# jdmaster.c's post-IDCT range limit, indexed by an output & 1023: -128..127
# to 0..255, 128..511 to 255, -512..-129 to 0 (outputs beyond wrap)
_RANGE_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                               np.arange(0, 128)]).astype(np.uint8)


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg's integer IDCT: (n, 64) natural-order coefficients and the
    (64,) natural-order quantization table -> (n, 8, 8) uint8 samples."""
    x = coefs.astype(np.int64).reshape(-1, 8, 8) * quant.astype(np.int64).reshape(8, 8)
    cols = _idct_1d([x[:, k, :] for k in range(8)])  # pass 1 down the columns
    # the pass's int workspace
    ws = np.stack([(c + (1 << 10)) >> 11 for c in cols], axis=1).astype(np.int32)
    rows = _idct_1d([ws[:, :, k].astype(np.int64) for k in range(8)])  # pass 2 along the rows
    out = np.stack([(r + (1 << 17)) >> 18 for r in rows], axis=2)
    return _RANGE_LIMIT[out & 1023]


def _upsample(plane: np.ndarray, fh: int, fv: int, fancy: bool = True) -> np.ndarray:
    """libjpeg-turbo's upsampling of a (h, w) component plane by whole
    ratios fh x fv: fancy (triangle, edge-replicated) for h2v1 and h2v2 on
    planes wider than 2 samples and for h1v2, replication otherwise and
    for every ratio where ``fancy`` is off (a lossless frame)."""
    if fh == 1 and fv == 1:
        return plane
    x = plane.astype(np.int32)
    h, w = x.shape
    if not fancy or (fh, fv) not in ((2, 1), (1, 2), (2, 2)) or (fh == 2 and w <= 2):
        # jdsample.c: h2v1_upsample, h2v2_upsample, int_upsample
        return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)
    if fv == 2:
        above = np.concatenate([x[:1], x[:-1]], axis=0)
        below = np.concatenate([x[1:], x[-1:]], axis=0)
        rows = np.empty((2 * h, w), np.int32)
        rows[0::2], rows[1::2] = 3 * x + above, 3 * x + below
        if fh == 1:  # h1v2: one tap each way, biases 1 and 2 out of 4
            rows[0::2] += 1
            rows[1::2] += 2
            return (rows >> 2).astype(np.uint8)
        x, bias, shift = rows, (8, 7), 4  # h2v2 on column sums (x 4)
    else:
        bias, shift = (1, 2), 2  # h2v1
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * w), np.int32)
    out[:, 0::2] = (3 * x + left + bias[0]) >> shift
    out[:, 1::2] = (3 * x + right + bias[1]) >> shift
    return out.astype(np.uint8)


def _ycc_tables():
    """jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(f):
        return int(f * 65536 + 0.5)
    return ((fix(1.40200) * x + 32768) >> 16, (fix(1.77200) * x + 32768) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + 32768)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """(h, w) uint8 Y, Cb, Cr -> (h, w, 3) uint8 RGB, as ``jdcolor.c``."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


class _Frame:
    """A frame header (SOF ``marker``) and what its scans decode into: each
    component's zigzag-ordered coefficients, a lossless frame's sample
    planes."""

    def __init__(self, body: bytes, name: str, marker: int, allocate: bool = True):
        precision, self.h, self.w, n = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            _refuse(name, f"{precision}-bit samples")
        if n not in (1, 3, 4):
            _refuse(name, f"{n} components (Pillow maps no mode to them)")
        if self.h == 0 or self.w == 0:
            _refuse(name, "a height set by a DNL marker" if self.h == 0 else "width 0")
        self.progressive = marker in (0xC2, 0xCA)
        self.arithmetic = marker in (0xC9, 0xCA)
        self.lossless = marker == 0xC3
        self.ids, self.hs, self.vs, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            self.ids.append(cid)
            self.hs.append(hv >> 4)
            self.vs.append(hv & 15)
            self.tq.append(tq)
        factors = list(zip(self.hs, self.vs))
        if not all(1 <= f <= 4 for f in self.hs + self.vs):
            _refuse(name, f"sampling factors {factors} (libjpeg takes 1 to 4)")
        if n == 1:  # a single component's MCU is one block whatever its factors
            self.hs, self.vs = [1], [1]
        self.hmax, self.vmax = max(self.hs), max(self.vs)
        if any(self.hmax % h or self.vmax % v for h, v in zip(self.hs, self.vs)):
            _refuse(name, f"sampling factors {factors}, a ratio to the largest that is not "
                          "whole (libjpeg-turbo: fractional sampling not implemented)")
        unit = 1 if self.lossless else 8  # a data unit: a sample or an 8x8 block
        self.mcux = -(-self.w // (unit * self.hmax))
        self.mcuy = -(-self.h // (unit * self.vmax))
        self.coefs = [array("h", bytes(2 * 64 * self.mcux * h * self.mcuy * v))
                      for h, v in zip(self.hs, self.vs)] \
            if allocate and not self.lossless else None
        self.planes = [np.zeros(self.comp_size(c)[::-1], np.uint8) for c in range(n)] \
            if allocate and self.lossless else None
        self.quant = [None] * n
        self.scanned = [False] * n
        self.space = None  # "grey", "rgb", "ycc", "cmyk" or "ycck", set at the first scan

    def comp_size(self, c):
        """(width, height) in samples of component c's plane."""
        return (-(-self.w * self.hs[c] // self.hmax), -(-self.h * self.vs[c] // self.vmax))


def _mcu_units(frame: _Frame, comps, name):
    """(component, dy, dx) of each data unit of an interleaved scan's MCU,
    refused as libjpeg refuses more than 10 (``jdinput.c``)."""
    units = [(c, dy, dx) for c in comps for dy in range(frame.vs[c]) for dx in range(frame.hs[c])]
    if len(units) > 10:
        _refuse(name, f"{len(units)} data units in an MCU (libjpeg takes at most 10)")
    return units


def _scan_blocks(frame: _Frame, comps, name):
    """(component, coefficient offset) of every block of a scan in order."""
    if len(comps) == 1:  # non-interleaved: the component's own blocks
        c = comps[0]
        cw, ch = frame.comp_size(c)
        bx, by = -(-cw // 8), -(-ch // 8)
        stride = frame.mcux * frame.hs[c]
        offs = ((np.arange(by)[:, None] * stride + np.arange(bx)[None, :]) * 64).ravel()
        return [(c, o) for o in offs.tolist()], 1
    per_mcu = _mcu_units(frame, comps, name)
    my, mx = np.meshgrid(np.arange(frame.mcuy), np.arange(frame.mcux), indexing="ij")
    my, mx = my.ravel(), mx.ravel()
    cols = []
    for c, dy, dx in per_mcu:
        stride = frame.mcux * frame.hs[c]
        cols.append(((my * frame.vs[c] + dy) * stride + mx * frame.hs[c] + dx) * 64)
    offs = np.stack(cols, axis=1).ravel().tolist()
    cis = [c for c, _, _ in per_mcu] * (frame.mcux * frame.mcuy)
    return list(zip(cis, offs)), len(per_mcu)


def _next_segment(data: bytes, pos: int, name: str):
    """The marker at or after ``pos`` (fill bytes and stray bytes skipped,
    as libjpeg skips them), its segment's body (None for a marker without
    one) and the offset after the segment."""
    while pos < len(data) and data[pos] != 0xFF:
        pos += 1
    while pos < len(data) and data[pos] == 0xFF:
        pos += 1
    if pos >= len(data):
        raise ValueError(f"{name}: truncated JPEG: no end-of-image marker")
    marker = data[pos]
    pos += 1
    if 0xD0 <= marker <= 0xD9 or marker == 0x01:
        return marker, None, pos
    if pos + 2 > len(data):
        raise ValueError(f"{name}: truncated JPEG")
    (seglen,) = struct.unpack(">H", data[pos:pos + 2])
    body = data[pos + 2:pos + seglen]
    if len(body) != seglen - 2:
        raise ValueError(f"{name}: truncated JPEG: a segment runs past the file's end")
    return marker, body, pos + seglen


def _colour_space(frame: _Frame, jfif: bool, adobe, name: str) -> str:
    """A frame's colour space as libjpeg-turbo infers it (``jdapimin.c``):
    1 component greyscale; 3 YCbCr under a JFIF marker, else RGB under an
    Adobe transform 0 and YCbCr under another, else RGB for the component
    ids 'R', 'G', 'B' or a lossless frame; 4 CMYK without an Adobe marker
    or under transform 0, else YCCK. libjpeg-turbo converts no lossless
    colour, so a lossless YCbCr or YCCK frame is refused."""
    n = len(frame.ids)
    if n == 1:
        return "grey"
    if n == 4:
        space = "cmyk" if adobe in (None, 0) else "ycck"
    elif jfif:
        space = "ycc"
    elif adobe is not None:
        space = "rgb" if adobe == 0 else "ycc"
    else:
        space = "rgb" if frame.lossless or frame.ids == [82, 71, 66] else "ycc"
    if frame.lossless and space in ("ycc", "ycck"):
        _refuse(name, f"a lossless frame read as {'YCbCr' if space == 'ycc' else 'YCCK'} (a "
                      "JFIF marker or an Adobe transform other than 0; libjpeg-turbo has no "
                      "lossless colour conversion)")
    return space


def probe_jpeg(data: bytes, name: str = "<bytes>"):
    """(height, width, components) from a JPEG's headers up to its first
    scan, raising the decoder's ValueError for a format it refuses; nothing
    is decoded."""
    if not is_jpeg(data):
        raise ValueError(f"{name}: not a JPEG file")
    frame, adobe, jfif = None, None, False
    pos = 2
    while True:
        marker, body, pos = _next_segment(data, pos, name)
        if marker in _REFUSED:
            _refuse(name, _REFUSED[marker])
        if marker in _FRAMES and frame is None:
            frame = _Frame(body, name, marker, allocate=False)
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker in (0xD9, 0xDA):
            if frame is None:
                raise ValueError(f"{name}: corrupt JPEG: no frame header before the scan")
            _colour_space(frame, jfif, adobe, name)
            return frame.h, frame.w, len(frame.ids)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a JPEG file's bytes (see the module docstring): (h, w, 3)
    uint8 RGB, or (h, w) uint8 for greyscale."""
    if not is_jpeg(data):
        raise ValueError(f"{name}: not a JPEG file")
    qtables, htables = {}, {}
    conditioning = {}  # DAC: Tc << 4 | Tb -> L + 16 U (DC) or Kx (AC)
    frame, restart, adobe, jfif = None, 0, None, False
    pos = 2
    while True:
        marker, body, pos = _next_segment(data, pos, name)
        if marker == 0xD9:  # EOI
            break
        if body is None:
            continue
        if marker in _REFUSED:
            _refuse(name, _REFUSED[marker])
        elif marker in _FRAMES:
            if frame is not None:
                raise ValueError(f"{name}: corrupt JPEG: two frames")
            frame = _Frame(body, name, marker)
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                total = sum(counts)
                htables[(tc, th)] = (counts, body[i + 17:i + 17 + total])
                i += 17 + total
        elif marker == 0xCC:  # DAC
            for i in range(0, len(body) - 1, 2):
                index, value = body[i], body[i + 1]
                if index >= 32 or (index < 16 and value & 15 > value >> 4) \
                        or (index >= 16 and not 1 <= value <= 63):
                    raise ValueError(f"{name}: corrupt JPEG: DAC entry {index}: {value}")
                conditioning[index] = value
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    zz = np.frombuffer(body[i + 1:i + 129], ">u2").astype(np.int64)
                else:
                    zz = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(np.int64)
                qtables[tq] = zz[_NATURAL]
                i += 129 if pq else 65
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{name}: corrupt JPEG: a scan before the frame header")
            if frame.space is None:  # libjpeg decides before a scan
                frame.space = _colour_space(frame, jfif, adobe, name)
            if frame.lossless:
                pos = _lossless_scan(data, pos, body, frame, htables, restart, name)
            else:
                pos = _scan(data, pos, body, frame, qtables, htables, conditioning, restart,
                            name)
        # APPn, COM and other segments: skipped
    if frame is None or not all(frame.scanned):
        raise ValueError(f"{name}: corrupt JPEG: no frame, or a component without a scan")
    planes = []
    for c in range(len(frame.ids)):
        cw, ch = frame.comp_size(c)
        if frame.lossless:
            plane = frame.planes[c]
        else:
            bx, by = frame.mcux * frame.hs[c], frame.mcuy * frame.vs[c]
            zz = np.frombuffer(frame.coefs[c], np.int16).reshape(-1, 64)
            pix = np.concatenate([idct_islow(zz[i:i + 16384][:, _NATURAL], frame.quant[c])
                                  for i in range(0, zz.shape[0], 16384)])
            plane = pix.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        plane = _upsample(plane[:ch, :cw], frame.hmax // frame.hs[c], frame.vmax // frame.vs[c],
                          fancy=not frame.lossless)
        planes.append(plane[:frame.h, :frame.w])
    if frame.space == "grey":
        return planes[0]
    if frame.space == "ycc":
        return ycc_to_rgb(*planes)
    if frame.space == "ycck":  # libjpeg's YCCK -> CMYK inverts R, G, B; Pillow inverts back
        return np.concatenate([ycc_to_rgb(*planes[:3]), 255 - planes[3][..., None]], axis=-1)
    out = np.stack(planes, axis=-1)
    return 255 - out if frame.space == "cmyk" else out


def _scan(data, pos, body, frame: _Frame, qtables, htables, conditioning, restart,
          name) -> int:
    """Decode the DCT scan whose header is ``body`` and whose data starts at
    ``pos``; returns the offset of the marker after it."""
    ns = body[0]
    ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, \
        body[3 + 2 * ns] & 15
    if not frame.progressive and (ss != 0 or se != 63):
        _refuse(name, f"a spectral-selection scan ({ss}..{se}) in a sequential frame")
    if frame.progressive and (se > 63 or ss > se or (ss == 0) != (se == 0)
                              or (ss > 0 and ns != 1) or al > 13
                              or (ah != 0 and al != ah - 1)):
        raise ValueError(f"{name}: corrupt JPEG: a progressive scan of band {ss}..{se}, "
                         f"bits {ah}->{al} over {ns} components")
    # the tables the scan reads: DC for a sequential scan and a DC first
    # scan, AC for a sequential scan and an AC scan
    need_dc = not frame.progressive or (ss == 0 and ah == 0)
    need_ac = not frame.progressive or ss > 0
    comps, tables = [], {}
    for i in range(ns):
        cid, tt = body[1 + 2 * i:3 + 2 * i]
        if cid not in frame.ids:
            raise ValueError(f"{name}: corrupt JPEG: a scan names component {cid}")
        c = frame.ids.index(cid)
        comps.append(c)
        td, ta = tt >> 4, tt & 15
        if frame.tq[c] not in qtables:
            raise ValueError(f"{name}: corrupt JPEG: undefined quantization table")
        if frame.quant[c] is None:  # latched at the component's first scan, as libjpeg's
            frame.quant[c] = qtables[frame.tq[c]]
        frame.scanned[c] = True
        if frame.arithmetic:  # the conditioning tables (DAC; T.81's defaults L 0, U 1, Kx 5)
            if td > 3 or ta > 3:
                raise ValueError(f"{name}: corrupt JPEG: arithmetic table {max(td, ta)}")
            dac = conditioning.get(td, 0x10)
            tables[c] = (td, ta, dac & 15, dac >> 4, conditioning.get(16 + ta, 5))
            continue
        if (need_dc and (0, td) not in htables) or (need_ac and (1, ta) not in htables):
            raise ValueError(f"{name}: corrupt JPEG: a scan uses an undefined Huffman table")
        dc, dcsym = _huffman_table(0, *htables[(0, td)]) if need_dc else (None, None)
        ac, acsym = _huffman_table(1, *htables[(1, ta)]) if need_ac else (None, None)
        tables[c] = (dc, ac, dcsym, acsym)
    segs, end = _segments(data, pos, name)
    blocks, per_mcu = _scan_blocks(frame, comps, name)
    step = restart * per_mcu if restart else len(blocks)
    n_int = -(-len(blocks) // step)
    if len(segs) < n_int:
        raise ValueError(f"{name}: corrupt or truncated JPEG: {len(segs)} restart intervals "
                         f"where {n_int} are needed")
    try:
        for j in range(n_int):
            part = blocks[j * step:(j + 1) * step]
            if frame.arithmetic:
                _arith_interval(_QMDecoder(segs[j]), part, tables, frame.coefs, ss, se, ah, al,
                                frame.progressive, name)
            elif not frame.progressive:
                _decode_interval(segs[j], part, tables, frame.coefs, name)
            elif ss == 0 and ah:
                _dc_refine(segs[j], part, frame.coefs, al, name)
            elif ss == 0:
                _dc_first(_Bits(segs[j]), part, tables, frame.coefs, al, name)
            else:
                c = comps[0]
                _ac_scan(_Bits(segs[j]), [o for _, o in part], tables[c], frame.coefs[c],
                         ss, se, ah, al, name)
    except (IndexError, OverflowError) as err:
        raise ValueError(f"{name}: corrupt JPEG: {err}") from None
    return end


class _Bits:
    """A restart interval's bits, read through the 64-bit windows of
    ``_windows`` as ``_decode_interval`` reads them: ``block()`` before
    each block moves the windows on, ``peek()`` gives the next 16 bits,
    ``take(n)`` consumes n. A block reads at most 64 codes and their value
    and correction bits, well inside ``_SLACK``."""

    def __init__(self, seg: bytes):
        self.buf = np.frombuffer(seg + bytes(_SLACK + 8), np.uint8)
        self.nbits = 8 * len(seg)
        self.pos = self.base = 0
        self.win = _windows(self.buf, 0)
        self.limit = (len(self.win) - _SLACK) * 8

    def block(self):
        if self.pos - self.base > self.limit:
            self.base = self.pos & ~7
            self.win = _windows(self.buf, self.base >> 3)
            self.limit = (len(self.win) - _SLACK) * 8

    def peek(self) -> int:
        p = self.pos - self.base
        return (self.win[p >> 3] >> (48 - (p & 7))) & 0xFFFF

    def take(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - self.base
        self.pos += n
        return (self.win[p >> 3] >> (64 - (p & 7) - n)) & ((1 << n) - 1)

    def check(self, name):
        if self.pos > self.nbits:
            raise ValueError(f"{name}: corrupt or truncated JPEG: the entropy-coded data ends "
                             f"before its blocks")


def _extend(x: int, s: int) -> int:
    """The signed value of ``s`` value bits ``x`` (JPEG's EXTEND)."""
    return x - (1 << s) + 1 if x < 1 << (s - 1) else x


def _ac_symbol(bits: _Bits, actab, acsym, name):
    """One AC code of a progressive scan: (run, value), value 0 for the
    codes without a coefficient (run 15: sixteen zeros; else an end-of-band
    run of 2^run plus run more bits' blocks)."""
    look = bits.peek()
    t, r, v = actab[look]
    if t:
        bits.pos += t
        return r, v
    if r == -3:  # the value bits run past the 16
        rs = acsym[look]
        bits.pos += v
        s = rs & 15
        return rs >> 4, _extend(bits.take(s), s)
    if r == -2:
        bits.pos += v
        return 15, 0
    if r == -1:
        bits.pos += v
        return acsym[look] >> 4, 0
    raise ValueError(f"{name}: corrupt JPEG: bad Huffman code")


def _dc_first(bits: _Bits, blocks, tables, coefs, al, name):
    """A progressive DC first scan: each block's DC difference, as a
    sequential scan's, scaled by 2^al."""
    pred = {}
    for ci, off in blocks:
        bits.block()
        dctab, _, dcsym, _ = tables[ci]
        look = bits.peek()
        t, v = dctab[look]
        if t > 0:
            bits.pos += t
        elif t == 0:  # v: the code's length
            s = dcsym[look]
            bits.pos += v
            v = _extend(bits.take(s), s) if s else 0
        else:
            raise ValueError(f"{name}: corrupt JPEG: bad Huffman code")
        v += pred.get(ci, 0)
        pred[ci] = v
        coefs[ci][off] = v * (1 << al)
    bits.check(name)


def _dc_refine(seg: bytes, blocks, coefs, al, name):
    """A progressive DC refinement scan: one raw bit a block, bit al of its
    DC coefficient (numpy over the interval's blocks)."""
    bit = np.unpackbits(np.frombuffer(seg, np.uint8))
    if bit.size < len(blocks):
        raise ValueError(f"{name}: corrupt or truncated JPEG: the entropy-coded data ends "
                         f"before its blocks")
    ci = np.array([c for c, _ in blocks])
    off = np.array([o for _, o in blocks])
    set_ = bit[:len(blocks)].astype(bool)
    for c in np.unique(ci).tolist():
        view = np.frombuffer(coefs[c], np.int16)
        at = off[set_ & (ci == c)]
        view[at] |= np.int16(1 << al)


def _ac_scan(bits: _Bits, offs, table, out, ss, se, ah, al, name):
    """A progressive AC scan of one component's blocks over the band
    ss..se (zigzag positions): a first scan (ah == 0) writes coefficients
    scaled by 2^al; a refinement scan adds bit al to the coefficients
    already nonzero (one correction bit each, where the band reaches them)
    and places the new +-2^al ones. End-of-band runs carry across the
    interval's blocks, as ``jdphuff.c`` decodes them."""
    _, actab, _, acsym = table
    eobrun = 0
    if not ah:
        for off in offs:
            if eobrun:
                eobrun -= 1
                continue
            bits.block()
            k = ss
            while k <= se:
                r, v = _ac_symbol(bits, actab, acsym, name)
                if v:
                    k += r
                    if k > se:
                        raise ValueError(f"{name}: corrupt JPEG: a block runs past its band")
                    out[off + k] = v * (1 << al)
                elif r == 15:
                    k += 15
                else:
                    eobrun = (1 << r) + bits.take(r) - 1
                    break
                k += 1
        bits.check(name)
        return
    p1, m1 = 1 << al, -1 << al
    for off in offs:
        bits.block()
        k = ss
        if not eobrun:
            while k <= se:
                r, v = _ac_symbol(bits, actab, acsym, name)
                if v not in (0, 1, -1):
                    raise ValueError(f"{name}: corrupt JPEG: a refinement coefficient of "
                                     f"size above 1")
                if not v and r != 15:
                    eobrun = (1 << r) + bits.take(r)
                    break
                # skip r zero coefficients (correcting the nonzero ones on
                # the way) and stop at the zero that takes the new value
                while k <= se:
                    c = out[off + k]
                    if c:
                        if bits.take(1) and not c & p1:
                            out[off + k] = c + (p1 if c >= 0 else m1)
                    elif r:
                        r -= 1
                    else:
                        break
                    k += 1
                if v:
                    if k > se:
                        raise ValueError(f"{name}: corrupt JPEG: a block runs past its band")
                    out[off + k] = p1 if v > 0 else m1
                k += 1
        if eobrun:
            for k in range(k, se + 1):
                c = out[off + k]
                if c and bits.take(1) and not c & p1:
                    out[off + k] = c + (p1 if c >= 0 else m1)
            eobrun -= 1
    bits.check(name)


# ITU T.81 Table D.2 (``jaricom.c``): (Qe, next index after an MPS, next
# index after an LPS, switch MPS) per state, and state 113, the fixed
# 0.5 estimate the sign and correction bits use
_QM = (
    (0x5A1D, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0), (0x080B, 4, 18, 0),
    (0x03D8, 5, 20, 0), (0x01DA, 6, 23, 0), (0x00E5, 7, 25, 0), (0x006F, 8, 28, 0),
    (0x0036, 9, 30, 0), (0x001A, 10, 33, 0), (0x000D, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5A7F, 15, 15, 1), (0x3F25, 16, 36, 0),
    (0x2CF2, 17, 38, 0), (0x207C, 18, 39, 0), (0x17B9, 19, 40, 0), (0x1182, 20, 42, 0),
    (0x0CEF, 21, 43, 0), (0x09A1, 22, 45, 0), (0x072F, 23, 46, 0), (0x055C, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0), (0x01B1, 28, 54, 0),
    (0x0144, 29, 56, 0), (0x00F5, 30, 57, 0), (0x00B7, 31, 59, 0), (0x008A, 32, 60, 0),
    (0x0068, 33, 62, 0), (0x004E, 34, 63, 0), (0x003B, 35, 32, 0), (0x002C, 9, 33, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 38, 64, 0), (0x3A0D, 39, 65, 0), (0x2EF1, 40, 67, 0),
    (0x261F, 41, 68, 0), (0x1F33, 42, 69, 0), (0x19A8, 43, 70, 0), (0x1518, 44, 72, 0),
    (0x1177, 45, 73, 0), (0x0E74, 46, 74, 0), (0x0BFB, 47, 75, 0), (0x09F8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05CD, 51, 48, 0), (0x04DE, 52, 50, 0),
    (0x040F, 53, 50, 0), (0x0363, 54, 51, 0), (0x02D4, 55, 52, 0), (0x025C, 56, 53, 0),
    (0x01F8, 57, 54, 0), (0x01A4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00F6, 61, 58, 0), (0x00CB, 62, 59, 0), (0x00AB, 63, 61, 0), (0x008F, 32, 61, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 66, 80, 0), (0x412C, 67, 81, 0), (0x37D8, 68, 82, 0),
    (0x2FE8, 69, 83, 0), (0x293C, 70, 84, 0), (0x2379, 71, 86, 0), (0x1EDF, 72, 87, 0),
    (0x1AA9, 73, 87, 0), (0x174E, 74, 72, 0), (0x1424, 75, 72, 0), (0x119C, 76, 74, 0),
    (0x0F6B, 77, 74, 0), (0x0D51, 78, 75, 0), (0x0BB6, 79, 77, 0), (0x0A40, 48, 77, 0),
    (0x5832, 81, 80, 1), (0x4D1C, 82, 88, 0), (0x438E, 83, 89, 0), (0x3BDD, 84, 90, 0),
    (0x34EE, 85, 91, 0), (0x2EAE, 86, 92, 0), (0x299A, 87, 93, 0), (0x2516, 71, 86, 0),
    (0x5570, 89, 88, 1), (0x4CA9, 90, 95, 0), (0x44D9, 91, 96, 0), (0x3E22, 92, 97, 0),
    (0x3824, 93, 99, 0), (0x32B4, 94, 99, 0), (0x2E17, 86, 93, 0), (0x56A8, 96, 95, 1),
    (0x4F46, 97, 101, 0), (0x47E5, 98, 102, 0), (0x41CF, 99, 103, 0), (0x3C3D, 100, 104, 0),
    (0x375E, 93, 99, 0), (0x5231, 102, 105, 0), (0x4C0F, 103, 106, 0), (0x4639, 104, 107, 0),
    (0x415E, 99, 103, 0), (0x5627, 106, 105, 1), (0x50E7, 107, 108, 0), (0x4B85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504F, 107, 111, 0), (0x5A10, 111, 110, 1), (0x5522, 109, 112, 0),
    (0x59EB, 111, 112, 1), (0x5A1D, 113, 113, 0),
)
# a statistics byte is a state index and, in its top bit, the MPS: per byte,
# its Qe and the byte after an MPS and after an LPS decision
_QE = [_QM[b & 0x7F][0] if b & 0x7F < len(_QM) else 0 for b in range(256)]
_AFTER_MPS = [(b & 0x80) ^ _QM[b & 0x7F][1] if b & 0x7F < len(_QM) else 0 for b in range(256)]
_AFTER_LPS = [(b & 0x80) ^ (_QM[b & 0x7F][2] | _QM[b & 0x7F][3] << 7)
              if b & 0x7F < len(_QM) else 0 for b in range(256)]
_FIXED = 113


class _QMDecoder:
    """The QM coder's decoder (``jdarith.c::arith_decode``, T.81 D.2) over
    one restart interval's unstuffed bytes, zeros past their end (a marker,
    as libjpeg supplies them). ``decode(st, i)`` is one binary decision in
    the context of statistics byte ``st[i]``, which it updates."""

    __slots__ = ("data", "n", "pos", "c", "a", "ct")

    def __init__(self, seg: bytes):
        self.data, self.n, self.pos = seg, len(seg), 0
        self.c, self.a, self.ct = 0, 0, -16  # -16: read two bytes before the first decision

    def decode(self, st, i) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:  # renormalize, reading a byte every 8 shifts
            ct -= 1
            if ct < 0:
                pos = self.pos
                c = (c << 8) | (self.data[pos] if pos < self.n else 0)
                self.pos = pos + 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = _QE[sv]
        a -= qe
        temp = a << ct
        bit = sv >> 7
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = _AFTER_MPS[sv]
            else:
                st[i] = _AFTER_LPS[sv]
                bit ^= 1
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = _AFTER_LPS[sv]
                bit ^= 1
            else:
                st[i] = _AFTER_MPS[sv]
        self.a, self.c, self.ct = a, c, ct
        return bit


def _arith_dc(dec, st, ctx, lower, upper, name):
    """One DC difference (``jdarith.c``'s DC part; F.1.4.4.1): (the
    difference, the next conditioning context) from statistics ``st`` in
    context ``ctx``, the L and U bounds ``lower`` and ``upper``."""
    if not dec(st, ctx):
        return 0, 0
    sign = dec(st, ctx + 1)
    p = ctx + 2 + sign
    m = dec(st, p)
    if m:
        p = 20  # X1
        while dec(st, p):
            m <<= 1
            if m == 0x8000:
                raise ValueError(f"{name}: corrupt JPEG: an arithmetic-coded DC magnitude "
                                 "overflows")
            p += 1
    if m < (1 << lower) >> 1:
        ctx = 0  # zero-difference category
    elif m > (1 << upper) >> 1:
        ctx = 12 + 4 * sign  # large
    else:
        ctx = 4 + 4 * sign  # small
    v = m
    p += 14
    m >>= 1
    while m:
        if dec(st, p):
            v |= m
        m >>= 1
    return (-v - 1 if sign else v + 1), ctx


def _arith_ac(dec, st, fixed, k, kx, name) -> int:
    """One nonzero AC coefficient at zigzag position ``k`` (F.1.4.4.2):
    its sign at the fixed estimate, its magnitude category (bin SP, then
    from 189 up to Kx or 217 above), its bits."""
    sign = dec(fixed, 0)
    p = 3 * (k - 1) + 2
    m = dec(st, p)
    if m and dec(st, p):
        m = 2
        p = 189 if k <= kx else 217
        while dec(st, p):
            m <<= 1
            if m == 0x8000:
                raise ValueError(f"{name}: corrupt JPEG: an arithmetic-coded AC magnitude "
                                 "overflows")
            p += 1
    v = m
    p += 14
    m >>= 1
    while m:
        if dec(st, p):
            v |= m
        m >>= 1
    return -v - 1 if sign else v + 1


def _int16(x: int) -> int:
    """A JCOEF's value of ``x`` (libjpeg keeps coefficients in 16 bits)."""
    x &= 0xFFFF
    return x - 0x10000 if x & 0x8000 else x


def _arith_interval(qm: _QMDecoder, blocks, tables, coefs, ss, se, ah, al, progressive,
                    name):
    """One restart interval of an arithmetic-coded scan (``jdarith.c``:
    ``decode_mcu``, or the progressive ``decode_mcu_{DC,AC}_{first,refine}``)
    into ``coefs`` (zigzag order). The interval starts with zeroed
    statistics (64 DC and 256 AC bins a table), DC predictions and
    contexts. ``tables[c]`` is (DC table, AC table, L, U, Kx)."""
    dec = qm.decode
    fixed = bytearray([_FIXED])
    dc_stats = {t[0]: bytearray(64) for t in tables.values()}
    ac_stats = {t[1]: bytearray(256) for t in tables.values()}
    last, ctx = {}, {}
    if not progressive or (ss == 0 and ah == 0):  # sequential, or a DC first scan
        for ci, off in blocks:
            td, ta, lower, upper, kx = tables[ci]
            diff, ctx[ci] = _arith_dc(dec, dc_stats[td], ctx.get(ci, 0), lower, upper, name)
            v = last.get(ci, 0) + diff
            last[ci] = v
            out = coefs[ci]
            if progressive:
                out[off] = _int16(v << al)
                continue
            out[off] = _int16(v)
            st = ac_stats[ta]
            k = 1
            while k <= 63:
                p = 3 * (k - 1)
                if dec(st, p):  # end of block
                    break
                while not dec(st, p + 1):  # a zero
                    p += 3
                    k += 1
                    if k > 63:
                        raise ValueError(f"{name}: corrupt JPEG: a block runs past 64 "
                                         "coefficients")
                out[off + k] = _arith_ac(dec, st, fixed, k, kx, name)
                k += 1
        return
    if ss == 0:  # DC refinement: bit al of each block's DC at the fixed estimate
        for ci, off in blocks:
            if dec(fixed, 0):
                coefs[ci][off] |= 1 << al
        return
    p1, m1 = 1 << al, -1 << al
    for ci, off in blocks:  # an AC scan of one component's blocks, band ss..se
        _, ta, _, _, kx = tables[ci]
        st, out = ac_stats[ta], coefs[ci]
        if not ah:
            k = ss
            while k <= se:
                p = 3 * (k - 1)
                if dec(st, p):
                    break
                while not dec(st, p + 1):
                    p += 3
                    k += 1
                    if k > se:
                        raise ValueError(f"{name}: corrupt JPEG: a block runs past its band")
                out[off + k] = _arith_ac(dec, st, fixed, k, kx, name) * p1
                k += 1
            continue
        kex = se  # the previous scans' end of block
        while kex > 0 and not out[off + kex]:
            kex -= 1
        k = ss
        while k <= se:
            p = 3 * (k - 1)
            if k > kex and dec(st, p):
                break
            while True:
                c = out[off + k]
                if c:  # a correction bit
                    if dec(st, p + 2):
                        out[off + k] = c + (m1 if c < 0 else p1)
                    break
                if dec(st, p + 1):  # newly nonzero
                    out[off + k] = m1 if dec(fixed, 0) else p1
                    break
                p += 3
                k += 1
                if k > se:
                    raise ValueError(f"{name}: corrupt JPEG: a block runs past its band")
            k += 1


def _lossless_diffs(seg: bytes, n: int, tables, name) -> np.ndarray:
    """Huffman-decode ``n`` differences of a lossless restart interval
    (``jdlhuff.c``), one from each of ``tables`` (DC lookahead table,
    symbols) in turn: a category s (0-16) and s value bits, 16 meaning
    32768 with none."""
    buf = np.frombuffer(seg + bytes(_SLACK + 8), np.uint8)
    pos = base = 0
    win = _windows(buf, 0)
    limit = (len(win) - _SLACK) * 8
    out = array("i", bytes(4 * n))
    k = len(tables)
    for i in range(n):
        if pos - base > limit:
            base = pos & ~7
            win = _windows(buf, base >> 3)
            limit = (len(win) - _SLACK) * 8
        tab, sym = tables[i % k]
        p = pos - base
        w = win[p >> 3]
        look = (w >> (48 - (p & 7))) & 0xFFFF
        t, v = tab[look]
        if t > 0:
            pos += t
        elif t == 0:  # v: the code's length; the value bits run past the 16
            s = sym[look]
            if s == 16:
                pos += v
                v = 32768
            else:
                x = (w >> (64 - (p & 7) - v - s)) & ((1 << s) - 1)
                pos += v + s
                v = x - (1 << s) + 1 if x < 1 << (s - 1) else x
        else:
            raise ValueError(f"{name}: corrupt JPEG: bad Huffman code")
        out[i] = v
    if pos > 8 * len(seg):
        raise ValueError(f"{name}: corrupt or truncated JPEG: the entropy-coded data ends "
                         f"before its samples")
    return np.frombuffer(out, np.int32).astype(np.int64)


def _undifference(d: np.ndarray, predictor: int, pt: int) -> np.ndarray:
    """``jdlossls.c`` over one restart interval's (rows, width) differences
    of a component: the first row predicted from the left (its first sample
    from 2^(7 - pt)), each later row's first sample from above and the
    others by ``predictor`` (Ra left, Rb above, Rc above left), every sum
    modulo 2^16; returns the samples shifted left by ``pt``."""
    rows, width = d.shape
    x = np.empty((rows, width), np.int64)
    x[0] = (np.cumsum(d[0]) + (1 << (7 - pt))) & 0xFFFF
    for i in range(1, rows):
        b, di = x[i - 1], d[i]
        if predictor in (1, 4):  # Ra; Ra + Rb - Rc: a running sum over the row
            row = np.cumsum(di) + (b[0] if predictor == 1 else b)
        elif predictor == 2:  # Rb
            row = di + b
        elif predictor == 3:  # Rc
            row = di.copy()
            row[0] += b[0]
            row[1:] += b[:-1]
        elif predictor == 5:  # Ra + ((Rb - Rc) >> 1)
            t = di.copy()
            t[1:] += (b[1:] - b[:-1]) >> 1
            row = np.cumsum(t) + b[0]
        else:  # 6: Rb + ((Ra - Rc) >> 1), 7: (Ra + Rb) >> 1, a sample at a time
            bl, dl = b.tolist(), di.tolist()
            a = (dl[0] + bl[0]) & 0xFFFF
            out = [a]
            if predictor == 6:
                for j in range(1, width):
                    a = (dl[j] + bl[j] + ((a - bl[j - 1]) >> 1)) & 0xFFFF
                    out.append(a)
            else:
                for j in range(1, width):
                    a = (dl[j] + ((a + bl[j]) >> 1)) & 0xFFFF
                    out.append(a)
            row = np.array(out, np.int64)
        x[i] = row & 0xFFFF
    return (x << pt) & 0xFF


def _lossless_scan(data, pos, body, frame: _Frame, htables, restart, name) -> int:
    """Decode the lossless scan whose header is ``body`` (Ss the predictor,
    Al the point transform) and whose data starts at ``pos`` into the
    frame's sample planes; returns the offset of the marker after it. A
    data unit is one sample: an interleaved scan's MCU holds h x v samples
    of each component, a scan of one component one sample. As
    ``jddiffct.c``, a restart interval must hold whole rows of MCUs; each
    component's rows are undifferenced over its own plane's width, the
    MCUs' padding dropped."""
    ns = body[0]
    predictor, pt = body[1 + 2 * ns], body[3 + 2 * ns] & 15
    if not 1 <= predictor <= 7 or pt > 7:
        raise ValueError(f"{name}: corrupt JPEG: a lossless scan with predictor {predictor}, "
                         f"point transform {pt}")
    comps, tables = [], {}
    for i in range(ns):
        cid, tt = body[1 + 2 * i:3 + 2 * i]
        if cid not in frame.ids:
            raise ValueError(f"{name}: corrupt JPEG: a scan names component {cid}")
        c = frame.ids.index(cid)
        comps.append(c)
        if (0, tt >> 4) not in htables:
            raise ValueError(f"{name}: corrupt JPEG: a scan uses an undefined Huffman table")
        tables[c] = _huffman_table(0, *htables[(0, tt >> 4)])
        frame.scanned[c] = True
    if ns == 1:
        units = [(comps[0], 0, 0)]
        per_row, mcu_rows = frame.comp_size(comps[0])
        hs, vs = {comps[0]: 1}, {comps[0]: 1}
    else:
        units = _mcu_units(frame, comps, name)
        per_row, mcu_rows = frame.mcux, frame.mcuy
        hs, vs = {c: frame.hs[c] for c in comps}, {c: frame.vs[c] for c in comps}
    if restart % per_row:
        raise ValueError(f"{name}: corrupt JPEG: a lossless restart interval of {restart} "
                         f"MCUs, not a multiple of the {per_row} in a row")
    rows = restart // per_row if restart else mcu_rows
    segs, end = _segments(data, pos, name)
    n_int = -(-mcu_rows // rows)
    if len(segs) < n_int:
        raise ValueError(f"{name}: corrupt or truncated JPEG: {len(segs)} restart intervals "
                         f"where {n_int} are needed")
    k = len(units)
    for j in range(n_int):
        m0, m1 = j * rows, min(mcu_rows, (j + 1) * rows)
        d = _lossless_diffs(segs[j], (m1 - m0) * per_row * k, [tables[c] for c, _, _ in units],
                            name).reshape(m1 - m0, per_row, k)
        at = 0
        for c in comps:
            h, v = hs[c], vs[c]
            cw, ch = frame.comp_size(c)
            x = d[:, :, at:at + h * v].reshape(m1 - m0, per_row, v, h).transpose(0, 2, 1, 3)
            x = x.reshape((m1 - m0) * v, per_row * h)[:, :cw]
            at += h * v
            r0 = m0 * v
            if r0 < ch:
                frame.planes[c][r0:r0 + x.shape[0]] = _undifference(x, predictor, pt)[:ch - r0]
    return end
