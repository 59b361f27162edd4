"""A sequential JPEG decoder in numpy, the port's counterpart of
``imageio.v2.imread`` on a JPEG file (imageio reads it through PIL, which
decodes with libjpeg-turbo); the machine that runs the port on the GPU has
neither.

Formats: baseline and extended sequential Huffman DCT (SOF0, SOF1), 8-bit
samples, 1 component (greyscale, returned (h, w) uint8) or 3 (YCbCr, or
RGB under an Adobe transform 0 or 'R', 'G', 'B' component ids; returned
(h, w, 3) uint8), sampling factors 1 or 2 against the largest (4:4:4,
4:2:2, 4:2:0, 4:4:0), interleaved or one scan per component, restart
intervals (DRI), 8- or 16-bit quantization tables. APPn and COM segments
are skipped, EXIF included; as imageio, no EXIF orientation is applied.
Progressive, lossless, hierarchical and arithmetic-coded files and 12-bit
samples raise a ``ValueError`` that names the format (the JAX package reads
progressive files: ROADMAP Queue 1, item 21), and so does a file that ends
inside its entropy-coded data (PIL refuses a truncated file too).

The pixels are libjpeg-turbo's under its defaults: the integer "islow"
inverse DCT (``jidctint.c``), fancy (triangle) upsampling of 2x chroma
(``jdsample.c``: h2v1 and h2v2 only on planes wider than 2 samples, box
replication otherwise; h1v2 always) and the fixed-point YCbCr -> RGB
tables of ``jdcolor.c``, so they equal PIL's.

The Huffman decode is the one sequential part. It reads each restart
interval's unstuffed bytes through 64-bit windows (one per byte offset,
built in numpy a chunk at a time) and a 65,536-entry lookahead table per
Huffman table, which gives for the next 16 bits the code's length, the
AC run and, where code and value bits fit in the 16, the decoded
coefficient, so most coefficients cost one table lookup. Dequantization,
the IDCT, upsampling and colour conversion run in numpy over all blocks.
"""

from __future__ import annotations

import functools
import re
import struct
from array import array

import numpy as np

_ITEM = "ROADMAP Queue 1, item 21"
# zigzag position k -> natural (row-major) index of the 8x8 block
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_NATURAL = np.argsort(_ZIGZAG)  # natural index -> zigzag position
_REFUSED = {
    0xC2: "progressive DCT (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential DCT (SOF5, hierarchical)",
    0xC6: "differential progressive DCT (SOF6, hierarchical)",
    0xC7: "differential lossless (SOF7, hierarchical)",
    0xC9: "arithmetic-coded sequential DCT (SOF9)",
    0xCA: "arithmetic-coded progressive DCT (SOF10)",
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
    """Decode a JPEG file: (h, w, 3) uint8 RGB, or (h, w) for greyscale."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def _refuse(name, what):
    raise ValueError(f"{name}: unsupported JPEG format: {what}. The port decodes baseline and "
                     f"extended sequential Huffman JPEG with 8-bit samples; the JAX package "
                     f"reads this file through imageio ({_ITEM})")


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


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg's integer IDCT: (n, 64) natural-order coefficients and the
    (64,) natural-order quantization table -> (n, 8, 8) uint8 samples."""
    x = coefs.astype(np.int64).reshape(-1, 8, 8) * quant.astype(np.int64).reshape(8, 8)
    cols = _idct_1d([x[:, k, :] for k in range(8)])  # pass 1 down the columns
    ws = np.stack([(c + (1 << 10)) >> 11 for c in cols], axis=1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])  # pass 2 along the rows
    out = np.stack([(r + (1 << 17)) >> 18 for r in rows], axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a (h, w) component plane by fh x fv
    (each 1 or 2): fancy (triangle, edge-replicated) for h2v1 and h2v2 on
    planes wider than 2 samples and for h1v2, box replication otherwise."""
    if fh == 1 and fv == 1:
        return plane
    x = plane.astype(np.int32)
    h, w = x.shape
    if fh == 2 and w <= 2:  # jdsample.c: h2v1_upsample / h2v2_upsample
        return np.repeat(np.repeat(plane, fv, axis=0), 2, axis=1)
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
    def __init__(self, body: bytes, name: str, allocate: bool = True):
        precision, self.h, self.w, n = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            _refuse(name, f"{precision}-bit samples")
        if n not in (1, 3):
            _refuse(name, f"{n} components")
        if self.h == 0 or self.w == 0:
            _refuse(name, "a height set by a DNL marker" if self.h == 0 else "width 0")
        self.ids, self.hs, self.vs, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            self.ids.append(cid)
            self.hs.append(hv >> 4)
            self.vs.append(hv & 15)
            self.tq.append(tq)
        if n == 1:  # a single component's MCU is one block whatever its factors
            self.hs, self.vs = [1], [1]
        self.hmax, self.vmax = max(self.hs), max(self.vs)
        for h, v in zip(self.hs, self.vs):
            if self.hmax not in (h, 2 * h) or self.vmax not in (v, 2 * v):
                _refuse(name, f"sampling factors {list(zip(self.hs, self.vs))} (the decoder "
                              "upsamples by 1 or 2)")
        self.mcux = -(-self.w // (8 * self.hmax))
        self.mcuy = -(-self.h // (8 * self.vmax))
        self.coefs = [array("h", bytes(2 * 64 * self.mcux * h * self.mcuy * v))
                      for h, v in zip(self.hs, self.vs)] if allocate else None
        self.quant = [None] * n
        self.scanned = [False] * n

    def comp_size(self, c):
        """(width, height) in samples of component c's plane."""
        return (-(-self.w * self.hs[c] // self.hmax), -(-self.h * self.vs[c] // self.vmax))


def _scan_blocks(frame: _Frame, comps):
    """(component, coefficient offset) of every block of a scan in order."""
    if len(comps) == 1:  # non-interleaved: the component's own blocks
        c = comps[0]
        cw, ch = frame.comp_size(c)
        bx, by = -(-cw // 8), -(-ch // 8)
        stride = frame.mcux * frame.hs[c]
        offs = ((np.arange(by)[:, None] * stride + np.arange(bx)[None, :]) * 64).ravel()
        return [(c, o) for o in offs.tolist()], 1
    per_mcu = []
    for c in comps:
        for dy in range(frame.vs[c]):
            for dx in range(frame.hs[c]):
                per_mcu.append((c, dy, dx))
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


def probe_jpeg(data: bytes, name: str = "<bytes>"):
    """(height, width, components) from a JPEG's frame header, raising the
    decoder's ValueError for a format it refuses; nothing is decoded."""
    if not is_jpeg(data):
        raise ValueError(f"{name}: not a JPEG file")
    pos = 2
    while True:
        marker, body, pos = _next_segment(data, pos, name)
        if marker in _REFUSED:
            _refuse(name, _REFUSED[marker])
        if marker in (0xC0, 0xC1):
            frame = _Frame(body, name, allocate=False)
            return frame.h, frame.w, len(frame.ids)
        if marker in (0xD9, 0xDA):
            raise ValueError(f"{name}: corrupt JPEG: no frame header before the scan")


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a JPEG file's bytes (see the module docstring): (h, w, 3)
    uint8 RGB, or (h, w) uint8 for greyscale."""
    if not is_jpeg(data):
        raise ValueError(f"{name}: not a JPEG file")
    qtables, htables = {}, {}
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
        elif marker == 0xCC:
            _refuse(name, "arithmetic coding (DAC)")
        elif marker in (0xC0, 0xC1):
            if frame is not None:
                raise ValueError(f"{name}: corrupt JPEG: two frames")
            frame = _Frame(body, name)
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                total = sum(counts)
                htables[(tc, th)] = (counts, body[i + 17:i + 17 + total])
                i += 17 + total
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
            pos = _scan(data, pos, body, frame, qtables, htables, restart, name)
        # APPn, COM and other segments: skipped
    if frame is None or not all(frame.scanned):
        raise ValueError(f"{name}: corrupt JPEG: no frame, or a component without a scan")
    planes = []
    for c in range(len(frame.ids)):
        cw, ch = frame.comp_size(c)
        bx, by = frame.mcux * frame.hs[c], frame.mcuy * frame.vs[c]
        zz = np.frombuffer(frame.coefs[c], np.int16).reshape(-1, 64)
        pix = np.concatenate([idct_islow(zz[i:i + 16384][:, _NATURAL], frame.quant[c])
                              for i in range(0, zz.shape[0], 16384)])
        plane = pix.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        plane = _upsample(plane[:ch, :cw], frame.hmax // frame.hs[c], frame.vmax // frame.vs[c])
        planes.append(plane[:frame.h, :frame.w])
    if len(planes) == 1:
        return planes[0]
    rgb = adobe == 0 if not jfif and adobe is not None else (
        not jfif and adobe is None and frame.ids == [82, 71, 66])
    if rgb:
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)


def _scan(data, pos, body, frame: _Frame, qtables, htables, restart, name) -> int:
    """Decode the scan whose header is ``body`` and whose data starts at
    ``pos``; returns the offset of the marker after it."""
    ns = body[0]
    comps, tables = [], {}
    for i in range(ns):
        cid, tt = body[1 + 2 * i:3 + 2 * i]
        if cid not in frame.ids:
            raise ValueError(f"{name}: corrupt JPEG: a scan names component {cid}")
        c = frame.ids.index(cid)
        comps.append(c)
        td, ta = tt >> 4, tt & 15
        if (0, td) not in htables or (1, ta) not in htables:
            raise ValueError(f"{name}: corrupt JPEG: a scan uses an undefined Huffman table")
        if frame.tq[c] not in qtables:
            raise ValueError(f"{name}: corrupt JPEG: undefined quantization table")
        frame.quant[c] = qtables[frame.tq[c]]
        frame.scanned[c] = True
        dc, dcsym = _huffman_table(0, *htables[(0, td)])
        ac, acsym = _huffman_table(1, *htables[(1, ta)])
        tables[c] = (dc, ac, dcsym, acsym)
    ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
    if ss != 0 or se != 63:
        _refuse(name, f"a spectral-selection scan ({ss}..{se})")
    segs, end = _segments(data, pos, name)
    blocks, per_mcu = _scan_blocks(frame, comps)
    step = restart * per_mcu if restart else len(blocks)
    n_int = -(-len(blocks) // step)
    if len(segs) < n_int:
        raise ValueError(f"{name}: corrupt or truncated JPEG: {len(segs)} restart intervals "
                         f"where {n_int} are needed")
    try:
        for j in range(n_int):
            _decode_interval(segs[j], blocks[j * step:(j + 1) * step], tables,
                             frame.coefs, name)
    except (IndexError, OverflowError) as err:
        raise ValueError(f"{name}: corrupt JPEG: {err}") from None
    return end
