"""A PNG writer for every colour type, bit depth, interlace and tRNS form
that the PNG specification allows, on numpy and the standard library's
``zlib``: the files the port's PNG decoder is held to.

``encode(samples, colour, depth, ...)`` returns a file's bytes:

* ``samples``: (h, w) for greyscale (colour type 0) and palette indices
  (3), (h, w, 2) greyscale+alpha (4), (h, w, 3) RGB (2), (h, w, 4) RGBA
  (6); integers below ``2 ** depth``;
* ``interlace`` 0 (none) or 1 (Adam7: seven passes, each a sub-image with
  its own filtered rows; a pass without rows or columns writes nothing);
* ``palette`` (n, 3) RGB bytes for colour type 3, ``trns`` the tRNS chunk's
  value: one grey level (type 0), an (r, g, b) triple (type 2) or up to n
  alpha bytes (type 3);
* ``filters``: each row's filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
  cycles through this sequence, over the passes' rows in turn.

``reencode(img, form)`` writes an (h, w, 3) uint8 image losslessly as
``"rgb16"`` (16-bit RGB, each value v stored as 257 * v, whose high byte is
v) or ``"adam7"`` (8-bit RGB, Adam7-interlaced).

``fixtures()`` names the files ``tests/torch_fixtures/png/`` holds (written
by ``tests/make_png_fixtures.py``): every legal (colour type, bit depth) x
interlace 0/1 x tRNS where the colour type takes one, at 13x11, and Adam7
images of 1x1, 7x5, 3x2 and 4x1 whose later passes are partly or wholly
empty. The module imports numpy and the standard library only, so the
port's GPU smoke run can use it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w * channels) sample rows -> (h, row bytes) uint8, big-endian,
    sub-byte samples packed from the most significant bit, each row padded
    to a whole byte."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    padded = np.zeros((h, -(-n // per) * per), np.uint8)
    padded[:, :n] = samples
    groups = padded.reshape(h, -1, per)
    shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
    return (groups << shifts).sum(axis=2).astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """Filter (h, row bytes) uint8 rows, row r with ``kinds[r]``; returns
    the scanlines, each led by its filter byte."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for r, kind in zip(range(rows.shape[0]), kinds):
        x = rows[r].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


def encode(samples, colour: int, depth: int, interlace: int = 0, palette=None, trns=None,
           filters=(0, 1, 2, 3, 4), level: int = 6) -> bytes:
    samples = np.asarray(samples)
    if depth not in DEPTHS[colour]:
        raise ValueError(f"bit depth {depth} is not allowed with colour type {colour}")
    h, w = samples.shape[:2]
    channels = CHANNELS[colour]
    flat = samples.reshape(h, w, channels)
    bpp = max(1, channels * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data, row = [], 0
    for x0, y0, dx, dy in passes:
        sub = flat[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        packed = _pack_rows(sub.reshape(sub.shape[0], -1), depth)
        kinds = [filters[(row + r) % len(filters)] for r in range(packed.shape[0])]
        row += packed.shape[0]
        data.append(_filter(packed, bpp, kinds))
    body = [chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))]
    if palette is not None:
        body.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        if colour == 3:
            body.append(chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes()))
        else:
            body.append(chunk(b"tRNS", np.asarray(trns, ">u2").tobytes()))
    body.append(chunk(b"IDAT", zlib.compress(b"".join(data), level)))
    return SIGNATURE + b"".join(body) + chunk(b"IEND", b"")


def reencode(img: np.ndarray, form: str) -> bytes:
    """An (h, w, 3) uint8 image as 16-bit RGB (``"rgb16"``) or Adam7 8-bit
    RGB (``"adam7"``), both lossless."""
    if form == "rgb16":
        return encode(img.astype(np.uint16) * 257, 2, 16)
    if form == "adam7":
        return encode(img, 2, 8, interlace=1)
    raise ValueError(f"unknown form {form!r}")


def seeded(colour: int, depth: int, h: int, w: int, seed: int, palette_size: int = 0):
    """Seeded samples of one format: uniform over the depth's range
    (palette indices over ``palette_size`` entries), with a run of equal
    pixels in the top left so that a tRNS key matches somewhere."""
    rng = np.random.default_rng(seed)
    top = palette_size if colour == 3 else 1 << depth
    x = rng.integers(0, top, (h, w, CHANNELS[colour]), dtype=np.int64)
    x[:2, :3] = x[0, 0]
    return x[..., 0] if CHANNELS[colour] == 1 else x


def cases():
    """Every legal (colour type, bit depth) x interlace 0/1 x tRNS where
    the colour type takes one, as (name, kwargs of ``encode``)."""
    out = []
    for colour, depths in DEPTHS.items():
        for depth in depths:
            for interlace in (0, 1):
                for trns in ((False, True) if colour in (0, 2, 3) else (False,)):
                    name = f"c{colour}_d{depth}_i{interlace}" + ("_trns" if trns else "")
                    out.append((name, dict(colour=colour, depth=depth, interlace=interlace,
                                           trns=trns)))
    return out


def case_file(colour: int, depth: int, interlace: int, trns: bool, h: int = 13, w: int = 11,
              seed: int = 0) -> bytes:
    """One case's file at (h, w) from ``seed``: a palette of 2 ** depth
    entries (200 at depth 8), a palette's tRNS chunk one entry shorter than
    the palette, another tRNS key the top-left pixel's value."""
    n = (1 << depth if depth < 8 else 200) if colour == 3 else 0
    x = seeded(colour, depth, h, w, seed, n)
    rng = np.random.default_rng(seed + 1000)
    palette = rng.integers(0, 256, (n, 3), dtype=np.int64) if colour == 3 else None
    key = None
    if trns:
        if colour == 3:
            key = rng.integers(0, 256, max(1, n - 1), dtype=np.int64)
        elif colour == 0:
            key = [int(x[0, 0])]
        else:
            key = [int(v) for v in x[0, 0]]
    return encode(x, colour, depth, interlace, palette=palette, trns=key)


def fixtures():
    """name -> (kwargs of ``case_file``) of every committed fixture."""
    out = {name: dict(kw, h=13, w=11, seed=i) for i, (name, kw) in enumerate(cases())}
    for i, (colour, depth, h, w) in enumerate([(2, 8, 1, 1), (0, 1, 1, 1), (3, 2, 7, 5),
                                               (6, 16, 7, 5), (4, 8, 3, 2), (0, 4, 4, 1)]):
        out[f"c{colour}_d{depth}_i1_{h}x{w}"] = dict(colour=colour, depth=depth, interlace=1,
                                                    trns=False, h=h, w=w, seed=100 + i)
    return out
