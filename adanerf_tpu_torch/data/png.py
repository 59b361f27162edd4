"""A PNG decoder and encoder on the standard library's ``zlib`` and numpy.

The JAX package decodes its scene images with libpng (``native/
dataloader.cpp``) or imageio, and writes frames with imageio; the machine
that runs the port on the GPU has neither. This decoder reads the formats
the scenes use: 8-bit RGB (colour type 2) and RGBA (colour type 6), not
interlaced. Any other PNG raises a ``ValueError`` that names its format.
``write_png`` writes the same two formats, every row unfiltered.

The five row filters (None, Sub, Up, Average, Paeth) are undone along
anti-diagonals: pixel (r, x) depends only on (r, x-1), (r-1, x) and
(r-1, x-1), so every pixel with the same r + x is decoded in one numpy
step, h + w - 1 steps per image, and images of one size share the steps.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> samples per pixel
_COLOUR_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale+alpha", 6: "RGBA"}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """raw (..., h, 1 + w*bpp) uint8 scanlines, each led by its filter byte,
    for one image or a stack of images of one size -> (..., h, w, bpp)
    uint8 pixels."""
    lead, h = raw.shape[:-2], raw.shape[-2]
    raw = raw.reshape(-1, h, raw.shape[-1])
    n, w = raw.shape[0], (raw.shape[-1] - 1) // bpp
    kinds = raw[:, :, 0].astype(np.int16)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    data = raw[:, :, 1:].reshape(n, h, w, bpp).astype(np.int16)
    # out[:, r + 1, x + 1] holds pixel (r, x); row 0 and column 0 are the
    # zeros the filters read beyond the image
    out = np.zeros((n, h + 1, w + 1, bpp), np.int16)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a = out[:, r + 1, x]       # left
        b = out[:, r, x + 1]       # up
        c = out[:, r, x]           # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = kinds[:, r][..., None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[:, r + 1, x + 1] = (data[:, r, x] + pred) & 0xFF
    return out[:, 1:, 1:].astype(np.uint8).reshape(*lead, h, w, bpp)


def _scanlines(path: str):
    """(raw (h, 1 + w*bpp) uint8, bpp) of an 8-bit RGB or RGBA PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0 \
            or compression != 0 or filtering != 0:
        raise ValueError(
            f"{path}: unsupported PNG format: bit depth {depth}, colour type {colour} "
            f"({_COLOUR_NAMES.get(colour, 'unknown')}), interlace {interlace}; "
            "the decoder reads 8-bit RGB or RGBA, not interlaced")
    bpp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected "
                         f"{h * (1 + w * bpp)} for {w}x{h}")
    return raw.reshape(h, 1 + w * bpp), bpp


def refuse_jpegs(directory: str, names):
    """Raise ValueError naming the JPEG files among ``names`` (in
    ``directory``): the port decodes PNG only (ROADMAP Queue 1, item 19)."""
    jpegs = [n for n in names if n.lower().endswith((".jpg", ".jpeg"))]
    if jpegs:
        raise ValueError(f"{directory}: JPEG images ({', '.join(jpegs[:3])}"
                         f"{', ...' if len(jpegs) > 3 else ''}) need a JPEG decoder, which the "
                         "port does not have yet (ROADMAP Queue 1, item 19); convert them to PNG")


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB or RGBA PNG to (h, w, 3 or 4) uint8."""
    raw, bpp = _scanlines(path)
    return unfilter(raw, bpp)


def read_pngs(paths) -> list:
    """Decode several PNGs; images of one size and format are unfiltered
    together as one stack."""
    lines = [_scanlines(p) for p in paths]
    groups = {}
    for i, (raw, bpp) in enumerate(lines):
        groups.setdefault((raw.shape, bpp), []).append(i)
    out = [None] * len(lines)
    for (_shape, bpp), idx in groups.items():
        pixels = unfilter(np.stack([lines[i][0] for i in idx]), bpp)
        for i, img in zip(idx, pixels):
            out[i] = img
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray):
    """Write (h, w, 3 or 4) uint8 pixels as an 8-bit RGB or RGBA PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"write_png takes (h, w, 3 or 4) uint8 pixels, got "
                         f"{img.shape} {img.dtype}")
    h, w, bpp = img.shape
    colour = {3: 2, 4: 6}[bpp]
    raw = np.zeros((h, 1 + w * bpp), np.uint8)  # filter byte 0: None
    raw[:, 1:] = img.reshape(h, w * bpp)
    data = (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
