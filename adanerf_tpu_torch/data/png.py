"""A PNG decoder and encoder on the standard library's ``zlib`` and numpy.

The JAX package decodes its scene images with libpng (``native/
dataloader.cpp``) or imageio, and writes frames with imageio; the machine
that runs the port on the GPU has neither. This decoder reads every PNG
the specification allows: greyscale (colour type 0) at 1, 2, 4, 8 or 16
bits, RGB (2) and RGBA (6) at 8 or 16, palette (3, a PLTE chunk) at 1, 2,
4 or 8, greyscale+alpha (4) at 8 or 16, not interlaced or Adam7
(seven passes, each with its own filtered rows, a pass without rows or
columns holding no bytes), with or without a tRNS chunk. A forbidden
(colour type, bit depth) pair, an unknown compression, filter or
interlace method, a palette image without PLTE, a chunk whose CRC does not
match and a row filter above 4 raise a ``ValueError`` that names them.

It gives two readings, one per JAX reader:

* ``read_png`` / ``read_pngs`` / ``read_image``: what ``imageio.v2.imread``
  (Pillow) gives, shape, dtype and values: greyscale (h, w), ``bool`` at 1
  bit, uint8 scaled to 0-255 at 2, 4 and 8 bits, ``uint16`` at 16;
  greyscale+alpha (h, w, 2), at 16 bits (h, w, 4) RGBA; RGB and RGBA at 16
  bits cut to their high bytes; palette (h, w, 3) RGB; tRNS changes
  nothing. The port's counterparts of the JAX package's ``imageio`` calls
  (``data/llff.py``, ``evaluation/evaluate.py``, ``eval_megakernel.py``)
  read through it.
* ``rgb=True``: the 8-bit RGB bytes (h, w, 3) of ``native/
  dataloader.cpp::decode_png_rgb``'s libpng transformations (16 bits cut
  to the high byte, palette to RGB, greyscale below 8 bits scaled to 8,
  greyscale to RGB; alpha and tRNS dropped, as that loader keeps only RGB),
  which the dataset readers (``data/dataset.py``, ``data/streaming.py``)
  take.

``write_png`` writes 8-bit RGB or RGBA, every row unfiltered.
``read_image`` reads a PNG or a JPEG (``jpeg.py``) by its signature.

The five row filters (None, Sub, Up, Average, Paeth) are undone along
anti-diagonals: pixel (r, x) depends only on (r, x-1), (r-1, x) and
(r-1, x-1), so every pixel with the same r + x is decoded in one numpy
step, h + w - 1 steps per image (per pass), and images of one size and
format share the steps.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .jpeg import decode_jpeg, is_jpeg, probe_jpeg

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_COLOUR_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale+alpha", 6: "RGBA"}
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunks(data: bytes, path: str):
    """(kind, body) of each chunk up to IEND, its CRC checked."""
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: corrupt PNG: the CRC of its {kind.decode('latin-1')!r} "
                             f"chunk does not match")
        yield kind, body
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


class _Png:
    """A PNG file's header, palette and decompressed image data."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(_SIGNATURE):
            raise ValueError(f"{path}: not a PNG file")
        header, idat, self.palette = None, [], None
        for kind, body in _chunks(data, path):
            if kind == b"IHDR":
                header = struct.unpack(">IIBBBBB", body[:13])
            elif kind == b"PLTE":
                self.palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
            elif kind == b"IDAT":
                idat.append(body)
        if header is None:
            raise ValueError(f"{path}: PNG without an IHDR chunk")
        self.w, self.h, self.depth, self.colour, compression, filtering, self.interlace = header
        name = _COLOUR_NAMES.get(self.colour, "unknown")
        if self.depth not in _DEPTHS.get(self.colour, ()) or compression != 0 \
                or filtering != 0 or self.interlace not in (0, 1):
            raise ValueError(
                f"{path}: unsupported PNG format: bit depth {self.depth}, colour type "
                f"{self.colour} ({name}), compression method {compression}, filter method "
                f"{filtering}, interlace {self.interlace}; the PNG specification allows bit "
                f"depths {_DEPTHS.get(self.colour, ())} with this colour type, compression "
                "and filter method 0, interlace 0 or 1")
        if self.colour == 3 and self.palette is None:
            raise ValueError(f"{path}: corrupt PNG: a palette image without a PLTE chunk")
        self.path = path
        self.raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
        self.channels = _CHANNELS[self.colour]
        self.bpp = max(1, self.channels * self.depth // 8)  # filter unit, bytes
        expected = sum(ph * (1 + rb) for *_, ph, rb in self.passes())
        if self.raw.size != expected:
            raise ValueError(f"{path}: PNG data holds {self.raw.size} bytes, expected "
                             f"{expected} for {self.w}x{self.h}")

    def key(self):
        """What a stack of files unfiltered together must share."""
        return self.w, self.h, self.depth, self.colour, self.interlace

    def passes(self):
        """(x0, y0, dx, dy, pass width, pass height, row bytes) of each
        pass that holds pixels: one, or Adam7's non-empty ones."""
        out = []
        for x0, y0, dx, dy in (_ADAM7 if self.interlace else ((0, 0, 1, 1),)):
            pw, ph = -(-max(self.w - x0, 0) // dx), -(-max(self.h - y0, 0) // dy)
            if pw and ph:
                out.append((x0, y0, dx, dy, pw, ph,
                            -(-pw * self.channels * self.depth // 8)))
        return out

    def scanlines(self):
        """Each pass's (pass height, 1 + row bytes) uint8 scanlines."""
        out, pos = [], 0
        for *_, ph, rb in self.passes():
            out.append(self.raw[pos:pos + ph * (1 + rb)].reshape(ph, 1 + rb))
            pos += ph * (1 + rb)
            if out[-1][:, 0].max() > 4:
                raise ValueError(f"{self.path}: unknown PNG row filter {out[-1][:, 0].max()}")
        return out


def _samples(rows: np.ndarray, depth: int, count: int) -> np.ndarray:
    """(..., row bytes) unfiltered bytes -> the row's first ``count``
    samples: uint8 below 16 bits, uint16 at 16 (big-endian)."""
    if depth == 16:
        return (rows[..., 0::2].astype(np.uint16) << 8 | rows[..., 1::2])[..., :count]
    if depth == 8:
        return rows[..., :count]
    per = 8 // depth
    shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
    x = (rows[..., None] >> shifts) & ((1 << depth) - 1)
    return x.reshape(*rows.shape[:-1], -1)[..., :count].astype(np.uint8)


def _decode(pngs) -> list:
    """Each file's (h, w, channels) samples; files of one size and format
    are unfiltered together, pass by pass."""
    groups = {}
    for i, png in enumerate(pngs):
        groups.setdefault(png.key(), []).append(i)
    out = [None] * len(pngs)
    for idx in groups.values():
        first = pngs[idx[0]]
        dtype = np.uint16 if first.depth == 16 else np.uint8
        full = np.zeros((len(idx), first.h, first.w, first.channels), dtype)
        lines = [pngs[i].scanlines() for i in idx]
        for p, (x0, y0, dx, dy, pw, ph, _rb) in enumerate(first.passes()):
            raw = np.stack([lines[j][p] for j in range(len(idx))])
            rows = unfilter(raw, first.bpp).reshape(len(idx), ph, -1)
            full[:, y0::dy, x0::dx] = _samples(rows, first.depth, pw * first.channels) \
                .reshape(len(idx), ph, pw, first.channels)
        for j, i in enumerate(idx):
            out[i] = full[j]
    return out


def _scale(grey: np.ndarray, depth: int) -> np.ndarray:
    """Greyscale of 1, 2 or 4 bits scaled to 0-255 (x 255, 85, 17)."""
    return grey * np.uint8(255 // ((1 << depth) - 1)) if depth < 8 else grey


def _palette(png: _Png, index: np.ndarray) -> np.ndarray:
    """(h, w, 3) RGB of palette indices; an index past the palette reads
    black, as libpng and Pillow read it."""
    table = np.zeros((256, 3), np.uint8)
    table[:len(png.palette)] = png.palette[:256]
    return table[index]


def _imageio_pixels(png: _Png, s: np.ndarray) -> np.ndarray:
    """``imageio.v2.imread``'s array of the samples ``s``."""
    if png.colour == 3:
        return _palette(png, s[..., 0])
    if png.colour == 0:
        if png.depth == 1:
            return s[..., 0] != 0
        return _scale(s[..., 0], png.depth)
    if png.depth == 16:
        s = (s >> 8).astype(np.uint8)
        if png.colour == 4:  # Pillow reads 16-bit greyscale+alpha as RGBA
            return s[..., [0, 0, 0, 1]]
    return s


def _rgb_pixels(png: _Png, s: np.ndarray) -> np.ndarray:
    """``decode_png_rgb``'s 8-bit RGB bytes of the samples ``s``."""
    if png.colour == 3:
        return _palette(png, s[..., 0])
    if png.depth == 16:
        s = (s >> 8).astype(np.uint8)
    if png.colour in (0, 4):
        return np.repeat(_scale(s[..., :1], png.depth), 3, axis=2)
    return s[..., :3]


def read_image(path: str) -> np.ndarray:
    """Decode a PNG or JPEG file, told apart by its signature, not its name:
    ``read_png``'s array for a PNG, ``jpeg.read_jpeg``'s for a JPEG, as
    ``imageio.v2.imread`` gives."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_SIGNATURE):
        return read_png(path)
    if is_jpeg(data):
        return decode_jpeg(data, path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def check_image(path: str):
    """Raise the ValueError that ``read_image`` would raise for a file that
    is not a PNG or JPEG, or a format the port refuses: a JPEG's from its
    headers alone, a PNG's from its chunks."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_SIGNATURE):
        _Png(path)
    elif not is_jpeg(data):
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
    else:
        probe_jpeg(data, path)


def image_format(path: str) -> str:
    """A PNG's or JPEG's format in words, for messages."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_SIGNATURE):
        png = _Png(path)
        return f"{png.depth}-bit {_COLOUR_NAMES[png.colour]} PNG"
    return f"{probe_jpeg(data, path)[2]}-component JPEG"


def require_broadcast(frame: np.ndarray, image: np.ndarray, path: str, where: str):
    """Raise a ValueError naming ``path`` and its format where ``frame -
    image`` does not broadcast: the line of the JAX package named by
    ``where`` fails on that image too."""
    try:
        np.broadcast_shapes(frame.shape, image.shape)
    except ValueError:
        raise ValueError(f"{path}: a {image_format(path)}, read as a {image.shape} array, "
                         f"cannot be compared with the {frame.shape} frame; {where} fails on "
                         "it too") from None


def read_png(path: str, rgb: bool = False) -> np.ndarray:
    """Decode a PNG: ``imageio.v2.imread``'s array, or with ``rgb`` the
    native loader's (h, w, 3) uint8 RGB (see the module docstring)."""
    return read_pngs([path], rgb)[0]


def read_pngs(paths, rgb: bool = False) -> list:
    """``read_png`` of several files; images of one size and format are
    unfiltered together as one stack."""
    pngs = [_Png(p) for p in paths]
    pixels = _rgb_pixels if rgb else _imageio_pixels
    return [pixels(png, s) for png, s in zip(pngs, _decode(pngs))]


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
