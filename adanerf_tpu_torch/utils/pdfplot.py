"""Line plots written as PDF files by hand, for the trainer's
``epoch_*.pdf`` training-stat plots (the JAX package draws them with pandas
and matplotlib, which the GPU machine lacks).

One page of matplotlib's default size (6.4 x 4.8 in) and axes box: a
framed plot area, ticks at round steps (1, 2, 2.5 or 5 times a power of
ten) with their labels, the x column's name under the axis, one polyline
a series in matplotlib's default colour cycle, and a legend in the upper
right corner. Text is set in Helvetica, one of the PDF base-14 fonts, so
no font is embedded; the content stream is uncompressed. Non-finite
values break a series' line.

The file is drawn in this order: the frame (``re``), each x tick (a
2-point path, then its label), each y tick (likewise), the x label, each
series (its colour, then its paths), the legend. ``read_plot`` parses
such a file back (header, cross-reference table, trailer, the drawing),
for the tests and the card's smoke run.
"""

from __future__ import annotations

import math
import re

WIDTH, HEIGHT = 460.8, 345.6  # points: 6.4 x 4.8 inches
AXES = (0.125, 0.11, 0.775, 0.77)  # left, bottom, width, height, in page fractions
COLOURS = ["1f77b4", "ff7f0e", "2ca02c", "d62728", "9467bd", "8c564b"]
FONT_SIZE = 10.0
# Helvetica advance widths (per 1000 em) of the characters labels use
_WIDTHS = dict(zip("0123456789", [556] * 10))
_WIDTHS.update({".": 278, "-": 333, "+": 584, "_": 556, " ": 278, "a": 556, "b": 556,
                "c": 500, "d": 556, "e": 556, "f": 278, "g": 556, "h": 556, "i": 222,
                "j": 222, "k": 500, "l": 222, "m": 833, "n": 556, "o": 556, "p": 556,
                "q": 556, "r": 333, "s": 500, "t": 278, "u": 556, "v": 500, "w": 722,
                "x": 500, "y": 500, "z": 500})


def text_width(s: str, size: float = FONT_SIZE) -> float:
    return sum(_WIDTHS.get(ch, 667) for ch in s) * size / 1000.0


def nice_ticks(lo: float, hi: float, most: int = 8):
    """Ticks at a round step within [lo, hi] (at most ``most`` + 1), and
    the decimals that print the step exactly."""
    span = hi - lo
    mag = 10.0 ** math.floor(math.log10(span / most))
    for m in (1, 2, 2.5, 5, 10):
        step = m * mag
        if span / step <= most:
            break
    first = math.ceil(lo / step - 1e-9)
    ticks = []
    while (first + len(ticks)) * step <= hi + 1e-9 * span:
        ticks.append((first + len(ticks)) * step)
    decimals = max(0, -math.floor(math.log10(step) + 1e-12) + (1 if m == 2.5 else 0))
    return ticks, decimals


def limits(values, margin: float):
    """(lo, hi) of the finite ``values``, widened by ``margin`` of the span
    on each side; a single value gets a span of 1 (or of its own size)."""
    vals = [v for v in values if math.isfinite(v)]
    if not vals:
        return 0.0, 1.0
    lo, hi = min(vals), max(vals)
    if hi == lo:
        half = 0.5 * (abs(lo) or 1.0)
        return lo - half, hi + half
    pad = margin * (hi - lo)
    return lo - pad, hi + pad


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def _text(x: float, y: float, s: str) -> str:
    return f"BT /F1 {FONT_SIZE:g} Tf {x:.2f} {y:.2f} Td ({_escape(s)}) Tj ET"


def _label(v: float, decimals: int) -> str:
    s = f"{v:.{decimals}f}"
    return s[1:] if s.startswith("-") and float(s) == 0 else s


def line_plot(path: str, x, series, xlabel: str = ""):
    """Write a PDF line plot of ``series`` (a list of (name, values), each
    as long as ``x``) against ``x`` to ``path``."""
    fx, fy = AXES[0] * WIDTH, AXES[1] * HEIGHT
    fw, fh = AXES[2] * WIDTH, AXES[3] * HEIGHT
    x0, x1 = limits(x, 0.0)
    y0, y1 = limits([v for _, vals in series for v in vals], 0.05)

    def px(v):
        return fx + (v - x0) / (x1 - x0) * fw

    def py(v):
        return fy + (v - y0) / (y1 - y0) * fh

    ops = ["0 0 0 RG 0 0 0 rg 0.8 w", f"{fx:.2f} {fy:.2f} {fw:.2f} {fh:.2f} re S"]
    ticks, dec = nice_ticks(x0, x1)
    for t in ticks:
        s = _label(t, dec)
        ops.append(f"{px(t):.2f} {fy:.2f} m {px(t):.2f} {fy - 3.5:.2f} l S")
        ops.append(_text(px(t) - text_width(s) / 2, fy - 3.5 - 3.5 - FONT_SIZE * 0.75, s))
    ticks, dec = nice_ticks(y0, y1)
    for t in ticks:
        s = _label(t, dec)
        ops.append(f"{fx:.2f} {py(t):.2f} m {fx - 3.5:.2f} {py(t):.2f} l S")
        ops.append(_text(fx - 3.5 - 3.5 - text_width(s), py(t) - FONT_SIZE * 0.35, s))
    if xlabel:
        ops.append(_text(fx + fw / 2 - text_width(xlabel) / 2, fy - 34.0, xlabel))
    ops.append("1.5 w 1 J 1 j")
    for i, (_name, vals) in enumerate(series):
        colour = COLOURS[i % len(COLOURS)]
        rgb = " ".join(f"{int(colour[k:k + 2], 16) / 255:.4f}" for k in (0, 2, 4))
        ops.append(f"{rgb} RG")
        run = []
        for xv, yv in list(zip(x, vals)) + [(math.nan, math.nan)]:
            if math.isfinite(xv) and math.isfinite(yv):
                run.append(f"{px(xv):.2f} {py(yv):.2f}")
                continue
            if run:
                ops.append(" ".join([run[0] + " m"] + [p + " l" for p in run[1:]]) + " S")
            run = []
    # legend: a line sample and the name for each series, upper right
    row = FONT_SIZE * 1.4
    box_w = 10 + 20 + 5 + max([text_width(n) for n, _ in series] or [0]) + 8
    bx, by = fx + fw - box_w - 6, fy + fh - 6 - row * len(series) - 6
    ops.append(f"0.8 w 0.8 0.8 0.8 RG {bx:.2f} {by:.2f} {box_w:.2f} "
               f"{row * len(series) + 6:.2f} re S")
    for i, (name, _vals) in enumerate(series):
        colour = COLOURS[i % len(COLOURS)]
        rgb = " ".join(f"{int(colour[k:k + 2], 16) / 255:.4f}" for k in (0, 2, 4))
        ly = fy + fh - 6 - row * (i + 0.5) - 3
        ops.append(f"1.5 w {rgb} RG {bx + 8:.2f} {ly:.2f} m {bx + 28:.2f} {ly:.2f} l S")
        ops.append(_text(bx + 33, ly - FONT_SIZE * 0.35, name))
    content = "\n".join(ops).encode("latin-1")
    objects = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {WIDTH:g} {HEIGHT:g}] "
         f"/Resources << /Font << /F1 5 0 R >> >> /Contents 4 0 R >>").encode(),
        b"<< /Length %d >>\nstream\n" % len(content) + content + b"\nendstream",
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
        b"/Encoding /WinAnsiEncoding >>",
    ]
    out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = []
    for i, body in enumerate(objects, start=1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objects) + 1)
    for off in offsets:
        out += b"%010d 00000 n \n" % off
    out += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objects) + 1, xref))
    with open(path, "wb") as f:
        f.write(bytes(out))


_TOKEN = re.compile(rb"\((?:\\.|[^\\)])*\)|/[A-Za-z0-9]+|[-+]?[0-9]*\.?[0-9]+|[A-Za-z*']+")


def read_plot(path: str) -> list:
    """Parse a PDF ``line_plot`` wrote: check the header, that every
    cross-reference entry points at its object, the trailer and the
    content stream's length, and return the drawing in order as
    ("rect", x, y, w, h), ("path", (r, g, b), [(x, y), ...]) and
    ("text", x, y, string) items. Raises ValueError on a malformed file."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"%PDF-1."):
        raise ValueError(f"{path}: no PDF header")
    tail = re.search(rb"startxref\s+(\d+)\s+%%EOF\s*$", data)
    if tail is None:
        raise ValueError(f"{path}: no startxref / %%EOF at the end")
    xref = int(tail.group(1))
    head = re.match(rb"xref\s+0 (\d+)\s+", data[xref:])
    if head is None:
        raise ValueError(f"{path}: startxref does not point at an xref table")
    n = int(head.group(1))
    table = data[xref + head.end():xref + head.end() + 20 * n]
    for i in range(1, n):
        off = int(table[20 * i:20 * i + 10])
        if not data[off:].startswith(b"%d 0 obj" % i):
            raise ValueError(f"{path}: xref entry {i} does not point at object {i}")
    trailer = re.search(rb"trailer\s*<<(.*?)>>", data[xref:], re.S)
    if trailer is None or b"/Size %d" % n not in trailer.group(1) \
            or b"/Root 1 0 R" not in trailer.group(1):
        raise ValueError(f"{path}: bad trailer")
    stream = re.search(rb"<< /Length (\d+) >>\nstream\n", data)
    if stream is None:
        raise ValueError(f"{path}: no content stream")
    content = data[stream.end():stream.end() + int(stream.group(1))]
    if not data[stream.end() + len(content):].startswith(b"\nendstream"):
        raise ValueError(f"{path}: the content stream's length is wrong")
    items, args, colour, points, at = [], [], (0.0, 0.0, 0.0), [], (0.0, 0.0)
    for tok in _TOKEN.findall(content):
        if tok[:1] in b"(/" or tok[:1].isdigit() or tok[:1] in b"-+.":
            args.append(tok)
            continue
        op = tok.decode()
        nums = [float(a) for a in args if a[:1] not in b"(/"]
        if op == "RG":
            colour = tuple(nums[-3:])
        elif op == "re":
            items.append(("rect", *nums[-4:]))
        elif op == "m":
            points = [tuple(nums[-2:])]
        elif op == "l":
            points.append(tuple(nums[-2:]))
        elif op == "S":
            if points:
                items.append(("path", colour, points))
            points = []
        elif op == "Td":
            at = tuple(nums[-2:])
        elif op == "Tj":
            s = args[-1][1:-1].decode("latin-1")
            items.append(("text", *at, re.sub(r"\\(.)", r"\1", s)))
        args = []
    return items
