"""Tiny numpy rasterizer: lines, rectangles, circles, bitmap text, PNG and
PGM writers (the port's own copy of orb_slam2_2021_tpu/viz/draw.py).

Host code, numpy and zlib only: the visualization works headless (the
upstream C++ system draws with Pangolin and OpenCV windows). All draw_*
functions mutate `img` ([H, W, 3] uint8) in place.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# 5x7 bitmap font: 7 hex bytes per character, one per pixel row top-to-bottom,
# low 5 bits per row, MSB = leftmost pixel.
_FONT = {
    "0": "0E11131519110E", "1": "040C040404040E", "2": "0E11010609101F",
    "3": "1F02040201110E", "4": "02060A121F0202", "5": "1F101E0101110E",
    "6": "0608101E11110E", "7": "1F01020408081008"[:14], "8": "0E11110E11110E",
    "9": "0E11110F01020C",
    "A": "0E11111F111111", "B": "1E11111E11111E", "C": "0E11101010110E",
    "D": "1E11111111111E", "E": "1F10101E10101F", "F": "1F10101E101010",
    "G": "0E1110171110 0E".replace(" ", ""), "H": "1111111F111111",
    "I": "0E04040404040E", "J": "0702020202120C",
    "K": "11121418141211", "L": "1010101010101F",
    "M": "111B1515111111", "N": "11191513111111",
    "O": "0E11111111110E", "P": "1E11111E101010", "Q": "0E11111115120D",
    "R": "1E11111E141211", "S": "0F10100E01011E", "T": "1F040404040404",
    "U": "1111111111110E", "V": "11111111110A04",
    "W": "11111115151B11", "X": "11110A040A1111",
    "Y": "11110A04040404", "Z": "1F01020408101F",
    " ": "00000000000000", ":": "00040400040400", ".": "00000000000C0C",
    ",": "0000000000040408"[:14], "-": "0000001F000000",
    "/": "01010204081010", "%": "19010204081013",
    "=": "00001F001F0000", "(": "02040808080402", ")": "08040202020408",
    "+": "0004041F040400", "_": "0000000000001F",
}


def _glyph(ch: str) -> np.ndarray:
    hexs = _FONT.get(ch.upper())
    if hexs is None:
        hexs = _FONT[" "]
    rows = [int(hexs[i : i + 2], 16) for i in range(0, 14, 2)]
    g = np.zeros((7, 5), bool)
    for r, bits in enumerate(rows):
        for c in range(5):
            g[r, c] = bool((bits >> (4 - c)) & 1)
    return g


def draw_text(img: np.ndarray, text: str, x: int, y: int, color=(255, 255, 255)):
    """Rasterize `text` with the 5x7 font at (x, y) top-left."""
    H, W = img.shape[:2]
    cx = x
    for ch in str(text):
        g = _glyph(ch)
        x0, y0 = cx, y
        x1, y1 = min(cx + 5, W), min(y + 7, H)
        if x0 < W and y0 < H and x1 > max(x0, 0) and y1 > max(y0, 0):
            sub = g[: y1 - y0, : x1 - x0]
            img[y0:y1, x0:x1][sub] = color
        cx += 6


def draw_rect(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color):
    H, W = img.shape[:2]
    x0, x1 = int(max(0, min(x0, x1))), int(min(W - 1, max(x0, x1)))
    y0, y1 = int(max(0, min(y0, y1))), int(min(H - 1, max(y0, y1)))
    if x1 <= x0 or y1 <= y0:
        return
    img[y0, x0 : x1 + 1] = color
    img[y1, x0 : x1 + 1] = color
    img[y0 : y1 + 1, x0] = color
    img[y0 : y1 + 1, x1] = color


def fill_rect(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color):
    H, W = img.shape[:2]
    x0, x1 = int(max(0, x0)), int(min(W, x1))
    y0, y1 = int(max(0, y0)), int(min(H, y1))
    if x1 > x0 and y1 > y0:
        img[y0:y1, x0:x1] = color


def draw_circle(img: np.ndarray, cx: float, cy: float, r: int, color):
    """1px ring of radius r (the reference draws cv::circle radius-2 dots)."""
    H, W = img.shape[:2]
    th = np.linspace(0, 2 * np.pi, max(8, int(8 * r)), endpoint=False)
    xs = np.round(cx + r * np.cos(th)).astype(int)
    ys = np.round(cy + r * np.sin(th)).astype(int)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color


def draw_points(img: np.ndarray, xy: np.ndarray, color, size: int = 1):
    """Batch-plot square dots centered on xy [N, 2] (x, y)."""
    H, W = img.shape[:2]
    if len(xy) == 0:
        return
    xs = np.round(np.asarray(xy[:, 0])).astype(int)
    ys = np.round(np.asarray(xy[:, 1])).astype(int)
    for dy in range(-size + 1, size):
        for dx in range(-size + 1, size):
            x, y = xs + dx, ys + dy
            ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            img[y[ok], x[ok]] = color


def draw_line(img: np.ndarray, x0: float, y0: float, x1: float, y1: float, color):
    """Sampled line segment (dense enough to be gap-free)."""
    H, W = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    t = np.linspace(0.0, 1.0, max(n, 2))
    xs = np.round(x0 + (x1 - x0) * t).astype(int)
    ys = np.round(y0 + (y1 - y0) * t).astype(int)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color


def draw_lines(img: np.ndarray, segs: np.ndarray, color):
    """segs: [N, 4] of (x0, y0, x1, y1)."""
    for x0, y0, x1, y1 in np.asarray(segs, np.float64):
        draw_line(img, x0, y0, x1, y1, color)


def write_png(path: str, img: np.ndarray):
    """Minimal PNG encoder (8-bit RGB or grayscale), no external deps."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if img.dtype != np.uint8 or C not in (1, 3):
        raise ValueError(f"write_png takes uint8 grey or RGB, not {img.dtype} with {C} channels")
    color_type = 0 if C == 1 else 2

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(H))
    out = b"\x89PNG\r\n\x1a\n"
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0))
    out += chunk(b"IDAT", zlib.compress(raw, 6))
    out += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def write_pgm(path: str, img: np.ndarray):
    """Binary PGM (P5) — the format the reference's offline gridmapper emits
    (gridmapper/src/MapProcessor.cpp SaveGridMapKITTI)."""
    img = np.ascontiguousarray(np.asarray(img, np.uint8))
    if img.ndim != 2:
        raise ValueError(f"write_pgm takes a 2-D image, not shape {img.shape}")
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())
