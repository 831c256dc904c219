"""Seeded images at the shapes and colour types of the reference's suite.

The reference tool ships eleven photographs in suite/ (its run_suite.sh
compresses each at strengths 1-99). They are not part of this repository,
so tests, the benchmark and the chip check make stand-ins from a seed: the
same names, sizes and PNG colour types, with photo-like content built from

  * smooth fields: a gradient plus a few low-frequency sinusoids per channel,
  * edges: flat-coloured rectangles and discs laid over the field,
  * noise: Gaussian grain of a few levels,
  * alpha (RGBA images): an opaque body, a fully transparent disc and a
    soft ramp between them, so the transparent-pixel rule is exercised.

Palette images take their colours from a 6x6x6 cube, so they stay within
256 entries. PNGs are written by a minimal encoder here (filter 0, zlib
level 6), independent of the codec under test.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# (name, width, height, kind) of the reference suite (IHDR-verified sizes)
SUITE = (
    ("barbara.png", 512, 512, "gray"),
    ("david.png", 180, 215, "gray"),
    ("dice.png", 800, 600, "rgba"),
    ("girl.png", 755, 503, "rgb"),
    ("lena.png", 512, 512, "rgb"),
    ("parrots.png", 768, 512, "rgb"),
    ("redbrush.png", 512, 480, "rgba"),
    ("rose.png", 70, 46, "rgb"),
    ("ssr.png", 900, 645, "gray"),
    ("tenko.png", 554, 382, "rgb"),
    ("tux.png", 265, 314, "palette"),
)
KINDS = ("gray", "gray_alpha", "rgb", "rgba", "palette")
_COLOR_TYPE = {"gray": 0, "rgb": 2, "palette": 3, "gray_alpha": 4, "rgba": 6}


def synth_rgba(h: int, w: int, kind: str = "rgb", seed: int = 0,
               noise: float | None = None) -> np.ndarray:
    """A photo-like (h, w, 4) uint8 image of the given kind. noise is the
    grain's standard deviation (default: drawn from 1.5-4 levels)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}")
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 1.0, w)[None, :]
    img = np.empty((h, w, 3))
    for c in range(3):
        gx, gy = rng.uniform(-60, 60, 2)
        field = 128 + gx * (x - 0.5) + gy * (y - 0.5)
        for _ in range(3):
            fx, fy = rng.uniform(0.5, 4.0, 2)
            amp, phase = rng.uniform(10, 40), rng.uniform(0, 2 * np.pi)
            field = field + amp * np.sin(2 * np.pi * (fx * x + fy * y) + phase)
        img[:, :, c] = field
    for _ in range(int(rng.integers(4, 9))):
        color = rng.uniform(0, 255, 3)
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(0.05, 0.25) * h, rng.uniform(0.05, 0.25) * w
        if rng.random() < 0.5:
            mask = (np.abs(y * (h - 1) - cy) < ry) & (np.abs(x * (w - 1) - cx) < rx)
        else:
            mask = ((y * (h - 1) - cy) / ry) ** 2 + ((x * (w - 1) - cx) / rx) ** 2 < 1
        img[mask] = color
    sigma = rng.uniform(1.5, 4.0)
    img += rng.normal(0.0, sigma if noise is None else noise, img.shape)
    rgb = np.clip(np.rint(img), 0, 255).astype(np.uint8)

    out = np.empty((h, w, 4), np.uint8)
    out[:, :, :3] = rgb
    out[:, :, 3] = 255
    if kind in ("gray", "gray_alpha"):
        out[:, :, 0] = out[:, :, 2] = out[:, :, 1]
    if kind == "palette":
        out[:, :, :3] = (rgb // 43) * 51
    if kind in ("rgba", "gray_alpha"):
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        r = np.hypot(y * (h - 1) - cy, x * (w - 1) - cx) / (0.25 * min(h, w) + 1)
        out[:, :, 3] = np.clip(np.rint((r - 1.0) * 255), 0, 255).astype(np.uint8)
    return out


def _chunk(name: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + name + data
            + struct.pack(">I", zlib.crc32(name + data) & 0xFFFFFFFF))


def encode_png(rgba: np.ndarray, kind: str) -> bytes:
    """A plain 8-bit PNG of `rgba` in the colour type of `kind`."""
    h, w = rgba.shape[:2]
    plte = b""
    if kind == "gray":
        px = rgba[:, :, 1:2]
    elif kind == "gray_alpha":
        px = rgba[:, :, (1, 3)]
    elif kind == "rgb":
        px = rgba[:, :, :3]
    elif kind == "rgba":
        px = rgba
    else:
        colors, index = np.unique(
            rgba[:, :, :3].reshape(-1, 3), axis=0, return_inverse=True)
        if len(colors) > 256:
            raise ValueError("palette image has more than 256 colours")
        plte = _chunk(b"PLTE", colors.astype(np.uint8).tobytes())
        px = index.reshape(h, w, 1).astype(np.uint8)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(px).reshape(h, -1)],
        axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[kind], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + plte
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def suite_image(name: str, seed: int = 0) -> bytes:
    """The stand-in PNG for one suite file name."""
    for i, (n, w, h, kind) in enumerate(SUITE):
        if n == name:
            return encode_png(synth_rgba(h, w, kind, seed * 100 + i), kind)
    raise KeyError(name)


def suite_corpus(seed: int = 0) -> dict[str, bytes]:
    """All eleven stand-ins: {file name: PNG bytes}."""
    return {name: suite_image(name, seed) for name, _, _, _ in SUITE}


def write_suite(directory: str, seed: int = 0) -> list[str]:
    """Write the stand-ins into `directory`; returns their paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for name, data in suite_corpus(seed).items():
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(data)
        paths.append(path)
    return paths
