"""End-to-end byte parity vs the C tool on exotic PNG input formats.

These exercise the decode normalization pipeline (16-bit strip, Adam7
de-interlacing, palette/tRNS expansion, gray tRNS alpha, sub-8-bit gray)
against rwpng.c's libpng transform stack — the encoder side is already
covered elsewhere.
"""

import struct
import zlib

import numpy as np
import pytest

from pngloss_jax.cli import run
from tests.conftest import run_oracle
import io


def _chunk(name: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + name + body
            + struct.pack(">I", zlib.crc32(name + body) & 0xFFFFFFFF))


def _write_png(width, height, bit_depth, color_type, raw_scanlines,
               palette=None, trns=None, interlace=0) -> bytes:
    """Minimal PNG writer for crafting test inputs (filter 0 rows)."""
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, bit_depth, color_type, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    out += _chunk(b"IDAT", zlib.compress(raw_scanlines, 6))
    out += _chunk(b"IEND", b"")
    return out


def _compare(oracle, png: bytes, strength=19):
    ours = io.BytesIO()
    rc = run(["-f", "-s", str(strength), "-"],
             stdin=io.BytesIO(png), stdout=ours)
    ref = run_oracle(oracle, png, strength)
    assert rc == 0
    assert ours.getvalue() == ref


def test_16bit_rgb(oracle):
    rng = np.random.default_rng(0)
    w, h = 7, 5
    px = rng.integers(0, 65536, size=(h, w, 3), dtype=np.uint32)
    raw = b"".join(
        b"\x00" + px[y].astype(">u2").tobytes() for y in range(h))
    _compare(oracle, _write_png(w, h, 16, 2, raw))


def test_16bit_gray_alpha(oracle):
    rng = np.random.default_rng(1)
    w, h = 6, 4
    px = rng.integers(0, 65536, size=(h, w, 2), dtype=np.uint32)
    raw = b"".join(b"\x00" + px[y].astype(">u2").tobytes() for y in range(h))
    _compare(oracle, _write_png(w, h, 16, 4, raw))


def test_palette_with_trns(oracle):
    rng = np.random.default_rng(2)
    w, h = 9, 6
    palette = rng.integers(0, 256, size=48, dtype=np.uint8).tobytes()
    trns = bytes([0, 128, 255, 10])  # first 4 of 16 entries get alpha
    idx = rng.integers(0, 16, size=(h, w), dtype=np.uint8)
    raw = b"".join(b"\x00" + idx[y].tobytes() for y in range(h))
    _compare(oracle, _write_png(w, h, 8, 3, raw, palette=palette, trns=trns))


def test_4bit_palette(oracle):
    rng = np.random.default_rng(3)
    w, h = 10, 5
    palette = rng.integers(0, 256, size=24, dtype=np.uint8).tobytes()
    idx = rng.integers(0, 8, size=(h, w), dtype=np.uint8)
    raw = b""
    for y in range(h):
        packed = bytearray()
        for x in range(0, w, 2):
            hi = idx[y, x] << 4
            lo = idx[y, x + 1] if x + 1 < w else 0
            packed.append(hi | lo)
        raw += b"\x00" + bytes(packed)
    _compare(oracle, _write_png(w, h, 4, 3, raw, palette=palette))


def test_gray_with_trns(oracle):
    rng = np.random.default_rng(4)
    w, h = 8, 5
    px = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    px[2, 3] = 77  # ensure the transparent value appears
    trns = struct.pack(">H", 77)
    raw = b"".join(b"\x00" + px[y].tobytes() for y in range(h))
    _compare(oracle, _write_png(w, h, 8, 0, raw, trns=trns))


def test_2bit_gray(oracle):
    rng = np.random.default_rng(5)
    w, h = 11, 4
    px = rng.integers(0, 4, size=(h, w), dtype=np.uint8)
    raw = b""
    for y in range(h):
        packed = bytearray()
        for x in range(0, w, 4):
            byte = 0
            for k in range(4):
                v = px[y, x + k] if x + k < w else 0
                byte |= v << (6 - 2 * k)
            packed.append(byte)
        raw += b"\x00" + bytes(packed)
    _compare(oracle, _write_png(w, h, 2, 0, raw))


def test_adam7_interlaced_rgb(oracle):
    rng = np.random.default_rng(6)
    w, h = 9, 10
    px = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    passes = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
    raw = b""
    for (x0, y0, dx, dy) in passes:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub:
            raw += b"\x00" + row.tobytes()
    _compare(oracle, _write_png(w, h, 8, 2, raw, interlace=1))


def test_rgba_16bit_with_zero_alpha(oracle):
    rng = np.random.default_rng(7)
    w, h = 6, 5
    px = rng.integers(0, 65536, size=(h, w, 4), dtype=np.uint32)
    px[1::2, ::2, 3] = 0  # transparent pixels exercise the alpha rule
    raw = b"".join(b"\x00" + px[y].astype(">u2").tobytes() for y in range(h))
    _compare(oracle, _write_png(w, h, 16, 6, raw))
