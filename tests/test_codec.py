"""Codec tests: decoding normalizations and byte-identical encoding vs the C tool."""

import os

import numpy as np
import pytest

from pngloss_jax.codec import pypng
from tests.conftest import run_oracle


def _suite(suite_dir, name):
    with open(os.path.join(suite_dir, name), "rb") as f:
        return f.read()


def make_rgba(rng, h, w, kind="rgba"):
    """Random test image in one of the reference's four colorspace kinds."""
    rgba = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    if kind == "gray":
        rgba[:, :, 0] = rgba[:, :, 1]
        rgba[:, :, 2] = rgba[:, :, 1]
        rgba[:, :, 3] = 255
    elif kind == "gray_alpha":
        rgba[:, :, 0] = rgba[:, :, 1]
        rgba[:, :, 2] = rgba[:, :, 1]
        # keep some fully transparent and some opaque pixels
        rgba[:, :, 3] = np.where(rgba[:, :, 3] < 64, 0, rgba[:, :, 3])
        rgba[0, 0, 3] = 7
    elif kind == "rgb":
        rgba[:, :, 3] = 255
    else:  # rgba
        rgba[:, :, 3] = np.where(rgba[:, :, 3] < 64, 0, rgba[:, :, 3])
        rgba[0, 0, 3] = 7  # guarantee non-opaque, non-transparent
    return rgba


def test_roundtrip_random_images():
    rng = np.random.default_rng(0)
    for kind in ("rgba", "rgb", "gray", "gray_alpha"):
        rgba = make_rgba(rng, 13, 17, kind)
        data = pypng.encode(rgba)
        back = pypng.decode(data)
        np.testing.assert_array_equal(back.rgba, rgba)


def test_roundtrip_forced_filters():
    rng = np.random.default_rng(1)
    rgba = make_rgba(rng, 9, 11, "rgb")
    for f in range(5):
        filters = np.full(9, f, dtype=np.int8)
        data = pypng.encode(rgba, row_filters=filters)
        assert pypng.scanline_filters(data)[1:].tolist() == [f] * 8
        np.testing.assert_array_equal(pypng.decode(data).rgba, rgba)


def test_decode_suite_images(suite_dir):
    """All 11 suite images decode; dimensions match IHDR expectations."""
    dims = {
        "lena.png": (512, 512), "david.png": (215, 180), "tenko.png": (382, 554),
        "dice.png": (600, 800), "tux.png": (314, 265), "barbara.png": (512, 512),
        "girl.png": (503, 755), "parrots.png": (512, 768), "redbrush.png": (480, 512),
        "rose.png": (46, 70), "ssr.png": (645, 900),
    }
    for name, (h, w) in dims.items():
        img = pypng.decode(_suite(suite_dir, name))
        assert img.rgba.shape == (h, w, 4), name


@pytest.mark.parametrize("name", ["lena.png", "david.png", "tux.png", "dice.png"])
def test_decode_matches_oracle_passthrough(oracle, suite_dir, name):
    """pngloss -s 0 is pixel-lossless, so decoding the oracle's output must
    equal decoding the input — cross-validates palette/gray/alpha expansion
    against libpng's."""
    data = _suite(suite_dir, name)
    out = run_oracle(oracle, data, strength=0)
    a = pypng.decode(data).rgba
    b = pypng.decode(out).rgba
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["lena.png", "david.png", "tux.png", "dice.png", "rose.png"])
def test_reencode_byte_identical(oracle, suite_dir, name):
    """Encode (pixels, filters) taken from an oracle output; the bytes must be
    identical — pins zlib settings, IDAT chunking, filter application, header
    layout, and gray/alpha repacking to libpng's behavior."""
    out = run_oracle(oracle, _suite(suite_dir, name), strength=0)
    img = pypng.decode(out)
    filters = pypng.scanline_filters(out)
    mine = pypng.encode(
        img.rgba, row_filters=filters,
        gamma=img.gamma, color_transform=img.color_transform, chunks=img.chunks,
    )
    assert mine == out


def test_encode_too_large():
    rng = np.random.default_rng(2)
    rgba = make_rgba(rng, 16, 16, "rgb")
    with pytest.raises(pypng.TooLargeFile):
        pypng.encode(rgba, maximum_file_size=10)
