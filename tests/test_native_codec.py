"""Native C++ codec equivalence vs the pure-Python reference codec."""

import glob

import numpy as np
import pytest

from pngloss_jax.codec import pypng
from pngloss_jax.codec import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native codec unavailable")


def _suite_paths(suite_dir):
    return sorted(glob.glob(f"{suite_dir}/*.png"))


def test_decode_equivalence_suite(suite_dir):
    for path in _suite_paths(suite_dir):
        data = open(path, "rb").read()
        for strip in (False, True):
            a = pypng.decode(data, strip=strip)
            b = native.decode(data, strip=strip)
            assert np.array_equal(a.rgba, b.rgba), path
            assert abs(a.gamma - b.gamma) < 1e-12
            assert a.color_transform == b.color_transform
            assert [(c.name, c.data, c.location) for c in a.chunks] == \
                   [(c.name, c.data, c.location) for c in b.chunks]


def test_encode_equivalence_suite(suite_dir):
    for path in _suite_paths(suite_dir):
        img = pypng.decode(open(path, "rb").read())
        for rf in (None,
                   np.asarray([y % 5 for y in range(img.height)], np.int8)):
            a = pypng.encode(img.rgba, rf, img.gamma, img.color_transform, img.chunks)
            b = native.encode(img.rgba, rf, img.gamma, img.color_transform, img.chunks)
            assert a == b, path


def test_too_large_file_carries_identical_bytes(suite_dir):
    img = pypng.decode(open(f"{suite_dir}/rose.png", "rb").read())
    with pytest.raises(pypng.TooLargeFile) as ea:
        pypng.encode(img.rgba, None, maximum_file_size=100)
    with pytest.raises(pypng.TooLargeFile) as eb:
        native.encode(img.rgba, None, maximum_file_size=100)
    assert ea.value.data == eb.value.data


def test_decode_errors(suite_dir):
    with pytest.raises(pypng.PngDecodeError):
        native.decode(b"definitely not a png")
    good = open(f"{suite_dir}/rose.png", "rb").read()
    with pytest.raises(pypng.PngDecodeError):
        native.decode(good[:100])  # truncated
    corrupt = bytearray(good)
    corrupt[50] ^= 0xFF  # flip a bit inside a chunk body -> CRC failure
    with pytest.raises(pypng.PngDecodeError):
        native.decode(bytes(corrupt))


def test_synthetic_colorspaces_roundtrip():
    rng = np.random.default_rng(0)
    for kind in ("gray", "gray_alpha", "rgb", "rgba"):
        rgba = rng.integers(0, 256, size=(9, 11, 4), dtype=np.uint8)
        if kind in ("gray", "gray_alpha"):
            rgba[:, :, 0] = rgba[:, :, 2] = rgba[:, :, 1]
        if kind in ("gray", "rgb"):
            rgba[:, :, 3] = 255
        data = native.encode(rgba, None)
        assert data == pypng.encode(rgba, None)
        back = native.decode(data)
        assert np.array_equal(back.rgba, rgba)
