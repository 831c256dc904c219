"""End-to-end byte parity: numpy reference model + codec vs the compiled C tool.

Each case: generate a small random image, PNG-encode it, run the C pngloss on
it, and independently run our decode -> optimize -> encode pipeline. The output
files must be byte-identical — this pins every semantic detail of the
algorithm (band math, tie-breaking, Sierra arithmetic, filter search, cost
model, colorspace reduction) at once.
"""

import numpy as np
import pytest

from pngloss_jax.codec import pypng
from pngloss_jax.core import reference
from tests.conftest import run_oracle
from tests.test_codec import make_rgba


def compress_with_model(png_bytes: bytes, strength: int, bleed: int) -> bytes:
    img = pypng.decode(png_bytes)
    q_rgba, row_filters = reference.optimize_rgba(img.rgba, strength, bleed)
    return pypng.encode(
        q_rgba, row_filters=row_filters,
        gamma=img.gamma, color_transform=img.color_transform, chunks=img.chunks,
    )


CASES = [
    # (kind, h, w, strength, bleed, seed)
    ("rgb", 12, 9, 19, 2, 10),
    ("rgb", 8, 16, 0, 2, 11),
    ("rgb", 10, 10, 40, 2, 12),
    ("rgb", 9, 7, 19, 1, 13),
    ("rgb", 9, 7, 19, 32767, 14),
    ("gray", 11, 13, 19, 2, 15),
    ("gray", 7, 7, 85, 2, 16),
    ("gray_alpha", 10, 12, 19, 2, 17),
    ("gray_alpha", 6, 9, 40, 2, 18),
    ("rgba", 12, 8, 19, 2, 19),
    ("rgba", 8, 8, 40, 2, 20),
    ("rgba", 5, 21, 3, 2, 21),
    ("rgb", 1, 16, 19, 2, 22),    # single row -> row 0 adaptive path only
    ("rgb", 16, 1, 19, 2, 23),    # single column
    ("rgba", 2, 2, 19, 2, 24),
    ("rgb", 14, 6, 255, 2, 25),   # max accepted strength (above documented 85)
]


@pytest.mark.parametrize("kind,h,w,strength,bleed,seed", CASES)
def test_model_matches_oracle(oracle, kind, h, w, strength, bleed, seed):
    rng = np.random.default_rng(seed)
    rgba = make_rgba(rng, h, w, kind)
    png_in = pypng.encode(rgba)
    expect = run_oracle(oracle, png_in, strength=strength, bleed=bleed)
    got = compress_with_model(png_in, strength, bleed)
    assert got == expect


def test_model_matches_oracle_smooth_gradient(oracle):
    """Smooth images exercise long runs of equal symbols and the average/paeth
    filters more heavily than noise does."""
    y, x = np.mgrid[0:14, 0:11]
    rgba = np.zeros((14, 11, 4), dtype=np.uint8)
    rgba[:, :, 0] = (x * 9 + y * 3) % 256
    rgba[:, :, 1] = (x * 9 + y * 3) % 256
    rgba[:, :, 2] = (x * 9 + y * 3) % 256
    rgba[:, :, 3] = 255
    png_in = pypng.encode(rgba)
    for s in (0, 19, 40):
        assert compress_with_model(png_in, s, 2) == run_oracle(oracle, png_in, strength=s)


def test_model_matches_oracle_flat(oracle):
    """Constant image: degenerate histograms, ties everywhere."""
    rgba = np.full((9, 9, 4), 200, dtype=np.uint8)
    rgba[:, :, 3] = 255
    png_in = pypng.encode(rgba)
    assert compress_with_model(png_in, 19, 2) == run_oracle(oracle, png_in, strength=19)


def test_model_transparent_pixels(oracle):
    """Fully transparent pixels must keep alpha == 0 exactly."""
    rng = np.random.default_rng(33)
    rgba = make_rgba(rng, 10, 10, "rgba")
    rgba[2:5, 3:7, 3] = 0
    png_in = pypng.encode(rgba)
    out = compress_with_model(png_in, 40, 2)
    assert out == run_oracle(oracle, png_in, strength=40)
    q = pypng.decode(out).rgba
    assert np.all(q[2:5, 3:7, 3] == 0)
