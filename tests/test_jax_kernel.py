"""Bit-exactness of the batched XLA kernel vs the scalar reference model.

The scalar model (pngloss_jax.core.reference) is itself byte-parity-tested
against the compiled reference C tool in test_reference_model.py, so parity
here implies parity with the C tool's optimizer (optimize_state.c /
pngloss_image.c).
"""

import numpy as np
import pytest

from pngloss_jax.core import reference as ref
from pngloss_jax.ops.optimize import optimize_batch


def _check(rows, bpp, strength, bleed=2, use_row_filters=True):
    q_ref, f_ref = ref.optimize_image(rows, bpp, strength, bleed, use_row_filters)
    q_jax, f_jax = optimize_batch(
        rows[None], strength, bleed, bpp=bpp, use_row_filters=use_row_filters)
    np.testing.assert_array_equal(np.asarray(f_jax[0]), f_ref)
    np.testing.assert_array_equal(np.asarray(q_jax[0]), q_ref)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_random_all_bpp_multiple_strengths(bpp):
    rng = np.random.default_rng(bpp)
    rows = rng.integers(0, 256, size=(6, 7 * bpp), dtype=np.uint8)
    for strength in (0, 3, 19):  # same compile: strength is traced
        _check(rows, bpp, strength)


@pytest.mark.parametrize("bpp", [2, 4])
def test_transparent_pixel_rule(bpp):
    rng = np.random.default_rng(10 + bpp)
    rows = rng.integers(0, 256, size=(5, 6 * bpp), dtype=np.uint8)
    rows.reshape(5, 6, bpp)[1::2, ::2, bpp - 1] = 0
    _check(rows, bpp, 19)


def test_large_strength_band():
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 256, size=(4, 5 * 3), dtype=np.uint8)
    _check(rows, 3, 255)  # band_pad 256 variant
    _check(rows, 3, 150)


def test_bleed_extremes():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, size=(4, 5 * 3), dtype=np.uint8)
    _check(rows, 3, 19, bleed=1)
    _check(rows, 3, 19, bleed=32767)


def test_embedding_mode_every_row_adaptive():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 256, size=(4, 5 * 3), dtype=np.uint8)
    _check(rows, 3, 19, use_row_filters=False)


def test_smooth_gradient_filter_diversity():
    g = (np.arange(12)[:, None] * 7 + np.arange(14 * 3)[None, :] * 3).astype(np.uint8)
    _check(g, 3, 19)


def test_batch_matches_individual():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, size=(3, 6, 7 * 3), dtype=np.uint8)
    qb, fb = optimize_batch(rows, 19, bpp=3)
    for i in range(3):
        qr, fr = ref.optimize_image(rows[i], 3, 19)
        np.testing.assert_array_equal(np.asarray(qb[i]), qr)
        np.testing.assert_array_equal(np.asarray(fb[i]), fr)


def test_original_frequencies_ragged_masks():
    """The pre-pass histograms of a padded plane, restricted by the real
    width/height, equal the scalar model's on the unpadded image."""
    import jax.numpy as jnp

    from pngloss_jax.ops.optimize import _original_frequencies

    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, size=(29, 17, 3), dtype=np.uint8)
    pad = np.zeros((37, 23, 3), np.uint8)
    pad[:29, :17] = img
    got = _original_frequencies(jnp.asarray(pad, jnp.int32), 3,
                                jnp.int32(17), jnp.int32(29))
    want = ref.original_frequencies(img.reshape(29, 17 * 3), 3)
    np.testing.assert_array_equal(np.asarray(got), want)
    full = _original_frequencies(jnp.asarray(img, jnp.int32), 3)
    np.testing.assert_array_equal(np.asarray(full), want)
