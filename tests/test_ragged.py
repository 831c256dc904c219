"""Ragged-size batching: padded planes + per-image masks must be
byte-identical to unpadded runs (SURVEY §7 step 4 / hard-part 7).

Padding semantics under test: padded COLUMNS are masked out of the
histogram, Sierra diffusion (a padded pixel would otherwise diffuse into
real columns of the next row), derivative error, row cost and the MSAD
self-check; padded ROWS follow every real row so they need no in-loop
masking, only exclusion from the original-frequency pre-pass.
"""

import numpy as np
import pytest

from pngloss_jax.core import reference as ref
from pngloss_jax.ops import optimize_batch_auto
from pngloss_jax.ops.optimize import optimize_batch
from pngloss_jax.ops.rowkernel import optimize_batch_kernel


def _pad_batch(imgs, hp, wp, bpp):
    out = np.zeros((len(imgs), hp, wp * bpp), np.uint8)
    for k, im in enumerate(imgs):
        out[k, : im.shape[0], : im.shape[1]] = im
    return out


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_padded_matches_reference_all_paths(bpp):
    rng = np.random.default_rng(60 + bpp)
    sizes = [(6, 7), (9, 4), (3, 11)]
    strengths = [19, 0, 40]
    imgs = []
    for h, w in sizes:
        im = rng.integers(0, 256, (h, w * bpp), np.uint8)
        if bpp % 2 == 0:
            im.reshape(h, w, bpp)[1::2, ::2, bpp - 1] = 0
        imgs.append(im)
    hp, wp = 10, 12
    pad = _pad_batch(imgs, hp, wp, bpp)
    w_real = [w for _, w in sizes]
    h_real = [h for h, _ in sizes]

    golden = [ref.optimize_image(im, bpp, s, 2)
              for im, s in zip(imgs, strengths)]

    for impl in ("xla", "cuda"):
        q, f = optimize_batch_auto(
            pad, np.asarray(strengths), 2, bpp=bpp, impl=impl,
            w_real=w_real, h_real=h_real)
        q, f = np.asarray(q), np.asarray(f)
        for k, ((h, w), (qr, fr)) in enumerate(zip(sizes, golden)):
            np.testing.assert_array_equal(
                q[k, :h, : w * bpp], qr, err_msg=f"{impl} img{k}")
            np.testing.assert_array_equal(
                f[k, :h], fr, err_msg=f"{impl} img{k}")


def test_padded_kernel_embedding_mode_zero_pads():
    """The kernel with every row adaptive on a padded plane: the real region
    matches the scalar model and the padded rows and columns stay zero."""
    rng = np.random.default_rng(71)
    im = rng.integers(0, 256, (5, 6 * 3), np.uint8)
    pad = _pad_batch([im], 8, 9, 3)
    q, f = optimize_batch_kernel(pad, 19, 2, bpp=3, use_row_filters=False,
                                 w_real=[6], h_real=[5])
    q, f = np.asarray(q), np.asarray(f)
    qr, fr = ref.optimize_image(im, 3, 19, 2, use_row_filters=False)
    np.testing.assert_array_equal(q[0, :5, :18], qr)
    np.testing.assert_array_equal(f[0, :5], fr)
    assert not q[0, 5:].any() and not q[0, :, 18:].any() and not f[0, 5:].any()


def test_padded_embedding_mode():
    # every row adaptive (use_row_filters=False) with width masking
    rng = np.random.default_rng(72)
    im = rng.integers(0, 256, (4, 5 * 3), np.uint8)
    pad = _pad_batch([im], 6, 8, 3)
    q, f = optimize_batch(pad, 19, 2, bpp=3, use_row_filters=False,
                          w_real=[5], h_real=[4])
    qr, fr = ref.optimize_image(im, 3, 19, 2, use_row_filters=False)
    np.testing.assert_array_equal(np.asarray(q)[0, :4, :15], qr)
    np.testing.assert_array_equal(np.asarray(f)[0, :4], fr)


def test_mixed_sizes_share_one_bucket():
    """Images whose padded shapes coincide batch into ONE device program."""
    from pngloss_jax.pipeline import dispatch_buckets, collect_bucket, pad_dim

    assert pad_dim(5) == 8 and pad_dim(17) == 24 and pad_dim(513) == 640
    rng = np.random.default_rng(73)
    sizes = [(5, 6), (8, 7), (7, 5), (6, 8)]     # all pad to (8, 8)
    works = [rng.integers(0, 256, (h, w * 3), np.uint8) for h, w in sizes]
    pending = dispatch_buckets(works, [3] * 4, 19)
    assert len(pending) == 1, [p.dims for p in pending]
    qs, fs = collect_bucket(pending[0])
    for k, (h, w) in enumerate(sizes):
        qr, fr = ref.optimize_image(works[k], 3, 19, 2)
        np.testing.assert_array_equal(qs[k], qr)
        np.testing.assert_array_equal(fs[k], fr)


def test_ragged_end_to_end_vs_oracle(oracle, tmp_path):
    """Mixed-size PNGs through compress_many (ragged padding on) must stay
    byte-identical to the C tool."""
    from pngloss_jax import codec
    from pngloss_jax.pipeline import compress_many
    from tests.conftest import run_oracle

    rng = np.random.default_rng(74)
    pngs = []
    for h, w in ((5, 9), (11, 6), (7, 7)):
        rgba = np.zeros((h, w, 4), np.uint8)
        rgba[:, :, :3] = rng.integers(0, 256, (h, w, 3), np.uint8)
        rgba[:, :, 3] = 255
        pngs.append(codec.encode(rgba))
    outs = compress_many(pngs, strength=19)
    for png, res in zip(pngs, outs):
        assert res.error is None
        assert res.data == run_oracle(oracle, png, 19)
