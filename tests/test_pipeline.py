"""Pipeline-level tests: bucketing, sharding, batched compression."""

import numpy as np
import pytest

import jax

from pngloss_jax.core import reference as ref
from pngloss_jax.parallel import data_mesh, optimize_batch_sharded
from pngloss_jax.pipeline import (
    compress_many,
    optimize_rgba_batch,
    reduce_colorspace,
    restore_colorspace,
)


def _rand_rgba(rng, h, w, kind):
    rgba = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    if kind in ("gray", "gray_alpha"):
        rgba[:, :, 0] = rgba[:, :, 1]
        rgba[:, :, 2] = rgba[:, :, 1]
    if kind in ("gray", "rgb"):
        rgba[:, :, 3] = 255
    return rgba


def test_reduce_restore_roundtrip():
    rng = np.random.default_rng(0)
    for kind, bpp in [("gray", 1), ("gray_alpha", 2), ("rgb", 3), ("rgba", 4)]:
        rgba = _rand_rgba(rng, 5, 6, kind)
        work, got_bpp = reduce_colorspace(rgba)
        assert got_bpp == bpp
        assert np.array_equal(restore_colorspace(work, bpp, 6), rgba)


def test_bucketed_batch_matches_scalar_model():
    rng = np.random.default_rng(1)
    imgs = [
        _rand_rgba(rng, 5, 6, "rgb"),
        _rand_rgba(rng, 4, 7, "gray"),
        _rand_rgba(rng, 5, 6, "rgb"),   # same bucket as imgs[0]
        _rand_rgba(rng, 5, 6, "rgba"),  # same HxW, different bpp bucket
    ]
    qs, fs = optimize_rgba_batch(imgs, strength=19)
    for img, q, f in zip(imgs, qs, fs):
        q_ref, f_ref = ref.optimize_rgba(img, 19)
        np.testing.assert_array_equal(q, q_ref)
        np.testing.assert_array_equal(f, f_ref)


def test_sharded_equals_unsharded():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 256, size=(5, 4, 6 * 3), dtype=np.uint8)  # 5 !% 8
    mesh = data_mesh()
    q_sh, f_sh = optimize_batch_sharded(rows, 19, bpp=3, mesh=mesh)
    from pngloss_jax.ops.optimize import optimize_batch
    q, f = optimize_batch(rows, 19, bpp=3)
    np.testing.assert_array_equal(q_sh, np.asarray(q))
    np.testing.assert_array_equal(f_sh, np.asarray(f))


def test_compress_many_mixed_with_errors(oracle, suite_dir):
    import subprocess
    rose = open(f"{suite_dir}/rose.png", "rb").read()
    results = compress_many([rose, b"not a png", rose], strength=19)
    assert results[1].error is not None
    ref_out = subprocess.run([oracle, "-f", "-s", "19", "-b", "2", "-"],
                             input=rose, capture_output=True).stdout
    assert results[0].data == ref_out
    assert results[2].data == ref_out
    assert results[0].input_size == len(rose)
    assert results[0].output_size == len(ref_out)


def test_sharded_mixed_strengths():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    rng = np.random.default_rng(41)
    rows = rng.integers(0, 256, size=(8, 4, 5 * 3), dtype=np.uint8)
    strengths = [0, 1, 5, 19, 40, 88, 19, 3]
    q, f = optimize_batch_sharded(
        rows, strengths, bpp=3, mesh=data_mesh(), impl="cuda")
    for i, s in enumerate(strengths):
        qr, fr = ref.optimize_image(rows[i], 3, s)
        np.testing.assert_array_equal(q[i], qr)
        np.testing.assert_array_equal(f[i], fr)


def test_optimize_with_stride_in_place():
    from pngloss_jax.pipeline import optimize_with_stride
    rng = np.random.default_rng(42)
    w, h, stride = 6, 4, 6 * 4 + 8  # padded rows
    buf = rng.integers(0, 256, size=(h * stride,), dtype=np.uint8)
    rgba = np.stack([buf[y * stride: y * stride + w * 4].reshape(w, 4)
                     for y in range(h)]).copy()
    filters = optimize_with_stride(buf, w, h, stride, strength=19)
    q_ref, f_ref = ref.optimize_rgba(rgba, 19)
    np.testing.assert_array_equal(filters, f_ref)
    got = np.stack([buf[y * stride: y * stride + w * 4].reshape(w, 4)
                    for y in range(h)])
    np.testing.assert_array_equal(got, q_ref)


def test_mesh_quantum_chunks_buckets(monkeypatch):
    """With a mesh, dispatch_buckets must still chunk buckets to one
    quantum per device (the path's per-dispatch limit applies per shard)."""
    from pngloss_jax import pipeline
    from pngloss_jax import ops

    def fake_quantum(*a, **k):
        return 2                      # pretend 2 images fit per device
    # dispatch_buckets imports device_batch_quantum from pngloss_jax.ops at
    # call time, so patching the ops module attribute is what matters
    monkeypatch.setattr(ops, "device_batch_quantum", fake_quantum)

    rng = np.random.default_rng(5)
    works = [rng.integers(0, 256, (8, 9 * 3), np.uint8) for _ in range(9)]
    mesh = data_mesh(jax.devices("cpu")[:4])
    pending = pipeline.dispatch_buckets(
        works, [3] * 9, 19, mesh=mesh, ragged=False)
    # quantum 2 x 4 devices = 8 per dispatch -> 9 images need 2 dispatches
    assert len(pending) == 2
    for p in pending:
        qs, fs = pipeline.collect_bucket(p)
        assert all(q.shape == (8, 27) for q in qs)


def test_device_batch_quantum_per_path():
    """The kernel's per-dispatch limit is its memory budget over the bytes
    one image takes; the XLA path is unbounded."""
    from pngloss_jax import ops
    from pngloss_jax.ops import rowkernel

    q = ops.device_batch_quantum(512, 512, 3, impl="cuda")
    assert q == rowkernel.batch_limit(512, 512, 3) >= 25
    assert ops.device_batch_quantum(3000, 3000, 4, impl="cuda") >= 1
    assert (ops.device_batch_quantum(512, 512, 3, impl="xla")
            == ops.UNBOUNDED_BATCH)
    assert ops.pad_batch_size(5, q) == 8
    assert ops.pad_batch_size(9, ops.UNBOUNDED_BATCH) == 9


def test_compress_many_all_inputs_bad():
    """Per-image strengths with every file undecodable: no device dispatch
    should happen and each result must carry its error (the empty
    per-image strength vector used to crash np.max in dispatch_buckets)."""
    from pngloss_jax.pipeline import compress_many

    results = compress_many([b"junk", b"also junk"], strength=[19, 40])
    assert all(r.error is not None and r.data is None for r in results)


def test_sharded_kernel_matches_xla_at_bleed1():
    """Under shard_map the row kernel (its host twin here) and the XLA path
    agree at full dithering, where the dither error grows largest."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, size=(3, 9, 7 * 3), dtype=np.uint8)
    mesh = data_mesh(jax.devices("cpu")[:2])
    qk, fk = optimize_batch_sharded(rows, 19, bleed=1, bpp=3, mesh=mesh,
                                    impl="cuda")
    qx, fx = optimize_batch_sharded(rows, 19, bleed=1, bpp=3, mesh=mesh,
                                    impl="xla")
    np.testing.assert_array_equal(qk, qx)
    np.testing.assert_array_equal(fk, fx)
    assert qk.shape == rows.shape
