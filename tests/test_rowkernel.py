"""The row-recurrence kernel (native/rowopt.h) and its JAX wrapper.

On the CPU the FFI target runs the kernel's host twin, built by g++ from the
same header the card's CUDA build uses, so these tests hold the kernel's
arithmetic to the scalar model (core/reference.py) through the very wrapper
the card runs: pre-pass, shapes, padding and the per-image operands. The
`gpu` tests run the CUDA build itself, on the card, through chip_smoke.py.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pngloss_jax import compile_cache, ops
from pngloss_jax.core import reference as ref
from pngloss_jax.ops import rowkernel
from pngloss_jax.ops.rowkernel import KernelUnavailable, optimize_batch_kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _check(rows, bpp, strength, bleed=2, use_row_filters=True):
    batch = rows[None] if rows.ndim == 2 else rows
    q, f = optimize_batch_kernel(
        batch, strength, bleed, bpp=bpp, use_row_filters=use_row_filters)
    q, f = np.asarray(q), np.asarray(f)
    strengths = np.broadcast_to(np.asarray(strength), (batch.shape[0],))
    for i in range(batch.shape[0]):
        qr, fr = ref.optimize_image(batch[i], bpp, int(strengths[i]), bleed,
                                    use_row_filters)
        np.testing.assert_array_equal(f[i], fr, err_msg=f"filters {i}")
        np.testing.assert_array_equal(q[i], qr, err_msg=f"pixels {i}")


def _random(seed, b, h, w, bpp, transparent=True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, size=(b, h, w * bpp), dtype=np.uint8)
    if transparent and bpp % 2 == 0:   # the transparent-pixel rule
        rows.reshape(b, h, w, bpp)[:, 1::2, ::2, bpp - 1] = 0
    return rows


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_twin_all_bpp(bpp):
    rows = _random(20 + bpp, 2, 6, 7, bpp)
    for strength in (0, 3, 19):
        _check(rows, bpp, strength)


@pytest.mark.parametrize("strength", [31, 32, 40, 127, 128, 255])
def test_twin_band_classes(strength):
    """Both edges of each band class (32, 128, 256 entries)."""
    _check(_random(30, 2, 5, 6, 3), 3, strength)


@pytest.mark.parametrize("bleed", [1, 2, 17, 32767])
def test_twin_bleed(bleed):
    _check(_random(31, 2, 6, 7, 4), 4, 19, bleed)


@pytest.mark.parametrize("seed", [700, 711])
def test_twin_embedding_mode(seed):
    """Every row adaptive; seed 700 makes some images fall back to lower
    strengths, seed 711 lets every row pass at full strength."""
    _check(_random(seed, 4, 6, 7, 3, transparent=False), 3, 45,
           use_row_filters=False)


def test_twin_smooth_gradient():
    g = (np.arange(12)[:, None] * 7 + np.arange(14 * 3)[None, :] * 3).astype(np.uint8)
    _check(g, 3, 19)


def test_twin_mixed_strengths_one_batch():
    rows = _random(40, 4, 5, 6, 3)
    _check(rows, 3, np.asarray([0, 7, 19, 40]))


def test_twin_matches_xla_path():
    from pngloss_jax.ops.optimize import optimize_batch

    rows = _random(32, 3, 5, 6, 3)
    qk, fk = optimize_batch_kernel(rows, 19, bpp=3)
    qx, fx = optimize_batch(rows, 19, bpp=3)
    np.testing.assert_array_equal(np.asarray(qk), np.asarray(qx))
    np.testing.assert_array_equal(np.asarray(fk), np.asarray(fx))


def test_ffi_call_shapes_ragged():
    """Output shapes of the FFI call for a padded ragged batch, traced
    without running it, and the scratch it requests."""
    rows = jax.ShapeDtypeStruct((5, 24, 16 * 3), jnp.uint8)
    out = jax.eval_shape(
        lambda r, s, wr, hr: optimize_batch_kernel(
            r, s, 2, bpp=3, band_pad=32, w_real=wr, h_real=hr),
        rows, jax.ShapeDtypeStruct((5,), jnp.int32),
        jax.ShapeDtypeStruct((5,), jnp.int32),
        jax.ShapeDtypeStruct((5,), jnp.int32))
    assert out[0].shape == (5, 24, 48) and out[0].dtype == jnp.uint8
    assert out[1].shape == (5, 24) and out[1].dtype == jnp.int8
    shapes = rowkernel.scratch_shapes(5, 24, 48, 3)
    assert shapes[2].shape == (5, 2, 5, 2, (16 + 5) * 4)
    assert shapes[3].shape == (5, 5, 48)
    assert rowkernel.bytes_per_image(24, 16, 3) > 24 * 48


def test_batch_limit_scales_with_image_size():
    small = rowkernel.batch_limit(46, 70, 3)
    large = rowkernel.batch_limit(3000, 3000, 4)
    assert small > rowkernel.batch_limit(512, 512, 3) > large >= 1


def test_kernel_refuses_out_of_range_operands():
    """The kernel divides by strength+1 and by the bleed, and scans at most
    band_pad entries: concrete values outside that range are refused."""
    rows = np.zeros((1, 2, 3), np.uint8)
    with pytest.raises(ValueError, match="strength"):
        optimize_batch_kernel(rows, -1, bpp=3)
    with pytest.raises(ValueError, match="strength"):
        optimize_batch_kernel(rows, 40, bpp=3, band_pad=32)
    with pytest.raises(ValueError, match="bleed"):
        optimize_batch_kernel(rows, 19, 0, bpp=3)
    q, f = optimize_batch_kernel(rows, 31, 1, bpp=3, band_pad=32)
    assert np.asarray(q).shape == (1, 2, 3)


def test_resolve_impl_per_backend():
    assert ops.resolve_impl("auto", "gpu") == "cuda"
    assert ops.resolve_impl("auto", "cpu") == "xla"
    assert ops.resolve_impl("xla", "gpu") == "xla"
    assert ops.resolve_impl("cuda", "cpu") == "cuda"
    assert ops.resolve_impl() == "xla"     # the tests' CPU backend


def test_pallas_impl_refused():
    with pytest.raises(ValueError, match="pallas"):
        ops.resolve_impl("pallas")
    with pytest.raises(ValueError, match="pallas"):
        ops.optimize_batch_auto(np.zeros((1, 2, 3), np.uint8), 19, bpp=3,
                                impl="pallas")
    with pytest.raises(ValueError):
        ops.resolve_impl("mosaic")


def test_missing_library_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built is an error, never a quiet switch."""
    monkeypatch.setattr(rowkernel, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(rowkernel, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(rowkernel, "_registered", {})
    with pytest.raises(KernelUnavailable, match="librowopt_cuda.so"):
        rowkernel.ensure_registered("gpu")
    with pytest.raises(KernelUnavailable):
        ops.optimize_batch_auto(np.zeros((1, 2, 3), np.uint8), 19, bpp=3,
                                impl="cuda")
    with pytest.raises(KernelUnavailable, match="no build"):
        rowkernel.ensure_registered("rocm")


def _enable_recording(monkeypatch):
    calls = {}
    monkeypatch.setattr(compile_cache, "_enabled", False)
    monkeypatch.setattr(compile_cache, "_cpu_only", lambda: False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_compile_cache_honors_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")
    calls = _enable_recording(monkeypatch)
    compile_cache.enable()
    assert "jax_compilation_cache_dir" not in calls   # JAX reads the env
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_compile_cache_fixed_path_in_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "REPO_ROOT", str(tmp_path))
    path = str(tmp_path / ".jax_cache")
    assert compile_cache.cache_dir() == path
    calls = _enable_recording(monkeypatch)
    compile_cache.enable()
    assert calls["jax_compilation_cache_dir"] == path
    assert os.path.isdir(path)


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    proc = _smoke(REPO, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied away from the repository, the script cannot pass either."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _smoke(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# ---- the CUDA build, on the card (run through chip_smoke.py) -----------

@pytest.mark.gpu
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_cuda_kernel_matches_reference(gpu, bpp):
    rows = _random(20 + bpp, 2, 6, 7, bpp)
    for strength in (0, 19, 75, 255):
        for bleed in (1, 2):
            for use_row_filters in (True, False):
                _check(rows, bpp, strength, bleed, use_row_filters)


@pytest.mark.gpu
def test_cuda_kernel_matches_xla_ragged(gpu):
    from pngloss_jax.ops.optimize import optimize_batch

    rows = _random(90, 4, 33, 41, 4)
    wr, hr = [41, 20, 33, 1], [33, 33, 7, 2]
    s = np.asarray([19, 0, 75, 255])
    qk, fk = optimize_batch_kernel(rows, s, 2, bpp=4, w_real=wr, h_real=hr)
    qx, fx = optimize_batch(rows, s, 2, bpp=4, w_real=wr, h_real=hr)
    qk, fk, qx, fx = map(np.asarray, (qk, fk, qx, fx))
    for k in range(4):
        np.testing.assert_array_equal(qk[k, :hr[k], :wr[k] * 4],
                                      qx[k, :hr[k], :wr[k] * 4])
        np.testing.assert_array_equal(fk[k, :hr[k]], fx[k, :hr[k]])
