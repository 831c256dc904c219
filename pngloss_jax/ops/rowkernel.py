"""The row-recurrence kernel (native/rowopt.h) as one JAX operation.

One call optimizes a whole batch of working-format planes: the row loop,
the pixel loop, the symbol selection, the strength fallback and the
winner's commit all run inside it, so the serial chain of each
(image, filter) lane never leaves the device. The original-frequency
pre-pass (optimize_state.c:66-83) runs once per image before it, as plain
XLA (`optimize._original_frequencies`).

The operation is the XLA FFI target ``pngloss_rowopt`` with two handlers
built from the same header:

  * on a GPU, the CUDA kernel (native/rowopt_cuda.cu, Hopper sm_90a);
  * on the CPU, its host twin (native/rowopt_cpu.cc), which is how the
    tests hold the kernel's arithmetic to core/reference.py without a card.

Both are built from the committed sources by native/Makefile at first use,
into native/build/ (git-ignored). A build or load failure raises
KernelUnavailable: there is no quiet switch to another path.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess
import threading

import numpy as np

import jax
import jax.numpy as jnp

from pngloss_jax.ops.optimize import NUM_FILTERS, _original_frequencies, band_pad_for

TARGET = "pngloss_rowopt"
NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")
# backend -> (library built by native/Makefile, XLA FFI platform name)
_LIBS = {"cpu": ("librowopt_cpu.so", "cpu"), "gpu": ("librowopt_cuda.so", "CUDA")}
# device memory one dispatch may give the kernel's operands and scratch
_DISPATCH_BUDGET = 4 << 30

_lock = threading.Lock()
_registered: dict[str, ctypes.CDLL] = {}


class KernelUnavailable(RuntimeError):
    """The kernel library could not be built or loaded for this backend."""


def build(backend: str) -> str:
    """Build (if stale) the kernel library for `backend`; returns its path."""
    if backend not in _LIBS:
        raise KernelUnavailable(
            f"the row kernel has no build for the {backend!r} backend")
    name = _LIBS[backend][0]
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = ["make", "-s", "-C", NATIVE_DIR, f"build/{name}",
           f"JAX_FFI_INCLUDE={jax.ffi.include_dir()}"]
    # one builder at a time: test workers share the checkout
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise KernelUnavailable(f"building {name} failed: {e}") from e
    if proc.returncode != 0:
        raise KernelUnavailable(
            f"building {name} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return os.path.join(BUILD_DIR, name)


def ensure_registered(backend: str | None = None) -> None:
    """Build, load and register the FFI handler for `backend` (default:
    JAX's default backend). Idempotent."""
    backend = backend or jax.default_backend()
    with _lock:
        if backend in _registered:
            return
        path = build(backend)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise KernelUnavailable(f"loading {path} failed: {e}") from e
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.PnglossRowopt),
            platform=_LIBS[backend][1])
        _registered[backend] = lib


def scratch_shapes(b: int, h: int, wb: int, bpp: int):
    """Result shapes of one call: (q, filters, dither scratch, candidate
    rows). The dither scratch holds rows 0 and 1 of the three-row buffer
    for each of 5 lanes, double-buffered by row parity."""
    w = wb // bpp
    return (jax.ShapeDtypeStruct((b, h, wb), jnp.uint8),
            jax.ShapeDtypeStruct((b, h), jnp.int8),
            jax.ShapeDtypeStruct((b, 2, NUM_FILTERS, 2, (w + 5) * 4), jnp.int32),
            jax.ShapeDtypeStruct((b, NUM_FILTERS, wb), jnp.uint8))


def bytes_per_image(h: int, w: int, bpp: int) -> int:
    """Device bytes one image takes in a dispatch: input and output planes,
    the pre-pass's five int32 residual planes, and the kernel's scratch."""
    n = h * w * bpp
    return 2 * n + 4 * NUM_FILTERS * n + sum(
        int(np.prod(s.shape)) * s.dtype.itemsize
        for s in scratch_shapes(1, 1, w * bpp, bpp)[2:])


def batch_limit(h: int, w: int, bpp: int) -> int:
    """Most images one dispatch takes within the kernel's memory budget."""
    return max(1, _DISPATCH_BUDGET // bytes_per_image(h, w, bpp))


@functools.partial(jax.jit, static_argnames=("bpp", "band", "embed"))
def _rowopt_jit(rows, strength, bleed, w_real, h_real, *, bpp, band, embed):
    b, h, wb = rows.shape
    orig = rows.reshape(b, h, wb // bpp, bpp).astype(jnp.int32)
    ofreq = jax.vmap(
        lambda o, wr, hr: _original_frequencies(o, bpp, wr, hr)
    )(orig, w_real, h_real)                                   # (B, 5, 256)
    q, filters, _, _ = jax.ffi.ffi_call(TARGET, scratch_shapes(b, h, wb, bpp))(
        rows, strength, bleed, w_real, h_real, ofreq,
        bpp=np.int32(bpp), band=np.int32(band), embed=np.int32(embed))
    return q, filters


def optimize_batch_kernel(rows, strength, bleed=2, *, bpp: int,
                          use_row_filters: bool = True,
                          band_pad: int | None = None,
                          w_real=None, h_real=None, backend: str | None = None):
    """Kernel counterpart of optimize.optimize_batch, same contract.

    rows: (B, H, W*bpp) uint8. strength: int or per-image (B,) values.
    bleed: int or traced scalar. w_real/h_real: optional per-image real
    sizes of padded planes. band_pad (the band class: 32, 128 or 256
    entries) must be given when strength is traced. Returns
    ((B, H, W*bpp) uint8, (B, H) int8); padded rows and columns are 0.
    Concrete strengths must lie in [0, band_pad) and a concrete bleed be
    at least 1: the kernel divides by strength+1 and by the bleed."""
    ensure_registered(backend)
    b, h, wb = rows.shape
    if band_pad is None:
        band_pad = band_pad_for(int(np.max(strength)))
    if not isinstance(strength, jax.core.Tracer):
        s = np.asarray(strength)
        if s.size and (s.min() < 0 or s.max() >= band_pad):
            raise ValueError(f"strength must lie in [0, {band_pad})")
    if not isinstance(bleed, jax.core.Tracer) and int(bleed) < 1:
        raise ValueError("bleed must be at least 1")
    s_vec = jnp.broadcast_to(jnp.asarray(strength, jnp.int32), (b,))
    w_real = (jnp.full((b,), wb // bpp, jnp.int32) if w_real is None
              else jnp.asarray(w_real, jnp.int32))
    h_real = (jnp.full((b,), h, jnp.int32) if h_real is None
              else jnp.asarray(h_real, jnp.int32))
    return _rowopt_jit(jnp.asarray(rows, jnp.uint8), s_vec,
                       jnp.asarray(bleed, jnp.int32), w_real, h_real,
                       bpp=bpp, band=int(band_pad),
                       embed=not use_row_filters)
