"""Device paths of the row optimizer, and the one place that picks one.

  "cuda"  the row-recurrence kernel (ops/rowkernel.py, native/rowopt.h):
          the CUDA build on a GPU, its host twin (same source) on the CPU
  "xla"   the plain JAX path (ops/optimize.py), compiled by XLA for any
          backend
  "auto"  "cuda" on a GPU, "xla" on the CPU
"""

import jax

from pngloss_jax import compile_cache
from pngloss_jax.ops import rowkernel
from pngloss_jax.ops.optimize import optimize_batch, optimize_plane_jax
from pngloss_jax.ops.rowkernel import KernelUnavailable, optimize_batch_kernel

compile_cache.enable()   # every compute path imports this package first

IMPLS = ("auto", "xla", "cuda")

# batch sizes small device programs are padded to: one program per (shape,
# size class) instead of one per request size
BATCH_SIZE_CLASSES = (1, 8)
UNBOUNDED_BATCH = 1 << 29


def resolve_impl(impl: str = "auto", backend: str | None = None) -> str:
    """The device path `impl` names on `backend` (default: JAX's default
    backend): 'cuda' or 'xla'."""
    if impl == "pallas":
        raise ValueError(
            "impl='pallas' was removed with its kernels; "
            "use 'auto', 'cuda' or 'xla'")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    if impl == "auto":
        return "cuda" if (backend or jax.default_backend()) == "gpu" else "xla"
    return impl


def device_batch_quantum(h: int, w: int, bpp: int, impl: str = "auto") -> int:
    """Largest per-dispatch batch of the selected device path: the kernel's
    device-memory budget, unbounded for the XLA path."""
    if resolve_impl(impl) == "cuda":
        return rowkernel.batch_limit(h, w, bpp)
    return UNBOUNDED_BATCH


def pad_batch_size(n: int, quantum: int) -> int:
    """Smallest size class >= n within the quantum, else n itself (capped
    by the quantum): padding a chunk beyond 8 would only add lanes."""
    for c in BATCH_SIZE_CLASSES:
        if n <= c <= quantum:
            return c
    return min(n, quantum)


def optimize_batch_auto(rows, strength, bleed: int = 2, *, bpp: int,
                        use_row_filters: bool = True, impl: str = "auto",
                        band_pad: int | None = None,
                        w_real=None, h_real=None):
    """Optimize a batch on the device path `impl` names (see resolve_impl).

    strength: int or per-image values. w_real/h_real: per-image real sizes
    of padded planes (ragged batching). band_pad: the band class, required
    when strength is traced."""
    if resolve_impl(impl) == "cuda":
        return optimize_batch_kernel(
            rows, strength, bleed, bpp=bpp, use_row_filters=use_row_filters,
            band_pad=band_pad, w_real=w_real, h_real=h_real)
    return optimize_batch(
        rows, strength, bleed, bpp=bpp, use_row_filters=use_row_filters,
        band_pad=band_pad, w_real=w_real, h_real=h_real)


__all__ = [
    "IMPLS",
    "KernelUnavailable",
    "device_batch_quantum",
    "optimize_batch",
    "optimize_batch_auto",
    "optimize_batch_kernel",
    "optimize_plane_jax",
    "pad_batch_size",
    "resolve_impl",
]
