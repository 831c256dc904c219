"""pngloss-jax: a batched lossy PNG compression framework in JAX.

A from-scratch JAX rebuild, with one CUDA kernel, of the capabilities of
foobaz/pngloss:
quantize PNG pixel data so filter residuals compress better under zlib, using
Sierra error diffusion, an adaptive frequency-derived symbol table, and an
exhaustive per-row search over the five PNG filters — reformulated as a
batched row recurrence that processes many images at once on a GPU.
"""

from pngloss_jax.version import __version__

__all__ = ["__version__"]
