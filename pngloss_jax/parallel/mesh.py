"""Device-mesh distribution for the optimizer.

The reference tool is strictly single-process/single-threaded
(SURVEY.md §2.4 — pngloss.c:173-205 processes files one at a time). The
distribution model here is pure data parallelism over the image batch:
every image's row recurrence is independent, so the batch axis shards over a
1-D `jax.sharding.Mesh` with no cross-device communication in the compute
path at all — each device runs the row kernel (or the XLA scan) on its own
shard, and the only collective anywhere is the implicit all-gather when
results are fetched. Every card reaches every other alike, so the mesh
stays 1-D; the entry points accept any 1-D mesh.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "data"


def data_mesh(devices=None) -> Mesh:
    """1-D data-parallel mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (BATCH_AXIS,))


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def optimize_batch_sharded(rows: np.ndarray, strength, bleed: int = 2, *,
                           bpp: int, use_row_filters: bool = True,
                           mesh: Mesh | None = None, impl: str = "auto",
                           fetch: bool = True, w_real=None, h_real=None):
    """Batch optimize with the batch axis sharded over a device mesh.

    rows: (B, H, W*bpp) uint8 host array. B is padded up to a multiple of the
    mesh size with copies of row 0 (images are independent, padding results
    are discarded). The per-shard computation runs under shard_map so the
    row kernel partitions too (a custom call cannot be auto-partitioned
    by XLA's SPMD propagation). Returns host numpy arrays
    ((B,H,W*bpp) uint8, (B,H) int8).

    fetch=False returns the still-on-device (padded) jax arrays plus the
    valid batch size: (q_dev, filters_dev, b) — the caller overlaps the
    device→host copy with other work (pipeline.py's feed/drain pools).

    w_real/h_real: per-image real sizes of padded planes (ragged
    batching); they shard along the batch axis with the rows.
    """
    from pngloss_jax.ops import optimize_batch_auto

    if mesh is None:
        mesh = data_mesh()
    n_dev = mesh.devices.size
    b = rows.shape[0]
    b_pad = pad_to_multiple(b, n_dev)
    ragged = w_real is not None or h_real is not None
    per_image = not np.isscalar(strength) or ragged
    s_arr = (np.broadcast_to(np.asarray(strength, np.int32), (b,))
             if per_image else None)
    if ragged:
        w_real = (np.full((b,), rows.shape[2] // bpp, np.int32)
                  if w_real is None else np.asarray(w_real, np.int32))
        h_real = (np.full((b,), rows.shape[1], np.int32)
                  if h_real is None else np.asarray(h_real, np.int32))

    def _pad_b(a):
        return np.concatenate(
            [a, np.broadcast_to(a[:1], (b_pad - b,) + a.shape[1:])])

    if b_pad != b:
        rows = _pad_b(rows)
        if per_image:
            s_arr = _pad_b(s_arr)
        if ragged:
            w_real, h_real = _pad_b(w_real), _pad_b(h_real)
    sharding = NamedSharding(mesh, P(BATCH_AXIS))
    rows_dev = jax.device_put(np.ascontiguousarray(rows), sharding)
    # check_vma=False: the scan carries are initialized from constants inside
    # the shard, which the varying-manual-axes checker cannot unify with the
    # data-varying outputs; the computation is embarrassingly parallel
    if per_image:
        from pngloss_jax.ops.optimize import band_pad_for

        fn = functools.partial(
            optimize_batch_auto, bleed=bleed, bpp=bpp,
            use_row_filters=use_row_filters, impl=impl,
            band_pad=band_pad_for(int(s_arr.max())))
        if ragged:
            sharded = jax.shard_map(
                lambda r, s, wr, hr: fn(r, strength=s, w_real=wr, h_real=hr),
                mesh=mesh, in_specs=(P(BATCH_AXIS),) * 4,
                out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)), check_vma=False)
            q, filters = jax.jit(sharded)(
                rows_dev, jax.device_put(s_arr, sharding),
                jax.device_put(w_real, sharding),
                jax.device_put(h_real, sharding))
        else:
            sharded = jax.shard_map(
                lambda r, s: fn(r, strength=s), mesh=mesh,
                in_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
                out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)), check_vma=False)
            q, filters = jax.jit(sharded)(
                rows_dev, jax.device_put(s_arr, sharding))
    else:
        fn = functools.partial(
            optimize_batch_auto, strength=strength, bleed=bleed, bpp=bpp,
            use_row_filters=use_row_filters, impl=impl)
        sharded = jax.shard_map(
            fn, mesh=mesh, in_specs=P(BATCH_AXIS),
            out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)), check_vma=False)
        q, filters = jax.jit(sharded)(rows_dev)
    if not fetch:
        return q, filters, b
    return np.asarray(q)[:b], np.asarray(filters)[:b]
