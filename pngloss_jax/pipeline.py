"""Image-level pipeline: decode → colorspace-reduce → device optimize → encode.

This is the batched replacement for the reference's L3/L4 orchestration
(pngloss_image.c + the per-file loop in pngloss.c): instead of one image at a
time, images are bucketed by working shape (H, W, bpp), batched per bucket,
and dispatched to the device with the batch axis sharded over the mesh.

Feed/drain overlap: all buckets are dispatched up front (JAX dispatch is
async), each bucket's device→host copy is started immediately
(`copy_to_host_async`), and host DEFLATE drains finished buckets on a thread
pool (zlib releases the GIL) while later buckets are still computing on
device.
"""

from __future__ import annotations

import concurrent.futures as _futures
import dataclasses
import os

import numpy as np

from pngloss_jax import codec, tracing
from pngloss_jax.codec import DecodedImage
from pngloss_jax.ops import optimize_batch_auto
from pngloss_jax.parallel import optimize_batch_sharded


def working_bpp(rgba: np.ndarray) -> int:
    """Bytes-per-pixel of the working format the optimizer would use for
    this image (pngloss_image.c:64-80 colorspace detection)."""
    grayscale, strip_alpha = codec.detect_colorspace(rgba)
    return {(True, True): 1, (True, False): 2,
            (False, True): 3, (False, False): 4}[(grayscale, strip_alpha)]


def pack_work(rgba: np.ndarray, bpp: int) -> np.ndarray:
    """Repack RGBA into the given working format (grayscale keeps the green
    channel, pngloss_image.c:111-120). Returns (H, W*bpp) uint8."""
    h, w = rgba.shape[0], rgba.shape[1]
    if bpp == 1:
        work = rgba[:, :, 1:2]
    elif bpp == 2:
        work = rgba[:, :, (1, 3)]
    elif bpp == 3:
        work = rgba[:, :, :3]
    else:
        work = rgba
    return np.ascontiguousarray(work).reshape(h, w * bpp)


def reduce_colorspace(rgba: np.ndarray) -> tuple[np.ndarray, int]:
    """Repack RGBA into the 1/2/3/4-byte working format
    (optimize_with_rows, pngloss_image.c:64-121; grayscale keeps the green
    channel). Returns ((H, W*bpp) uint8, bpp)."""
    bpp = working_bpp(rgba)
    return pack_work(rgba, bpp), bpp


def restore_colorspace(work: np.ndarray, bpp: int, w: int) -> np.ndarray:
    """Working format back to RGBA (pngloss_image.c:126-147)."""
    h = work.shape[0]
    px = work.reshape(h, w, bpp)
    out = np.empty((h, w, 4), dtype=np.uint8)
    if bpp == 1:
        out[:, :, 0] = out[:, :, 1] = out[:, :, 2] = px[:, :, 0]
        out[:, :, 3] = 255
    elif bpp == 2:
        out[:, :, 0] = out[:, :, 1] = out[:, :, 2] = px[:, :, 0]
        out[:, :, 3] = px[:, :, 1]
    elif bpp == 3:
        out[:, :, :3] = px
        out[:, :, 3] = 255
    else:
        out[:] = px
    return out


def optimize_rgba(rgba: np.ndarray, strength: int = 19, bleed: int = 2,
                  use_row_filters: bool = True,
                  mesh=None) -> tuple[np.ndarray, np.ndarray]:
    """Optimize one RGBA image on device; the single-image counterpart of
    the reference's optimize_with_rows (pngloss_image.c:52).
    Returns (quantized RGBA (H,W,4) uint8, row_filters (H,) int8)."""
    q, f = optimize_rgba_batch([rgba], strength, bleed,
                               use_row_filters=use_row_filters, mesh=mesh)
    return q[0], f[0]


def unique_symbol_count(q_rgba: np.ndarray, row_filters: np.ndarray,
                        bpp: int | None = None) -> int:
    """Number of distinct residual symbols the optimizer emitted
    (the reference's verbose 'used N unique symbols', pngloss_image.c:315-325).
    Recomputed from the quantized image: the emitted byte equals the
    recomputed residual byte under each row's winning filter.

    bpp: the working format the OPTIMIZER used (from the original image's
    colorspace detection). Pass it whenever available — re-detecting on the
    quantized pixels can differ when quantization collapses the image to
    grayscale or fully-opaque, and the count would diverge from the C tool's
    histogram-based one."""
    if bpp is None:
        work, bpp = reduce_colorspace(q_rgba)
    else:
        work = pack_work(q_rgba, bpp)
    h, wb = work.shape
    rows = work.astype(np.int32)
    # No sequential dependency: the predictor for row y only reads the
    # (already known) quantized row y-1, so all five candidate predictor
    # planes vectorize over the whole image and the winning one is a
    # per-row fancy-index select.
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    diag = np.zeros_like(rows)
    diag[1:, bpp:] = rows[:-1, :-bpp]
    p = up - diag
    pd = left - diag
    paeth = np.where((np.abs(p) <= np.abs(pd)) & (np.abs(p) <= np.abs(p + pd)),
                     left, np.where(np.abs(pd) <= np.abs(p + pd), up, diag))
    preds = np.stack([np.zeros_like(rows), left, up,
                      (left + up) // 2, paeth])
    pred = preds[np.asarray(row_filters, np.intp), np.arange(h)]
    seen = np.zeros(256, bool)
    seen[(rows - pred) & 0xFF] = True
    return int(seen.sum())


def optimize_for_average_filter(rgba: np.ndarray, strength: int = 19) -> np.ndarray:
    """The embedding API (optimizeForAverageFilter, pngloss_image.c:29):
    fixed bleed=2, no row-filter output, every row must self-consistently
    pass libpng's adaptive heuristic. Returns the quantized RGBA array."""
    q, _ = optimize_rgba(rgba, strength, bleed=2, use_row_filters=False)
    return q


def optimize_with_stride(buffer: np.ndarray, width: int, height: int,
                         stride: int, strength: int = 19, bleed: int = 2,
                         use_row_filters: bool = True):
    """Stride-buffer embedding entry (optimize_with_stride,
    pngloss_image.c:40-50): `buffer` is a flat uint8 array holding RGBA rows
    `stride` bytes apart; pixels are modified IN PLACE, and the per-row
    filter choices are returned."""
    buf = buffer.reshape(-1)
    rgba = np.stack([
        buf[y * stride: y * stride + width * 4].reshape(width, 4)
        for y in range(height)
    ])
    q, filters = optimize_rgba(rgba, strength, bleed,
                               use_row_filters=use_row_filters)
    for y in range(height):
        buf[y * stride: y * stride + width * 4] = q[y].reshape(-1)
    return filters


@dataclasses.dataclass
class _PendingBucket:
    """One dispatched shape bucket, results still on device."""
    idxs: list[int]            # image indices covered by this bucket
    bpp: int
    q_dev: object              # device array (B_pad, H_pad, W_pad*bpp) uint8
    f_dev: object              # device array (B_pad, H_pad) int8
    dims: list[tuple[int, int]]  # per-image real (H, W*bpp) to slice out


_SIZE_LADDER = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def pad_dim(n: int) -> int:
    """Ragged-batching pad ladder: ~1.5x geometric steps below 512 (absolute
    waste is tiny there), multiples of 128 above (compute waste <= ~25%).
    A corpus of arbitrary sizes therefore compiles O(few) device programs
    per bpp instead of one per distinct (H, W) (SURVEY §7 hard-part 7)."""
    for v in _SIZE_LADDER:
        if n <= v:
            return v
    return -(-n // 128) * 128


def _warn_abort_fallbacks(qs, fs, bpp: int) -> None:
    """Where the C tool abort()s ("no good row" at strength 0,
    pngloss_image.c:268), the device paths emit the min-cost row instead —
    a documented byte-parity deviation in a case the reference considers
    impossible. Detect it post-hoc (cheap: row 0 is the only adaptive row
    in CLI mode) so any real-world occurrence is visible. The MSAD check
    is the parity-anchored scalar model's (one copy, not a re-derivation)."""
    import warnings

    from pngloss_jax.core.reference import adaptive_filter_for_row

    hit = sum(1 for q, f in zip(qs, fs)
              if adaptive_filter_for_row(
                  None, q[0], bpp, q.shape[1] // bpp) != int(f[0]))
    if hit:
        warnings.warn(
            f"pngloss divergence: {hit} image(s) had no adaptive-consistent "
            "row 0 at strength 0 (the C tool would abort); emitted the "
            "min-cost row instead", RuntimeWarning, stacklevel=3)


def dispatch_buckets(works, bpps, strength, bleed: int = 2, *,
                     use_row_filters: bool = True, mesh=None,
                     impl: str = "auto",
                     ragged: bool | None = None) -> list[_PendingBucket]:
    """Bucket working-format planes and dispatch device programs WITHOUT
    waiting for results. Device→host copies are started immediately so
    they stream while later chunks compute.

    Ragged batching (default on; PNGLOSS_RAGGED=0 or ragged=False for
    exact shapes): each plane is zero-padded up to the pad_dim ladder and
    bucketed by PADDED shape, with the real (H, W) passed to the kernels
    as per-image masks — so a corpus of arbitrary sizes shares O(few)
    compiled programs AND mixed sizes batch together, while outputs stay
    byte-identical to unpadded runs.

    Buckets larger than the device path's per-dispatch limit are split into
    quantum-sized chunks (each its own overlappable dispatch+fetch), and
    every chunk is padded to a small set of batch size classes.

    strength: scalar or per-image sequence (mixed strengths share lanes —
    the band math is per-lane)."""
    from pngloss_jax.ops import (
        UNBOUNDED_BATCH,
        device_batch_quantum,
        pad_batch_size,
    )
    from pngloss_jax.ops.optimize import band_pad_for

    if ragged is None:
        ragged = os.environ.get("PNGLOSS_RAGGED", "1") != "0"
    per_image = not np.isscalar(strength)
    if per_image and len(strength) == 0:
        return []  # nothing decodable: no buckets (np.max would raise)
    s_max = int(np.max(strength)) if per_image else int(strength)
    band_pad = band_pad_for(s_max)
    buckets: dict[tuple[int, int, int], list[int]] = {}
    for i, (wk, bpp) in enumerate(zip(works, bpps)):
        h, wb = wk.shape
        key = ((pad_dim(h), pad_dim(wb // bpp) * bpp, bpp) if ragged
               else (h, wb, bpp))
        buckets.setdefault(key, []).append(i)

    pending = []
    for (h_pad, wb_pad, bpp), idxs in buckets.items():
        quantum = device_batch_quantum(h_pad, wb_pad // bpp, bpp, impl)
        if mesh is not None:
            # the per-device quantum scales with the mesh: each device
            # receives quantum images per dispatch
            n_dev = int(mesh.devices.size)
            quantum = (quantum * n_dev if quantum < UNBOUNDED_BATCH
                       else len(idxs) or 1)
        for lo in range(0, len(idxs), quantum):
            chunk = idxs[lo:lo + quantum]
            b_pad = pad_batch_size(len(chunk), quantum)
            dims = [works[i].shape for i in chunk]
            exact = all(d == (h_pad, wb_pad) for d in dims)
            lanes = chunk + [chunk[0]] * (b_pad - len(chunk))
            if exact:
                batch = np.stack([works[i] for i in lanes])
                w_real = h_real = None
            else:
                batch = np.zeros((b_pad, h_pad, wb_pad), np.uint8)
                for k, i in enumerate(lanes):
                    hh, ww = works[i].shape
                    batch[k, :hh, :ww] = works[i]
                w_real = np.asarray(
                    [works[i].shape[1] // bpp for i in lanes], np.int32)
                h_real = np.asarray(
                    [works[i].shape[0] for i in lanes], np.int32)
            if per_image:
                s = np.asarray([strength[i] for i in lanes], np.int32)
            else:
                s = strength
            with tracing.stage(f"device_dispatch_{h_pad}x{wb_pad // bpp}x{bpp}"):
                if mesh is not None:
                    qb, fb, _ = optimize_batch_sharded(
                        batch, s, bleed, bpp=bpp,
                        use_row_filters=use_row_filters, mesh=mesh,
                        impl=impl, fetch=False,
                        w_real=w_real, h_real=h_real)
                else:
                    qb, fb = optimize_batch_auto(
                        batch, s, bleed, bpp=bpp, band_pad=band_pad,
                        use_row_filters=use_row_filters, impl=impl,
                        w_real=w_real, h_real=h_real)
            qb.copy_to_host_async()
            fb.copy_to_host_async()
            pending.append(_PendingBucket(chunk, bpp, qb, fb, dims))
    return pending


def collect_bucket(p: _PendingBucket):
    """Fetch one dispatched bucket to host; returns (qs, fs) — per-image
    lists sliced to each image's real (H, W*bpp)."""
    with tracing.stage("device_fetch"):
        q = np.asarray(p.q_dev)
        f = np.asarray(p.f_dev)
    qs = [q[k, :h, :wb] for k, (h, wb) in enumerate(p.dims)]
    fs = [f[k, :h] for k, (h, _) in enumerate(p.dims)]
    _warn_abort_fallbacks(qs, fs, p.bpp)
    return qs, fs


def optimize_rgba_batch(rgbas, strength=19, bleed: int = 2, *,
                        use_row_filters: bool = True, mesh=None,
                        impl: str = "auto"):
    """Optimize a list of RGBA images, bucketing by working shape so each
    distinct (H, W, bpp) compiles once and same-shaped images batch together.
    strength: one int for all images, or a per-image sequence — mixed
    strengths still share one device dispatch per bucket (the band math is
    per-lane). impl selects the device path (ops.resolve_impl): 'auto' (the
    row kernel on a GPU, XLA on the CPU), 'cuda' or 'xla'.
    Returns (list of quantized RGBA, list of row_filters)."""
    per_image = not np.isscalar(strength)
    if per_image:
        strength = list(strength)
        assert len(strength) == len(rgbas)
    works, bpps = [], []
    for rgba in rgbas:
        work, bpp = reduce_colorspace(rgba)
        works.append(work)
        bpps.append(bpp)

    q_out: list[np.ndarray | None] = [None] * len(rgbas)
    f_out: list[np.ndarray | None] = [None] * len(rgbas)
    for p in dispatch_buckets(works, bpps, strength, bleed,
                              use_row_filters=use_row_filters, mesh=mesh,
                              impl=impl):
        qb, fb = collect_bucket(p)
        p.q_dev = p.f_dev = None   # cap HBM high-water at one bucket
        for j, i in enumerate(p.idxs):
            q_out[i] = restore_colorspace(qb[j], p.bpp, rgbas[i].shape[1])
            f_out[i] = np.ascontiguousarray(fb[j])
    return q_out, f_out


@dataclasses.dataclass
class CompressResult:
    """Per-file outcome of a batch compression run."""
    data: bytes | None = None          # compressed PNG, or None on error/skip
    error: Exception | None = None
    input_size: int = 0
    output_size: int = 0
    metadata_size: int = 0


def compress_bytes(data: bytes, strength: int = 19, bleed: int = 2, *,
                   strip: bool = False, skip_if_larger: bool = False,
                   mesh=None) -> bytes:
    """Compress one PNG file's bytes (pngloss_file_internal, pngloss.c:226).
    Raises codec.TooLargeFile when skip_if_larger is set and the output would
    not be smaller than the input."""
    return compress_many([data], strength, bleed, strip=strip,
                         skip_if_larger=skip_if_larger, mesh=mesh)[0].unwrap()


def _unwrap(self: CompressResult) -> bytes:
    if self.error is not None:
        raise self.error
    assert self.data is not None
    return self.data


CompressResult.unwrap = _unwrap


def compress_many(files, strength: int = 19, bleed: int = 2, *,
                  strip: bool = False, skip_if_larger: bool = False,
                  mesh=None, decode_workers: int | None = None,
                  impl: str = "auto") -> list[CompressResult]:
    """Compress many PNG byte strings with host/device overlap.

    This is the batched form of the reference's run_suite.sh workload
    (1,089 sequential process invocations, SURVEY.md §3.4), structured as
    feed/drain pools around the device:

      decode pool → colorspace reduce → dispatch ALL shape buckets (async)
        → per bucket: fetch (device→host copy already streaming) → encode
          pool drains while later buckets still compute on device

    decode_workers (default os.cpu_count()) sizes both host pools; zlib
    INFLATE/DEFLATE release the GIL, so the pools scale with real cores and
    still overlap device waits on a single-core host.
    """
    if decode_workers is None:
        decode_workers = os.cpu_count() or 1
    results = [CompressResult() for _ in files]
    per_image_strength = not np.isscalar(strength)
    if per_image_strength:
        strength = list(strength)
        assert len(strength) == len(files)

    def _decode(data: bytes):
        with tracing.stage("host_decode"):
            img = codec.decode(data, strip=strip)
        return img, reduce_colorspace(img.rgba)

    # dedup identical inputs (e.g. the suite's same-file-many-strengths
    # pattern): decode + colorspace-reduce each distinct byte string once
    distinct: dict[bytes, list[int]] = {}
    for i, d in enumerate(files):
        distinct.setdefault(d, []).append(i)
    decoded: list = [None] * len(files)
    work_items = [(idxs, files[idxs[0]]) for idxs in distinct.values()]
    if decode_workers > 1 and len(work_items) > 1:
        with _futures.ThreadPoolExecutor(decode_workers) as pool:
            uniq = list(pool.map(lambda it: _try(_decode, it[1]), work_items))
    else:
        uniq = [_try(_decode, it[1]) for it in work_items]
    for (idxs, _), res in zip(work_items, uniq):
        for i in idxs:
            decoded[i] = res

    ok_idx, works, bpps, widths = [], [], [], []
    for i, (payload, err) in enumerate(decoded):
        results[i].input_size = len(files[i])
        if err is not None:
            results[i].error = err
        else:
            img, (work, bpp) = payload
            ok_idx.append(i)
            works.append(work)
            bpps.append(bpp)
            widths.append(img.rgba.shape[1])

    s_ok = ([strength[i] for i in ok_idx] if per_image_strength
            else strength)
    pending = dispatch_buckets(works, bpps, s_ok, bleed, mesh=mesh, impl=impl)

    pos_of = {i: j for j, i in enumerate(ok_idx)}  # image idx -> works idx

    def _encode(i: int, q_work: np.ndarray, f_row: np.ndarray) -> None:
        img = decoded[i][0][0]
        j = pos_of[i]
        rgba = restore_colorspace(q_work, bpps[j], widths[j])
        max_size = results[i].input_size - 1 if skip_if_larger else 0
        try:
            with tracing.stage("host_encode"):
                out = codec.encode(
                    rgba, row_filters=f_row, gamma=img.gamma,
                    color_transform=img.color_transform, chunks=img.chunks,
                    maximum_file_size=max_size)
        except Exception as e:  # TooLargeFile and friends
            results[i].error = e
            return
        results[i].data = out
        results[i].output_size = len(out)
        results[i].metadata_size = sum(len(c.data) + 12 for c in img.chunks)

    # drain: as each bucket's copy lands, its encodes run on the pool while
    # the remaining buckets are still computing / streaming
    with _futures.ThreadPoolExecutor(max(1, decode_workers)) as pool:
        futs = []
        for p in pending:
            qb, fb = collect_bucket(p)
            # drop the device buffers as soon as they are fetched so HBM
            # high-water stays one bucket, not the whole corpus' outputs
            p.q_dev = p.f_dev = None
            futs += [pool.submit(_encode, ok_idx[j], qb[k], fb[k])
                     for k, j in enumerate(p.idxs)]
        for fut in futs:
            fut.result()
    return results


def _try(fn, arg):
    try:
        return fn(arg), None
    except Exception as e:
        return None, e
