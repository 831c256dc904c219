"""Batched XLA implementation of the pngloss row optimizer.

The plain JAX path: XLA compiles it for any backend, and it is the
reference the row kernel (ops/rowkernel.py) is compared with on the card.
The reference is a scalar, strictly sequential program (optimize_state.c /
pngloss_image.c); here its structure is re-mapped onto array operations:

  * The five PNG filter candidates (a sequential loop at pngloss_image.c:213)
    become a vmapped vector axis — all five rows quantize simultaneously.
  * The batch of images is another vmapped axis (sharded over the device mesh
    by the pipeline layer; the reference processes files one at a time).
  * The irreducible left-to-right pixel recurrence (quantized-left dependency
    of the Sub/Avg/Paeth predictors, optimize_state.c:146, plus Sierra error
    diffusion) is a `lax.scan` of length W whose carry is a few tiny sliding
    windows — there is NO scatter/gather in the per-pixel hot loop:
      - the 3-row dither buffer (optimize_state.c:48-49) is carried as three
        sliding windows of 3/5/3 columns; finalized columns are emitted as
        scan outputs and reassembled into full rows afterwards.
      - the banded symbol search (optimize_state.c:183-248) is computed as
        dense masked reductions over an *extended* histogram table
        (256 + band lanes, table[i] == hist[i & 0xFF]) so the dynamic band
        position needs no dynamic-slice and no gather.
  * The "derivative error" quality metric (optimize_state.c:265-289) depends
    only on committed pixels, so it is lifted out of the scan entirely and
    computed as a vectorized row operation.
  * The strength-fallback retry (pngloss_image.c:266-275) is a
    `lax.while_loop`; under vmap it batches with per-image masking.

Exact C integer semantics are preserved throughout in int32:
  * truncating division for Sierra diffusion (C `/` truncates toward zero;
    verified against the scalar model in pngloss_jax.core.reference which is
    itself byte-parity-tested against the compiled reference tool),
  * `total_error / 128` in uintmax_t is computed exactly in int32 via
    sum(e // 128) + sum(e % 128) // 128 (per-pixel error is bounded by
    12 * 510**2 so the partial sums cannot overflow),
  * `ulog2(UINTMAX_MAX / freq)` (optimize_state.c:338,565-572) via the
    identity 65 - bitlength(freq) == 33 + clz32(freq),
  * the three-level symbol tie-breaking (optimize_state.c:212-248) as
    masked max/max/membership reductions (adaptive frequency, then original
    frequency, then preference for the original symbol, else lowest symbol).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

NUM_FILTERS = 5
_I32_MAX = (1 << 31) - 1


def _tdiv(a: jnp.ndarray, b) -> jnp.ndarray:
    """C-style truncating division for signed a, positive b."""
    q = jnp.abs(a) // b
    return jnp.where(a < 0, -q, q)


def _predict5(above, diag, left, f):
    """All five PNG filter predictors (optimize_state.c:575-613), selected by
    traced filter index f. Inputs are int32 arrays of quantized bytes."""
    avg = (above + left) // 2
    p = above - diag
    pd = left - diag
    p_left = jnp.abs(p)
    p_above = jnp.abs(pd)
    p_d = jnp.abs(p + pd)
    paeth = jnp.where(
        (p_left <= p_above) & (p_left <= p_d),
        left,
        jnp.where(p_above <= p_d, above, diag),
    )
    stacked = jnp.stack([jnp.zeros_like(left), left, above, avg, paeth])
    return stacked[f]


def _shift_right(a: jnp.ndarray) -> jnp.ndarray:
    """Shift (W, ...) array one pixel right along axis 0, zero-filled."""
    return jnp.concatenate([jnp.zeros_like(a[:1]), a[:-1]], axis=0)


def _cd_map(d: jnp.ndarray, bpp: int) -> jnp.ndarray:
    """color_difference lane mapping (color_delta.c:9-39): map per-channel
    deltas (..., bpp) to the 4 RGBA comparison lanes (..., 4)."""
    z = jnp.zeros_like(d[..., :1])
    if bpp == 1:
        g = d[..., :1]
        return jnp.concatenate([g, g, g, z], axis=-1)
    if bpp == 2:
        g = d[..., :1]
        return jnp.concatenate([g, g, g, d[..., 1:2]], axis=-1)
    if bpp == 3:
        return jnp.concatenate([d, z], axis=-1)
    return d


def _original_frequencies(orig: jnp.ndarray, bpp: int,
                          w_real=None, h_real=None) -> jnp.ndarray:
    """(5, 256) histogram of original-image residuals under each filter
    (the init pre-pass, optimize_state.c:66-83), fully vectorized.

    w_real/h_real (traced scalars) restrict the count to the top-left
    real region of a padded plane (ragged batching)."""
    above = jnp.concatenate([jnp.zeros_like(orig[:1]), orig[:-1]], axis=0)
    left = jnp.concatenate([jnp.zeros_like(orig[:, :1]), orig[:, :-1]], axis=1)
    diag = jnp.concatenate([jnp.zeros_like(above[:, :1]), above[:, :-1]], axis=1)
    h, w = orig.shape[0], orig.shape[1]
    weight = jnp.ones((h, w), jnp.int32)
    if w_real is not None:
        weight = weight * (jnp.arange(w)[None, :] < w_real)
    if h_real is not None:
        weight = weight * (jnp.arange(h)[:, None] < h_real)
    weight = jnp.broadcast_to(weight[:, :, None], orig.shape)
    wvec = weight.ravel()
    syms = jnp.stack(
        [((orig - _predict5(above, diag, left, f)) & 0xFF).ravel()
         for f in range(NUM_FILTERS)], axis=-1)          # (n, 5)
    return jnp.stack(
        [jnp.zeros((256,), jnp.int32).at[syms[:, f]].add(wvec)
         for f in range(NUM_FILTERS)])


def _adaptive_filter(qprev: jnp.ndarray, qrow: jnp.ndarray,
                     col_mask=None) -> jnp.ndarray:
    """libpng's minimum-sum-of-absolute-differences heuristic
    (adaptive_filter_for_rows, optimize_state.c:492-562). qprev must be zeros
    for row 0 / diag must also be zeros then — callers pass qprev=0 at y==0.
    col_mask (W,) excludes padded columns (ragged batching).
    Returns the chosen filter id (ties -> lowest index)."""
    px = qrow.reshape(-1)
    above = qprev.reshape(-1)
    left = _shift_right(qrow).reshape(-1)
    diag = _shift_right(qprev).reshape(-1)
    m = (jnp.broadcast_to(col_mask[:, None], qrow.shape).reshape(-1)
         if col_mask is not None else None)

    def msad(vals):
        v = vals & 0xFF
        v = jnp.where(v < 128, v, 256 - v)
        return jnp.sum(v * m if m is not None else v)

    p = above - diag
    pd = left - diag
    paeth_pred = jnp.where(
        (jnp.abs(p) <= jnp.abs(pd)) & (jnp.abs(p) <= jnp.abs(p + pd)),
        left,
        jnp.where(jnp.abs(pd) <= jnp.abs(p + pd), above, diag),
    )
    sums = jnp.stack([
        msad(px),
        msad(px - left),
        msad(px - above),
        msad(px - (left + above) // 2),
        msad(px - paeth_pred),
    ])
    # first index achieving the minimum (the C >= cascade keeps the earliest)
    return jnp.argmin(sums).astype(jnp.int32)


def _deriv_error_div128(qrow, qprev, orow, oprev, bpp: int,
                        col_mask=None) -> jnp.ndarray:
    """Row sum of the derivative (second-difference) error, divided by 128
    with exact uintmax semantics (optimize_state.c:265-289, row cost :360).

    All inputs are (W, bpp) int32; boundary pixels are handled by zero
    padding exactly as the C code's x>0 / y>0 guards (zeros otherwise).
    col_mask (W,) excludes padded columns (ragged batching).
    Exactness: per-pixel error <= 12*510^2 < 2^22, so sum(e // 128) and
    sum(e % 128) both fit comfortably in int32 for any practical W, and
    floor(sum(e)/128) == sum(e//128) + floor(sum(e%128)/128) exactly.
    """

    def dist(new_pair, old_pair):
        newp = _cd_map(qrow - new_pair, bpp)
        oldp = _cd_map(orow - old_pair, bpp)
        d = newp - oldp
        return jnp.sum(d * d, axis=-1)

    e = (
        dist(qprev, oprev)                            # above
        + dist(_shift_right(qprev), _shift_right(oprev))  # diagonal
        + dist(_shift_right(qrow), _shift_right(orow))    # left
    )
    if col_mask is not None:
        e = e * col_mask
    return jnp.sum(e // 128) + jnp.sum(e % 128) // 128


def _quantize_row(f, s, bleed, orig_row, qprev, err0_init, err1_init,
                  hist_ext, ofreq_ext, *, bpp: int, band_pad: int,
                  col_mask=None):
    """Quantize one row under one filter (optimize_state_row's pixel loop,
    optimize_state.c:292-313 + optimize_state_run :114-264).

    Args (single image, single filter; vmapped over both by the caller):
      f          traced filter id (0..4)
      s          traced strength for this attempt
      bleed      traced bleed divider
      orig_row   (W, bpp) int32 original pixels for this row
      qprev      (W, bpp) int32 quantized previous row (zeros at y==0)
      err0_init  (W+5, 4) int32 dither row 0 at row start
      err1_init  (W+5, 4) int32 dither row 1 at row start (row 2 starts zero)
      hist_ext   (TABLE,) int32 adaptive histogram, TABLE = 256 + band_pad,
                 invariant hist_ext[i] == hist[i & 0xFF]
      ofreq_ext  (TABLE,) int32 this filter's original-residual histogram,
                 same extended layout
      col_mask   optional (W,) int32 — 0 for padded columns (ragged
                 batching): padded pixels neither count in the histogram
                 nor diffuse error (their diffusion would reach REAL
                 columns of the next row: pixel x writes logical columns
                 x-2..x+2 below)

    Returns (qrow (W,bpp), hist_ext', err0_next (W+5,4), err1_next (W+5,4))
    where err*_next are the dither rows for the NEXT image row, i.e. the
    buffer shift (optimize_state.c:344-351) is built in: err0_next is this
    row's fully-written dither row 1 and err1_next is dither row 2.
    """
    w = orig_row.shape[0]
    table = 256 + band_pad
    idx = lax.broadcasted_iota(jnp.int32, (table, 1), 0)[:, 0]
    idx_byte = idx & 0xFF

    diag_rows = _shift_right(qprev)
    # alpha==0 test on the ORIGINAL pixel (optimize_state.c:158-164)
    transparent = (orig_row[:, bpp - 1] == 0) if bpp % 2 == 0 else jnp.zeros((w,), bool)

    def step(carry, xs):
        left, win0, win1, win2, hist = carry
        orig, above, diag, e0in, e1in, transp, cmask = xs

        back_list = []
        here_list = []
        for c in range(bpp):
            pred = _predict5(above[c], diag[c], left[c], f)
            lane = 3 if (bpp == 2 and c == 1) else c
            ce = win0[0, lane]
            here_c = orig[c] + ce

            osym = orig[c] - pred
            predw = pred + jnp.where(osym < -128, -256, jnp.where(osym > 127, 256, 0))
            osym = orig[c] - predw
            filt = here_c - predw

            band = s + 1
            neg = -filt
            mn = jnp.where(filt < 0, -(neg - neg % band) - s, filt - filt % band)
            mx = mn + s
            mn = jnp.where(mn + predw < 0, -predw, mn)
            mx = jnp.where(mx + predw > 255, 255 - predw, mx)
            inv = mx < mn
            over = inv & (filt + predw > 255)
            under = inv & (filt + predw < 0)
            mn = jnp.where(over, 255 - predw, jnp.where(under, -predw, mn))
            mx = jnp.where(over, 255 - predw, jnp.where(under, -predw, mx))

            # dense masked lexicographic selection over the extended table:
            # in-band lanes are [start, start + (mx-mn)] and never wrap
            # because start <= 255 and mx-mn <= band_pad-1 < table-256.
            start = mn & 0xFF
            inband = (idx >= start) & (idx <= start + (mx - mn))
            fmax = jnp.max(jnp.where(inband, hist, -1))
            m2 = inband & (hist == fmax)
            omax = jnp.max(jnp.where(m2, ofreq_ext, -1))
            m3 = m2 & (ofreq_ext == omax)
            idx_orig = start + (osym - mn)
            any_orig = jnp.any(m3 & (idx == idx_orig))
            idx_min = jnp.min(jnp.where(m3, idx, table))
            idx_best = jnp.where(any_orig, idx_orig, idx_min)
            sym_byte = idx_best & 0xFF
            back_c = (idx_best - start) + mn + predw

            if bpp % 2 == 0 and c == bpp - 1:
                # fully transparent pixels stay fully transparent; the
                # emitted symbol uses the UNwrapped predictor (:158-164)
                back_c = jnp.where(transp, 0, back_c)
                here_c = jnp.where(transp, 0, here_c)
                sym_byte = jnp.where(transp, (0 - pred) & 0xFF, sym_byte)

            hist = hist + (idx_byte == sym_byte).astype(jnp.int32) * cmask
            back_list.append(back_c)
            here_list.append(here_c)

        back = jnp.stack(back_list)
        here = jnp.stack(here_list)

        # Sierra diffusion with sequential truncating division
        # (diffuse_color_error, optimize_state.c:390-490)
        d = _tdiv(_cd_map((here - back)[None, :], bpp)[0], bleed) * cmask
        twos = _tdiv(d, 16)
        d = d - twos * 4
        threes = _tdiv(d, 8)
        d = d - threes * 2
        fours = _tdiv(d * 2, 9)
        d = d - fours * 2
        five = _tdiv(d, 2)
        d = d - five

        z4 = jnp.zeros_like(d)
        win0 = win0 + jnp.stack([z4, d, threes])              # cols x+2,x+3,x+4
        win1 = win1 + jnp.stack([twos, fours, five, fours, twos])  # cols x..x+4
        win2 = win2 + jnp.stack([twos, threes, twos])          # cols x+1..x+3

        out1 = win1[0]   # column x of dither row 1: finalized
        out2 = win2[0]   # column x+1 of dither row 2: finalized

        win0 = jnp.concatenate([win0[1:], e0in[None]])
        win1 = jnp.concatenate([win1[1:], e1in[None]])
        win2 = jnp.concatenate([win2[1:], z4[None]])

        return (back, win0, win1, win2, hist), (back, out1, out2)

    carry0 = (
        jnp.zeros((bpp,), jnp.int32),
        err0_init[2:5],
        err1_init[0:5],
        jnp.zeros((3, 4), jnp.int32),
        hist_ext,
    )
    cmask = (jnp.ones((w,), jnp.int32) if col_mask is None
             else col_mask.astype(jnp.int32))
    xs = (orig_row, qprev, diag_rows, err0_init[5:], err1_init[5:],
          transparent, cmask)
    (_, _, win1_f, win2_f, hist_out), (qrow, outs1, outs2) = lax.scan(step, carry0, xs)

    z14 = jnp.zeros((1, 4), jnp.int32)
    err0_next = jnp.concatenate([outs1, win1_f])               # (W+5, 4)
    err1_next = jnp.concatenate([z14, outs2, win2_f, z14])     # (W+5, 4)
    return qrow, hist_out, err0_next, err1_next


def _row_cost(f, qrow, qprev, orow, oprev, hist_ext, adaptive, *, bpp: int,
              col_mask=None):
    """Row cost and validity (tail of optimize_state_row, :314-361)."""
    above = qprev
    diag = _shift_right(qprev)
    left = _shift_right(qrow)
    pred = _predict5(above, diag, left, f)
    sym = (qrow - pred) & 0xFF
    freq = jnp.take(hist_ext[:256], sym.ravel())
    # ulog2(UINTMAX_MAX / freq) == 65 - bitlength(freq) == 33 + clz32(freq)
    bits = jnp.where(freq > 0, 33 + lax.clz(freq), 0)
    if col_mask is not None:
        bits = bits * jnp.broadcast_to(
            col_mask[:, None], sym.shape).reshape(-1)
    cost = _deriv_error_div128(qrow, qprev, orow, oprev, bpp,
                               col_mask) + jnp.sum(bits)
    ok = jnp.where(adaptive, _adaptive_filter(qprev, qrow, col_mask) == f, True)
    return cost, ok


def _row_attempt(s, bleed, adaptive, orow, oprev, qprev, err0, err1, hist_ext,
                 ofreq_ext5, *, bpp: int, band_pad: int, col_mask=None):
    """One strength attempt: quantize the row under all 5 filters in parallel
    lanes and select the winner (pngloss_image.c:213-264)."""
    fids = jnp.arange(NUM_FILTERS, dtype=jnp.int32)

    def one_filter(f, ofreq_ext):
        qrow, hist_out, e0n, e1n = _quantize_row(
            f, s, bleed, orow, qprev, err0, err1, hist_ext, ofreq_ext,
            bpp=bpp, band_pad=band_pad, col_mask=col_mask)
        cost, ok = _row_cost(f, qrow, qprev, orow, oprev, hist_out, adaptive,
                             bpp=bpp, col_mask=col_mask)
        return qrow, hist_out, e0n, e1n, cost, ok

    qrows, hists, e0s, e1s, costs, oks = jax.vmap(one_filter)(fids, ofreq_ext5)
    found = jnp.any(oks)
    # where C would abort ("no good row" at strength 0, pngloss_image.c:268),
    # accept the min-cost row instead of crashing
    oks = oks | (~found & (s <= 0))
    found = found | (s <= 0)
    best_f = jnp.argmin(jnp.where(oks, costs, _I32_MAX)).astype(jnp.int32)
    return found, best_f, qrows[best_f], hists[best_f], e0s[best_f], e1s[best_f]


def optimize_plane_jax(rows: jnp.ndarray, strength, bleed, *, bpp: int,
                       band_pad: int, use_row_filters: bool = True,
                       w_real=None, h_real=None):
    """optimize_image (pngloss_image.c:159-333) for one working-format plane.

    rows: (H, W*bpp) uint8. strength/bleed: traced int32 scalars.
    w_real/h_real: traced scalars marking the real top-left region of a
    padded plane (ragged batching). Padded columns are masked out of the
    histogram/diffusion/costs; padded rows need no masking beyond the
    pre-pass — they come after every real row, so nothing real depends on
    them, and their outputs are sliced away by the caller.
    Returns (quantized (H, W*bpp) uint8, row_filters (H,) int8).
    """
    h, wb = rows.shape
    w = wb // bpp
    orig = rows.reshape(h, w, bpp).astype(jnp.int32)
    table = 256 + band_pad
    ofreq = _original_frequencies(orig, bpp, w_real, h_real)      # (5, 256)
    ofreq_ext5 = jnp.concatenate([ofreq, ofreq[:, :band_pad]], axis=1)
    col_mask = (None if w_real is None
                else (jnp.arange(w) < w_real).astype(jnp.int32))

    strength = jnp.asarray(strength, jnp.int32)
    bleed = jnp.asarray(bleed, jnp.int32)

    def y_step(carry, xs):
        qprev, oprev, err0, err1, hist_ext = carry
        orow, y = xs
        adaptive = jnp.asarray(True) if not use_row_filters else (y == 0)

        def cond(st):
            return ~st[0]

        def body(st):
            _, s, _, _, _, _, _ = st
            found, best_f, qrow, hist_out, e0n, e1n = _row_attempt(
                s, bleed, adaptive, orow, oprev, qprev, err0, err1, hist_ext,
                ofreq_ext5, bpp=bpp, band_pad=band_pad, col_mask=col_mask)
            return (found, jnp.maximum(s - 1, 0), best_f, qrow, hist_out, e0n, e1n)

        init = (
            jnp.asarray(False), strength, jnp.int32(0),
            jnp.zeros((w, bpp), jnp.int32), hist_ext, err0, err1,
        )
        _, _, best_f, qrow, hist_out, e0n, e1n = lax.while_loop(cond, body, init)
        return (qrow, orow, e0n, e1n, hist_out), (qrow, best_f.astype(jnp.int8))

    carry0 = (
        jnp.zeros((w, bpp), jnp.int32),
        jnp.zeros((w, bpp), jnp.int32),
        jnp.zeros((w + 5, 4), jnp.int32),
        jnp.zeros((w + 5, 4), jnp.int32),
        jnp.zeros((table,), jnp.int32),
    )
    ys = jnp.arange(h, dtype=jnp.int32)
    _, (qrows, filters) = lax.scan(y_step, carry0, (orig, ys))
    return qrows.reshape(h, wb).astype(jnp.uint8), filters


@functools.partial(
    jax.jit, static_argnames=("bpp", "band_pad", "use_row_filters"))
def _optimize_batch_jit(rows, strength, bleed, *, bpp, band_pad, use_row_filters):
    fn = functools.partial(
        optimize_plane_jax, bpp=bpp, band_pad=band_pad,
        use_row_filters=use_row_filters)
    if jnp.ndim(strength) == 0:
        return jax.vmap(lambda r: fn(r, strength, bleed))(rows)
    return jax.vmap(lambda r, s: fn(r, s, bleed))(rows, strength)


@functools.partial(
    jax.jit, static_argnames=("bpp", "band_pad", "use_row_filters"))
def _optimize_batch_ragged_jit(rows, strength, bleed, w_real, h_real, *,
                               bpp, band_pad, use_row_filters):
    """Ragged batch: strength/w_real/h_real are per-image (B,) vectors, so
    ONE compiled program serves every real size inside the padded shape."""
    fn = functools.partial(
        optimize_plane_jax, bpp=bpp, band_pad=band_pad,
        use_row_filters=use_row_filters)
    return jax.vmap(
        lambda r, s, wr, hr: fn(r, s, bleed, w_real=wr, h_real=hr)
    )(rows, strength, w_real, h_real)


def band_pad_for(strength: int) -> int:
    """Static band padding: the symbol band is strength+1 wide, padded to a
    bucket constant so only a few variants ever compile per shape. The XLA
    path's extended table is 256+band_pad rows and the kernel's per-thread
    band share is band_pad/32 entries, so a smaller bucket means less work
    per symbol selection (strength <= 31 covers the default 19)."""
    if strength <= 31:
        return 32
    if strength <= 127:
        return 128
    return 256


def optimize_batch(rows, strength, bleed: int = 2, *, bpp: int,
                   use_row_filters: bool = True, band_pad: int | None = None,
                   w_real=None, h_real=None):
    """Optimize a batch of same-shaped working-format planes on device.

    rows: (B, H, W*bpp) uint8. strength: int or per-image (B,) array.
    w_real/h_real: optional per-image (B,) real sizes of padded planes
    (ragged batching — strength is promoted to a vector so the program is
    shared). Returns ((B,H,W*bpp) uint8, (B,H) int8). strength/bleed are
    traced (no recompile across values); only shape, bpp and the band-size
    bucket are compile-time static. When strength is a traced value,
    band_pad must be given.
    """
    import numpy as np

    traced = isinstance(strength, jax.core.Tracer)
    per_image = not np.isscalar(strength) and (traced or np.ndim(strength) > 0)
    if band_pad is None:
        s_max = int(np.max(strength)) if per_image else int(strength)
        band_pad = band_pad_for(s_max)
    s_arr = (jnp.asarray(strength, jnp.int32) if per_image
             else jnp.int32(strength))
    if w_real is not None or h_real is not None:
        b, h, wb = rows.shape
        w_real = (jnp.full((b,), wb // bpp, jnp.int32) if w_real is None
                  else jnp.asarray(w_real, jnp.int32))
        h_real = (jnp.full((b,), h, jnp.int32) if h_real is None
                  else jnp.asarray(h_real, jnp.int32))
        return _optimize_batch_ragged_jit(
            rows, jnp.broadcast_to(s_arr, (b,)), jnp.int32(bleed),
            w_real, h_real, bpp=bpp, band_pad=band_pad,
            use_row_filters=use_row_filters)
    return _optimize_batch_jit(
        rows, s_arr, jnp.int32(bleed),
        bpp=bpp, band_pad=band_pad,
        use_row_filters=use_row_filters)
