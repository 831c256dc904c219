// Row optimizer of pngloss (optimize_state.c / pngloss_image.c), written
// once for two builds: nvcc compiles it into the card's kernel
// (rowopt_cuda.cu) and g++ into a host twin (rowopt_cpu.cc) that the CPU
// tests hold to the scalar model in pngloss_jax/core/reference.py.
//
// Mapping. One block optimizes one image; each of the five PNG filter
// candidates of a row is one "lane" (a warp on the card, one pass of a
// loop on the host). A lane walks the row's pixels in order, carrying the
// Sierra dither window in registers, and selects each channel's symbol from
// its own 256-entry histogram. The band scan of a selection is split over
// the lane's threads and joined by three reductions: the highest adaptive
// frequency, then the highest original frequency, then the original symbol
// or else the lowest one (optimize_state.c:212-248). After the five lanes
// the block picks the winner, retries at a lower strength when no candidate
// passes the adaptive self-check (pngloss_image.c:266-275), and commits the
// winner's row, histogram and dither rows for the next row.
//
// Every channel's band depends only on the previous pixel, so a pixel sets
// up all its bands before its first selection; for three or four channels
// the divisions by the band width and the bleed are multiplies by a
// reciprocal, which is exact for every 32-bit numerator.
//
// Exec policies supply what differs between the builds:
//   Lane:  NT threads per lane, lane(), max/min/sum reductions, sync()
//   Block: thread(), nthreads(), sync(), lanes(fn) running fn(lane, f)
// All arithmetic is integer; `/` is C's truncating division, as in the
// reference.
#pragma once

#include <cstdint>
#include <type_traits>

#if defined(__CUDACC__)
#define RO_FN __device__ __forceinline__
#define RO_UNROLL _Pragma("unroll")
#else
#define RO_FN inline
#define RO_UNROLL
#endif

namespace rowopt {

constexpr int kFilters = 5;
constexpr int kHist = 256;

// Operands of one launch; every array is batch-major.
struct Batch {
  const uint8_t* rows;      // (B, H, WB) original working-format rows
  const int32_t* strength;  // (B,)
  const int32_t* bleed;     // () bleed divider, >= 1
  const int32_t* w_real;    // (B,) real width in pixels of each image
  const int32_t* h_real;    // (B,) real height
  const int32_t* ofreq;     // (B, 5, 256) original-residual histograms
  uint8_t* q;               // (B, H, WB) quantized rows (real region only)
  int8_t* filters;          // (B, H) winning filter per real row
  int32_t* err;             // (B, 2, 5, 2, (W+5)*4) dither rows, scratch
  uint8_t* cand;            // (B, 5, WB) candidate rows, scratch
  int h, w, wb;             // padded plane: H rows, W pixels, WB = W*bpp
  int embed;                // every row must pass the adaptive check
};

// Block-shared state of one image.
struct Shared {
  int32_t hist[kFilters][kHist];   // each lane's adaptive histogram
  int32_t hist_c[kHist];           // committed histogram after the last row
  int32_t ofreq[kFilters][kHist];  // this image's original histograms
  uint64_t cost[kFilters];
  int32_t ok[kFilters];
};

RO_FN int clz32(uint32_t v) {
#if defined(__CUDA_ARCH__)
  return __clz(static_cast<int>(v));
#else
  return v ? __builtin_clz(v) : 32;
#endif
}

RO_FN uint64_t umul64hi(uint64_t a, uint64_t b) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(a, b);
#else
  return static_cast<uint64_t>((static_cast<unsigned __int128>(a) * b) >> 64);
#endif
}

// Division by a divisor d in [1, 2^16) fixed for a whole row (the band
// width or the bleed):
// n * ceil(2^48/d) >> 48 equals n / d for every 32-bit n, because the
// rounding error of the reciprocal, under d, times n stays below 2^48.
struct Divider {
  uint64_t m;
  uint32_t d;
  RO_FN explicit Divider(uint32_t dd)
      : m(((uint64_t{1} << 48) + dd - 1) / dd), d(dd) {}
  RO_FN uint32_t div(uint32_t n) const {
    return static_cast<uint32_t>(umul64hi(static_cast<uint64_t>(n) << 16, m));
  }
  // C's truncating division of a signed numerator
  RO_FN int tdiv(int n) const {
    return n < 0 ? -static_cast<int>(div(static_cast<uint32_t>(-n)))
                 : static_cast<int>(div(static_cast<uint32_t>(n)));
  }
  // n % d for n >= 0
  RO_FN int mod(int n) const {
    return n - static_cast<int>(div(static_cast<uint32_t>(n)) * d);
  }
};

// The same interface on the hardware division.
struct HwDivider {
  uint32_t d;
  RO_FN explicit HwDivider(uint32_t dd) : d(dd) {}
  RO_FN int tdiv(int n) const { return n / static_cast<int>(d); }
  RO_FN int mod(int n) const { return n % static_cast<int>(d); }
};

RO_FN int iabs(int v) { return v < 0 ? -v : v; }

RO_FN int paeth(int above, int diag, int left) {
  const int p = above - diag, pd = left - diag;
  const int pl = iabs(p), pa = iabs(pd), pc = iabs(p + pd);
  if (pl <= pa && pl <= pc) return left;
  return pa <= pc ? above : diag;
}

// The five PNG predictors (optimize_state.c:575-613).
RO_FN int predict(int f, int above, int diag, int left) {
  switch (f) {
    case 0: return 0;
    case 1: return left;
    case 2: return above;
    case 3: return (above + left) / 2;
    default: return paeth(above, diag, left);
  }
}

// libpng's minimum-sum-of-absolute-differences weight of one residual.
RO_FN uint32_t msad(int v) {
  v &= 0xFF;
  return static_cast<uint32_t>(v < 128 ? v : 256 - v);
}

// Symbol selection over the band [mn, mn+len): returns the offset of the
// chosen symbol. korig is the original symbol's offset (may lie outside).
// Each thread of the lane holds NE candidates, k = lane + NT*e.
template <class L, int NE>
RO_FN int select_symbol(const L& l, const int32_t* hist, const int32_t* ofreq,
                        int mn, int len, int korig) {
  uint32_t fr[NE], cl[NE];
  uint32_t fmax = 0;
RO_UNROLL
  for (int e = 0; e < NE; ++e) {
    const int k = l.lane() + L::NT * e;
    fr[e] = cl[e] = 0;
    if (k < len) {
      const int idx = (mn + k) & 0xFF;
      fr[e] = static_cast<uint32_t>(hist[idx]) + 1;
      cl[e] = static_cast<uint32_t>(ofreq[idx]) + 1;
    }
    fmax = fr[e] > fmax ? fr[e] : fmax;
  }
  fmax = l.max(fmax);
  uint32_t cmax = 0;
RO_UNROLL
  for (int e = 0; e < NE; ++e)
    if (fr[e] == fmax && cl[e] > cmax) cmax = cl[e];
  cmax = l.max(cmax);
  uint32_t key = 0xFFFFFFFFu;
RO_UNROLL
  for (int e = 0; e < NE; ++e) {
    const int k = l.lane() + L::NT * e;
    if (fr[e] == fmax && cl[e] == cmax) {
      const uint32_t kk = k == korig ? 0u : static_cast<uint32_t>(k) + 1;
      key = kk < key ? kk : key;
    }
  }
  key = l.min(key);
  return key == 0 ? korig : static_cast<int>(key) - 1;
}

// Channel weights of the colour_difference lane mapping (color_delta.c).
template <int BPP>
RO_FN int channel_weight(int c) {
  if (BPP == 1) return 3;
  if (BPP == 2) return c == 0 ? 3 : 1;
  return 1;
}

// Squared derivative-error distance (optimize_state.c:265-289) of one
// neighbour pair: new = quantized neighbour, old = original neighbour.
template <int BPP>
RO_FN uint32_t dist(const int* back, const int* orig, const int* nw,
                    const int* od) {
  uint32_t e = 0;
RO_UNROLL
  for (int c = 0; c < BPP; ++c) {
    const int d = (back[c] - nw[c]) - (orig[c] - od[c]);
    e += static_cast<uint32_t>(channel_weight<BPP>(c) * d * d);
  }
  return e;
}

struct LaneOut {
  uint64_t cost;
  int ok;
};

// One filter candidate of row y at strength s: optimize_state_row
// (optimize_state.c:292-361). err_c holds the committed dither rows 0 and 1
// ((W+5)*4 each); err_n receives the next row's rows 0 and 1.
template <class L, int BPP, int NE>
RO_FN LaneOut run_lane(const L& l, const Batch& a, int b, int y, int f, int s,
                       int w, bool adaptive, int32_t* hist,
                       const int32_t* hist_c, const int32_t* ofreq,
                       const int32_t* err_c, int32_t* err_n, uint8_t* cand) {
  for (int t = l.lane(); t < kHist; t += L::NT) hist[t] = hist_c[t];
  l.sync();

  const int stride = (a.w + 5) * 4;
  const int32_t* e0c = err_c;
  const int32_t* e1c = err_c + stride;
  int32_t* e0n = err_n;
  int32_t* e1n = err_n + stride;
  const uint8_t* orow = a.rows + (static_cast<int64_t>(b) * a.h + y) * a.wb;
  const uint8_t* oprev = y > 0 ? orow - a.wb : nullptr;
  const uint8_t* qprev =
      y > 0 ? a.q + (static_cast<int64_t>(b) * a.h + y - 1) * a.wb : nullptr;
  // the reciprocal pays off where three or four channels' band set-ups
  // overlap; on one channel it measured slower, on two no faster
  using Div = std::conditional_t<(BPP <= 2), HwDivider, Divider>;
  const Div bleed(static_cast<uint32_t>(*a.bleed));
  const Div band(static_cast<uint32_t>(s + 1));
  const bool lead = l.lane() == 0;

  // Sierra windows: row 0 at columns x+2..x+4, row 1 at x..x+4, row 2 at
  // x+1..x+3 (the three-row buffer of optimize_state.c:48-49).
  int win0[3][4], win1[5][4], win2[3][4];
RO_UNROLL
  for (int i = 0; i < 4; ++i) {
RO_UNROLL
    for (int k = 0; k < 3; ++k) {
      win0[k][i] = e0c[(2 + k) * 4 + i];
      win2[k][i] = 0;
    }
RO_UNROLL
    for (int k = 0; k < 5; ++k) win1[k][i] = e1c[k * 4 + i];
  }

  int left[BPP], oleft[BPP], qdiag[BPP], odiag[BPP];
RO_UNROLL
  for (int c = 0; c < BPP; ++c) left[c] = oleft[c] = qdiag[c] = odiag[c] = 0;
  uint64_t total_error = 0;

  for (int x = 0; x < w; ++x) {
    int orig[BPP], qab[BPP], oab[BPP], back[BPP], here[BPP];
RO_UNROLL
    for (int c = 0; c < BPP; ++c) {
      orig[c] = orow[x * BPP + c];
      qab[c] = qprev ? qprev[x * BPP + c] : 0;
      oab[c] = oprev ? oprev[x * BPP + c] : 0;
    }
    // fully transparent pixels stay fully transparent (:158-164)
    const bool transparent = (BPP % 2 == 0) && orig[BPP - 1] == 0;

    // every channel's band: depends only on the previous pixel
    int pred[BPP], predw[BPP], mn[BPP], len[BPP], korig[BPP];
RO_UNROLL
    for (int c = 0; c < BPP; ++c) {
      pred[c] = predict(f, qab[c], qdiag[c], left[c]);
      const int lane4 = (BPP == 2 && c == 1) ? 3 : c;
      here[c] = orig[c] + win0[0][lane4];
      int pw = pred[c];
      const int osym = orig[c] - pred[c];
      if (osym < -128) {
        pw -= 256;
      } else if (osym > 127) {
        pw += 256;
      }
      const int filt = here[c] - pw;
      int lo, hi;
      if (filt < 0) {
        const int neg = -filt;
        hi = -(neg - band.mod(neg));
        lo = hi - s;
      } else {
        lo = filt - band.mod(filt);
        hi = lo + s;
      }
      if (lo + pw < 0) lo = -pw;
      if (hi + pw > 255) hi = 255 - pw;
      if (hi < lo) {
        if (filt + pw > 255) lo = hi = 255 - pw;
        if (filt + pw < 0) lo = hi = -pw;
      }
      predw[c] = pw;
      mn[c] = lo;
      len[c] = hi - lo + 1;
      korig[c] = orig[c] - pw - lo;
    }
RO_UNROLL
    for (int c = 0; c < BPP; ++c) {
      int sym;
      if (BPP % 2 == 0 && c == BPP - 1 && transparent) {
        here[c] = back[c] = 0;
        sym = (0 - pred[c]) & 0xFF;
      } else {
        const int k =
            select_symbol<L, NE>(l, hist, ofreq, mn[c], len[c], korig[c]);
        back[c] = mn[c] + k + predw[c];
        sym = (mn[c] + k) & 0xFF;
      }
      if (lead) hist[sym] += 1;
      l.sync();
    }
    if (lead) {
RO_UNROLL
      for (int c = 0; c < BPP; ++c) cand[x * BPP + c] = static_cast<uint8_t>(back[c]);
    }

    // Sierra diffusion of the colour difference (optimize_state.c:390-490)
    int diff[4];
    if (BPP == 1) {
      diff[0] = diff[1] = diff[2] = here[0] - back[0];
      diff[3] = 0;
    } else if (BPP == 2) {
      diff[0] = diff[1] = diff[2] = here[0] - back[0];
      diff[3] = here[BPP - 1] - back[BPP - 1];
    } else {
      diff[3] = 0;
RO_UNROLL
      for (int c = 0; c < BPP; ++c) diff[c] = here[c] - back[c];
    }
RO_UNROLL
    for (int i = 0; i < 4; ++i) {
      int d = bleed.tdiv(diff[i]);
      const int twos = d / 16;
      d -= twos * 4;
      const int threes = d / 8;
      d -= threes * 2;
      const int fours = (d * 2) / 9;
      d -= fours * 2;
      const int five = d / 2;
      d -= five;
      win0[1][i] += d;
      win0[2][i] += threes;
      win1[0][i] += twos;
      win1[1][i] += fours;
      win1[2][i] += five;
      win1[3][i] += fours;
      win1[4][i] += twos;
      win2[0][i] += twos;
      win2[1][i] += threes;
      win2[2][i] += twos;
    }
    // column x of row 1 and column x+1 of row 2 are final; slide
RO_UNROLL
    for (int i = 0; i < 4; ++i) {
      if (lead) {
        e0n[x * 4 + i] = win1[0][i];
        e1n[(x + 1) * 4 + i] = win2[0][i];
      }
      win0[0][i] = win0[1][i];
      win0[1][i] = win0[2][i];
      win0[2][i] = e0c[(x + 5) * 4 + i];
RO_UNROLL
      for (int k = 0; k < 4; ++k) win1[k][i] = win1[k + 1][i];
      win1[4][i] = e1c[(x + 5) * 4 + i];
      win2[0][i] = win2[1][i];
      win2[1][i] = win2[2][i];
      win2[2][i] = 0;
    }

    // derivative error against the above, diagonal and left neighbours
    total_error += dist<BPP>(back, orig, qab, oab) +
                   dist<BPP>(back, orig, qdiag, odiag) +
                   dist<BPP>(back, orig, left, oleft);
RO_UNROLL
    for (int c = 0; c < BPP; ++c) {
      left[c] = back[c];
      oleft[c] = orig[c];
      qdiag[c] = qab[c];
      odiag[c] = oab[c];
    }
  }
  if (lead) {
RO_UNROLL
    for (int i = 0; i < 4; ++i) {
RO_UNROLL
      for (int k = 0; k < 5; ++k) e0n[(w + k) * 4 + i] = win1[k][i];
      e1n[i] = 0;
RO_UNROLL
      for (int k = 0; k < 3; ++k) e1n[(w + 1 + k) * 4 + i] = win2[k][i];
      e1n[(w + 4) * 4 + i] = 0;
    }
  }
  l.sync();

  // entropy proxy on the final histogram: every emitted symbol costs
  // ulog2(UINTMAX_MAX / freq) = 33 + clz32(freq) (optimize_state.c:326-342)
  uint32_t bits = 0;
  for (int t = l.lane(); t < kHist; t += L::NT) {
    const int32_t h = hist[t];
    const int32_t n = h - hist_c[t];
    if (n > 0) bits += static_cast<uint32_t>(n) * (33u + clz32(static_cast<uint32_t>(h)));
  }
  bits = l.sum(bits);

  int ok = 1;
  if (adaptive) {
    // libpng's heuristic must pick f for this row (optimize_state.c:492-562)
    uint32_t sums[kFilters] = {0, 0, 0, 0, 0};
    const int n = w * BPP;
    for (int i = l.lane(); i < n; i += L::NT) {
      const int px = cand[i];
      const int lf = i >= BPP ? cand[i - BPP] : 0;
      const int ab = qprev ? qprev[i] : 0;
      const int dg = (qprev && i >= BPP) ? qprev[i - BPP] : 0;
      sums[0] += msad(px);
      sums[1] += msad(px - lf);
      sums[2] += msad(px - ab);
      sums[3] += msad(px - (lf + ab) / 2);
      sums[4] += msad(px - paeth(ab, dg, lf));
    }
    int chosen = 0;
    uint32_t best = 0;
RO_UNROLL
    for (int t = 0; t < kFilters; ++t) {
      const uint32_t v = l.sum(sums[t]);
      if (t == 0 || v < best) {
        best = v;
        chosen = t;
      }
    }
    ok = chosen == f;
  }
  return LaneOut{total_error / 128 + bits, ok};
}

// optimize_image (pngloss_image.c:159-333) for image b of the batch.
template <class Blk, class L, int BPP, int NE>
RO_FN void optimize_image(const Blk& blk, const Batch& a, int b, Shared& sh) {
  const int w = a.w_real[b] < 1 ? 1 : (a.w_real[b] > a.w ? a.w : a.w_real[b]);
  const int h = a.h_real[b] < 0 ? 0 : (a.h_real[b] > a.h ? a.h : a.h_real[b]);
  const int stride = (a.w + 5) * 4;
  const int64_t lane_err = 2 * static_cast<int64_t>(stride);
  int32_t* err = a.err + static_cast<int64_t>(b) * 2 * kFilters * lane_err;
  uint8_t* cand = a.cand + static_cast<int64_t>(b) * kFilters * a.wb;
  uint8_t* q = a.q + static_cast<int64_t>(b) * a.h * a.wb;

  for (int i = blk.thread(); i < kFilters * kHist; i += blk.nthreads())
    sh.ofreq[i / kHist][i % kHist] = a.ofreq[static_cast<int64_t>(b) * kFilters * kHist + i];
  for (int i = blk.thread(); i < kHist; i += blk.nthreads()) sh.hist_c[i] = 0;
  // row 0 reads the committed dither rows of (parity 1, lane 0): zero them
  int32_t* zero = err + 1 * kFilters * lane_err;
  for (int i = blk.thread(); i < lane_err; i += blk.nthreads()) zero[i] = 0;
  blk.sync();

  int committed = 0;  // lane whose dither rows (parity (y-1)&1) are current
  for (int y = 0; y < h; ++y) {
    const bool adaptive = a.embed || y == 0;
    const int par = y & 1;
    const int32_t* err_c = err + ((par ^ 1) * kFilters + committed) * lane_err;
    int s = a.strength[b];
    int best = 0;
    for (;;) {
      blk.lanes([&](const L& l, int f) {
        const LaneOut r = run_lane<L, BPP, NE>(
            l, a, b, y, f, s, w, adaptive, sh.hist[f], sh.hist_c, sh.ofreq[f],
            err_c, err + (par * kFilters + f) * lane_err,
            cand + f * a.wb);
        if (l.lane() == 0) {
          sh.cost[f] = r.cost;
          sh.ok[f] = r.ok;
        }
      });
      bool found = false;
      for (int f = 0; f < kFilters; ++f) found = found || sh.ok[f];
      // lowest cost among the passing candidates, lowest filter on ties;
      // where C would abort ("no good row" at strength 0,
      // pngloss_image.c:268), the cheapest of all five
      best = -1;
      uint64_t best_cost = 0;
      for (int f = 0; f < kFilters; ++f) {
        if (found && !sh.ok[f]) continue;
        if (best < 0 || sh.cost[f] < best_cost) {
          best = f;
          best_cost = sh.cost[f];
        }
      }
      blk.sync();  // every thread has read cost/ok before lanes rewrite them
      if (found || s <= 0) break;
      s -= 1;
    }
    if (blk.thread() == 0) a.filters[static_cast<int64_t>(b) * a.h + y] = static_cast<int8_t>(best);
    const uint8_t* win = cand + best * a.wb;
    uint8_t* qrow = q + static_cast<int64_t>(y) * a.wb;
    for (int i = blk.thread(); i < w * BPP; i += blk.nthreads()) qrow[i] = win[i];
    for (int i = blk.thread(); i < kHist; i += blk.nthreads()) sh.hist_c[i] = sh.hist[best][i];
    committed = best;
    blk.sync();
  }
}

}  // namespace rowopt
