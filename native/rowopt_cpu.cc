// Host twin of the row-optimizer kernel: the same rowopt.h compiled by g++
// and registered as the XLA FFI target's CPU handler, so the CPU tests run
// the kernel's arithmetic through the very Python wrapper the card uses.
// Each lane is one thread; the five lanes of a row run one after another.
#include <cstring>

#include "rowopt.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

struct HostLane {
  static constexpr int NT = 1;
  int lane() const { return 0; }
  uint32_t max(uint32_t v) const { return v; }
  uint32_t min(uint32_t v) const { return v; }
  uint32_t sum(uint32_t v) const { return v; }
  void sync() const {}
};

struct HostBlock {
  int thread() const { return 0; }
  int nthreads() const { return 1; }
  void sync() const {}
  template <class Fn>
  void lanes(Fn&& fn) const {
    const HostLane l;
    for (int f = 0; f < rowopt::kFilters; ++f) fn(l, f);
  }
};

template <int BPP, int BAND>
void run_batch(const rowopt::Batch& a, int nb) {
  rowopt::Shared sh;
  const HostBlock blk;
  for (int b = 0; b < nb; ++b)
    rowopt::optimize_image<HostBlock, HostLane, BPP, BAND>(blk, a, b, sh);
}

template <int BPP>
bool dispatch_band(const rowopt::Batch& a, int nb, int band) {
  switch (band) {
    case 32: run_batch<BPP, 32>(a, nb); return true;
    case 128: run_batch<BPP, 128>(a, nb); return true;
    case 256: run_batch<BPP, 256>(a, nb); return true;
  }
  return false;
}

ffi::Error RowoptCpu(ffi::Buffer<ffi::U8> rows, ffi::Buffer<ffi::S32> strength,
                     ffi::Buffer<ffi::S32> bleed, ffi::Buffer<ffi::S32> w_real,
                     ffi::Buffer<ffi::S32> h_real, ffi::Buffer<ffi::S32> ofreq,
                     ffi::ResultBuffer<ffi::U8> q,
                     ffi::ResultBuffer<ffi::S8> filters,
                     ffi::ResultBuffer<ffi::S32> err,
                     ffi::ResultBuffer<ffi::U8> cand, int32_t bpp,
                     int32_t band, int32_t embed) {
  const auto dims = rows.dimensions();
  if (dims.size() != 3) return ffi::Error::InvalidArgument("rows must be (B, H, W*bpp)");
  const int nb = static_cast<int>(dims[0]);
  rowopt::Batch a;
  a.rows = rows.typed_data();
  a.strength = strength.typed_data();
  a.bleed = bleed.typed_data();
  a.w_real = w_real.typed_data();
  a.h_real = h_real.typed_data();
  a.ofreq = ofreq.typed_data();
  a.q = q->typed_data();
  a.filters = filters->typed_data();
  a.err = err->typed_data();
  a.cand = cand->typed_data();
  a.h = static_cast<int>(dims[1]);
  a.wb = static_cast<int>(dims[2]);
  a.w = a.wb / bpp;
  a.embed = embed;
  std::memset(a.q, 0, q->size_bytes());
  std::memset(a.filters, 0, filters->size_bytes());
  bool ok = false;
  switch (bpp) {
    case 1: ok = dispatch_band<1>(a, nb, band); break;
    case 2: ok = dispatch_band<2>(a, nb, band); break;
    case 3: ok = dispatch_band<3>(a, nb, band); break;
    case 4: ok = dispatch_band<4>(a, nb, band); break;
  }
  if (!ok) return ffi::Error::InvalidArgument("unsupported bpp or band class");
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PnglossRowopt, RowoptCpu,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("bpp")
                                  .Attr<int32_t>("band")
                                  .Attr<int32_t>("embed"));
