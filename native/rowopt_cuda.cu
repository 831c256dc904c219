// The row-optimizer kernel for NVIDIA Hopper (sm_90a), called from JAX as
// the XLA FFI target "pngloss_rowopt". One launch optimizes a whole batch:
// block b is image b, warp f of the block is filter candidate f, and the
// row and pixel loops stay inside the launch (see rowopt.h).
//
// Build: make -C native build/librowopt_cuda.so  (nvcc, see the Makefile)
#include <cuda_runtime.h>

#include "rowopt.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 32 * rowopt::kFilters;

struct DevLane {
  static constexpr int NT = 32;
  __device__ int lane() const { return threadIdx.x & 31; }
  __device__ uint32_t max(uint32_t v) const { return __reduce_max_sync(0xffffffffu, v); }
  __device__ uint32_t min(uint32_t v) const { return __reduce_min_sync(0xffffffffu, v); }
  __device__ uint32_t sum(uint32_t v) const { return __reduce_add_sync(0xffffffffu, v); }
  __device__ void sync() const { __syncwarp(); }
};

struct DevBlock {
  __device__ int thread() const { return threadIdx.x; }
  __device__ int nthreads() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
  template <class Fn>
  __device__ void lanes(Fn&& fn) const {
    const DevLane l;
    fn(l, static_cast<int>(threadIdx.x >> 5));
    __syncthreads();
  }
};

template <int BPP, int BAND>
__global__ void __launch_bounds__(kThreads) rowopt_kernel(rowopt::Batch a) {
  __shared__ rowopt::Shared sh;
  const DevBlock blk;
  rowopt::optimize_image<DevBlock, DevLane, BPP, BAND / 32>(blk, a, blockIdx.x, sh);
}

template <int BPP>
bool launch_band(cudaStream_t stream, const rowopt::Batch& a, int nb, int band) {
  switch (band) {
    case 32: rowopt_kernel<BPP, 32><<<nb, kThreads, 0, stream>>>(a); return true;
    case 128: rowopt_kernel<BPP, 128><<<nb, kThreads, 0, stream>>>(a); return true;
    case 256: rowopt_kernel<BPP, 256><<<nb, kThreads, 0, stream>>>(a); return true;
  }
  return false;
}

ffi::Error RowoptCuda(cudaStream_t stream, ffi::Buffer<ffi::U8> rows,
                      ffi::Buffer<ffi::S32> strength, ffi::Buffer<ffi::S32> bleed,
                      ffi::Buffer<ffi::S32> w_real, ffi::Buffer<ffi::S32> h_real,
                      ffi::Buffer<ffi::S32> ofreq, ffi::ResultBuffer<ffi::U8> q,
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
  // padded rows and columns are never written by the kernel
  cudaMemsetAsync(a.q, 0, q->size_bytes(), stream);
  cudaMemsetAsync(a.filters, 0, filters->size_bytes(), stream);
  if (nb == 0) return ffi::Error::Success();
  bool ok = false;
  switch (bpp) {
    case 1: ok = launch_band<1>(stream, a, nb, band); break;
    case 2: ok = launch_band<2>(stream, a, nb, band); break;
    case 3: ok = launch_band<3>(stream, a, nb, band); break;
    case 4: ok = launch_band<4>(stream, a, nb, band); break;
  }
  if (!ok) return ffi::Error::InvalidArgument("unsupported bpp or band class");
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PnglossRowopt, RowoptCuda,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
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
