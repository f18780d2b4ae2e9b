// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * scale over the last
// axis, in fp32, cast back to x's type.
//
// Bound on an H100: bytes.  It does ~4 flops per element and moves 2-4
// bytes in and out per element, far below the ~295 flop/byte ridge, so
// the least time is (rows*D*2*itemsize + D*scale_itemsize) / 3.35 TB/s.
// The design moves each byte once: a row is read once with 16-byte vector
// loads into registers (NV vectors per thread), the sum of squares is
// reduced in fp32 by warp shuffles (and shared memory across warps for
// wide rows), and the normalised row is written from the same registers.
// Narrow rows (D <= 32 vectors, e.g. the 128-wide q/k norms) take one warp
// per row and 8 rows per block, so no thread idles on a block barrier;
// wide rows (4096) take one block of up to 1024 threads per row.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxNV = 8;       // vectors held in registers per thread
constexpr int kMaxThreads = 1024;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// the bound caps registers at 64 a thread, so a block of kMaxThreads fits
// the SM's 64K registers (without it a 1024-thread launch can be refused)
template <typename T, typename TS, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
               T* __restrict__ y, long long rows, int d, int nv,
               int threads_per_row, float eps) {
  using V = Vec<T, VEC>;
  const int rows_per_block = blockDim.x / threads_per_row;
  const int lane = threadIdx.x % threads_per_row;
  const long long row =
      (long long)blockIdx.x * rows_per_block + threadIdx.x / threads_per_row;
  const bool active = row < rows;
  const int nvec = d / VEC;
  const V* xr = reinterpret_cast<const V*>(x + (active ? row : 0) * d);

  V buf[kMaxNV];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) {
    const int vi = lane + i * threads_per_row;
    if (i < nv && active && vi < nvec) {
      buf[i] = xr[vi];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = repro::to_f32(buf[i].v[e]);
        ss += f * f;
      }
    }
  }
  // every thread of the block reaches both reductions (inactive rows add 0)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (threads_per_row > 32) {   // uniform per launch: one row per block
    __shared__ float warp_sums[32];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) warp_sums[warp] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < threads_per_row / 32; ++w) ss += warp_sums[w];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (!active) return;
  V* yr = reinterpret_cast<V*>(y + row * d);
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) {
    const int vi = lane + i * threads_per_row;
    if (i < nv && vi < nvec) {
      V out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float s = repro::to_f32(scale[vi * VEC + e]);
        out.v[e] = repro::from_f32<T>(repro::to_f32(buf[i].v[e]) * r * s);
      }
      yr[vi] = out;
    }
  }
}

template <typename T, typename TS>
cudaError_t launch(const void* x, const void* scale, void* y, long long rows,
                   int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vectorized = d % kVec == 0 &&
                          reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int vec = vectorized ? kVec : 1;
  const int nvec = d / vec;
  int nv = 1;
  while (nv < kMaxNV && (nvec + nv - 1) / nv > kMaxThreads) nv *= 2;
  int tpr = ((nvec + nv - 1) / nv + 31) / 32 * 32;
  if (tpr > kMaxThreads) return cudaErrorInvalidValue;
  const int rows_per_block = tpr == 32 ? 8 : 1;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(tpr * rows_per_block);
  const T* xt = static_cast<const T*>(x);
  const TS* st = static_cast<const TS*>(scale);
  T* yt = static_cast<T*>(y);
  if (vectorized)
    rmsnorm_kernel<T, TS, kVec><<<grid, block, 0, stream>>>(
        xt, st, yt, rows, d, nv, tpr, eps);
  else
    rmsnorm_kernel<T, TS, 1><<<grid, block, 0, stream>>>(
        xt, st, yt, rows, d, nv, tpr, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) contiguous, same dtype; scale: (d,).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             long long rows, int d, int x_dtype,
                             int scale_dtype, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == repro::kFloat32 && scale_dtype == repro::kFloat32)
    return launch<float, float>(x, scale, y, rows, d, eps, s);
  if (x_dtype == repro::kFloat32 && scale_dtype == repro::kBFloat16)
    return launch<float, bf16>(x, scale, y, rows, d, eps, s);
  if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kFloat32)
    return launch<bf16, float>(x, scale, y, rows, d, eps, s);
  if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kBFloat16)
    return launch<bf16, bf16>(x, scale, y, rows, d, eps, s);
  return cudaErrorInvalidValue;
}
