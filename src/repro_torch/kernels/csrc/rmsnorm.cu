// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * scale over the last
// axis, in fp32, cast back to x's type.
//
// Bound on an H100: bytes.  It does ~4 flops per element and moves 2-4
// bytes in and out per element, far below the ~295 flop/byte ridge, so
// the least time is (rows*D*2*itemsize + D*scale_itemsize) / 3.35 TB/s.
// A row is read once into registers and written from them, so nothing is
// moved twice; what decides the time is how many bytes are in flight.
//
// Lane groups: each row gets a group of LANES lanes (8 to 1024, a power of
// two), each lane holding up to 8 16-byte vectors of the row (vector vi of
// the row sits at lane vi % LANES, slot vi / LANES, so a warp's loads are
// contiguous).  The group is the narrowest that gives a lane at most 8
// vectors, so a lane keeps several loads in flight.  A lane starts all its
// loads (the row's vectors, then scale's at the same positions, kept in
// registers) before any arithmetic, and sums squares one partial a vector,
// so the adds are not one long chain.  A block has max(256, LANES) threads
// and holds 256 / LANES rows when LANES < 256: at D = 128 bf16 a row is 8
// lanes x 2 vectors and a block 32 rows; at D = 4096 bf16 a row is 2 warps
// x 8 vectors and a block 4 rows.  Groups of up to 32 lanes reduce the sum
// of squares with shuffles inside the warp and meet no block barrier;
// wider groups add one pass through shared memory.  The launch shape is
// chosen in Python (kernels/rmsnorm.py: launch_shape) and checked here: a
// shape this file was not built for is refused, never replaced.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxNV = 8;       // vectors held in registers per lane
constexpr int kMinBlock = 256;  // threads a block, or LANES if wider
constexpr int kMaxVecSpan = 1024;  // LANES * VEC of the widest vector build

template <int LANES>
__host__ __device__ constexpr int block_threads() {
  return LANES > kMinBlock ? LANES : kMinBlock;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, typename TS, int VEC, int LANES>
__global__ void __launch_bounds__(block_threads<LANES>())
rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
               T* __restrict__ y, long long rows, int d, int nv, float eps) {
  using V = Vec<T, VEC>;
  using VS = Vec<TS, VEC>;
  constexpr int kRows = block_threads<LANES>() / LANES;
  const int lane = threadIdx.x % LANES;
  const int sub = threadIdx.x / LANES;
  const long long row = (long long)blockIdx.x * kRows + sub;
  const bool active = row < rows;
  const int nvec = d / VEC;
  const V* xr = reinterpret_cast<const V*>(x + (active ? row : 0) * d);
  const VS* sr = reinterpret_cast<const VS*>(scale);

  // every load first: the row's vectors, then scale's at the same places
  V buf[kMaxNV];
  VS sbuf[kMaxNV];
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) {
    const int vi = lane + i * LANES;
    if (active && i < nv && vi < nvec) buf[i] = xr[vi];
  }
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) {
    const int vi = lane + i * LANES;
    if (active && i < nv && vi < nvec) sbuf[i] = sr[vi];
  }
  // one partial sum a vector, so the adds are not one long chain
  float part[kMaxNV];
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) {
    const int vi = lane + i * LANES;
    part[i] = 0.f;
    if (i < nv && vi < nvec && active) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = repro::to_f32(buf[i].v[e]);
        part[i] += f * f;
      }
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) ss += part[i];
  // every thread reaches the reductions (inactive rows add 0)
#pragma unroll
  for (int o = (LANES < 32 ? LANES : 32) / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (LANES > 32) {
    constexpr int kWarps = LANES / 32;
    __shared__ float warp_sums[block_threads<LANES>() / 32];
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ss += warp_sums[sub * kWarps + w];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (!active) return;
  V* yr = reinterpret_cast<V*>(y + row * d);
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i) {
    const int vi = lane + i * LANES;
    if (i < nv && vi < nvec) {
      V out;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        out.v[e] = repro::from_f32<T>(repro::to_f32(buf[i].v[e]) * r *
                                      repro::to_f32(sbuf[i].v[e]));
      yr[vi] = out;
    }
  }
}

template <typename T, typename TS, int VEC, int LANES>
cudaError_t launch(const void* x, const void* scale, void* y, long long rows,
                   int d, int nv, int rows_per_block, float eps,
                   cudaStream_t stream) {
  constexpr int kThreads = block_threads<LANES>();
  // a vector group never spans more than kMaxVecSpan elements (MAX_D =
  // 8192 at 8 vectors a lane): wider ones are not built
  if constexpr (VEC > 1 && LANES * VEC > kMaxVecSpan) {
    return cudaErrorInvalidValue;
  } else {
    // the shape must cover the row once: every vector has a slot, and no
    // lane's last slot lies wholly past the row
    if (rows_per_block != kThreads / LANES || nv < 1 || nv > kMaxNV ||
        d % VEC != 0 || LANES * nv < d / VEC || LANES * (nv - 1) >= d / VEC)
      return cudaErrorInvalidValue;
    const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_kernel<T, TS, VEC, LANES>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const TS*>(scale),
            static_cast<T*>(y), rows, d, nv, eps);
    return cudaGetLastError();
  }
}

template <typename T, typename TS, int VEC>
cudaError_t dispatch_lanes(int lanes, const void* x, const void* scale,
                           void* y, long long rows, int d, int nv,
                           int rows_per_block, float eps,
                           cudaStream_t stream) {
  switch (lanes) {
    case 8:   return launch<T, TS, VEC, 8>(x, scale, y, rows, d, nv, rows_per_block, eps, stream);
    case 16:  return launch<T, TS, VEC, 16>(x, scale, y, rows, d, nv, rows_per_block, eps, stream);
    case 32:  return launch<T, TS, VEC, 32>(x, scale, y, rows, d, nv, rows_per_block, eps, stream);
    case 64:  return launch<T, TS, VEC, 64>(x, scale, y, rows, d, nv, rows_per_block, eps, stream);
    case 128: return launch<T, TS, VEC, 128>(x, scale, y, rows, d, nv, rows_per_block, eps, stream);
    case 256: return launch<T, TS, VEC, 256>(x, scale, y, rows, d, nv, rows_per_block, eps, stream);
    case 512: return launch<T, TS, VEC, 512>(x, scale, y, rows, d, nv, rows_per_block, eps, stream);
    case 1024: return launch<T, TS, VEC, 1024>(x, scale, y, rows, d, nv, rows_per_block, eps, stream);
    default:  return cudaErrorInvalidValue;
  }
}

template <typename T, typename TS>
cudaError_t dispatch_vec(int vec, int lanes, const void* x,
                         const void* scale, void* y, long long rows, int d,
                         int nv, int rows_per_block, float eps,
                         cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == 1)
    return dispatch_lanes<T, TS, 1>(lanes, x, scale, y, rows, d, nv,
                                    rows_per_block, eps, stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  if (vec != kVec || !aligned) return cudaErrorInvalidValue;
  return dispatch_lanes<T, TS, kVec>(lanes, x, scale, y, rows, d, nv,
                                     rows_per_block, eps, stream);
}

}  // namespace

// x, y: (rows, d) contiguous, same dtype; scale: (d,).  The launch shape
// (lanes per row, vectors per lane, rows per block, elements per vector)
// comes from kernels/rmsnorm.py: launch_shape.  Returns the cudaError_t of
// the launch (0 on success; cudaErrorInvalidValue for a shape this file
// was not built for).
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             long long rows, int d, int x_dtype,
                             int scale_dtype, float eps, int lanes, int nv,
                             int rows_per_block, int vec, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == repro::kFloat32 && scale_dtype == repro::kFloat32)
    return dispatch_vec<float, float>(vec, lanes, x, scale, y, rows, d, nv,
                                      rows_per_block, eps, s);
  if (x_dtype == repro::kFloat32 && scale_dtype == repro::kBFloat16)
    return dispatch_vec<float, bf16>(vec, lanes, x, scale, y, rows, d, nv,
                                     rows_per_block, eps, s);
  if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kFloat32)
    return dispatch_vec<bf16, float>(vec, lanes, x, scale, y, rows, d, nv,
                                     rows_per_block, eps, s);
  if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kBFloat16)
    return dispatch_vec<bf16, bf16>(vec, lanes, x, scale, y, rows, d, nv,
                                    rows_per_block, eps, s);
  return cudaErrorInvalidValue;
}
