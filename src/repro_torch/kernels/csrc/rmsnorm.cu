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
//
// Backward (rmsnorm_bwd_kernel, then rmsnorm_dscale_kernel): with
// r = rsqrt(mean(x^2) + eps) and xh = x * r, dx = r * (g*s - xh *
// mean(g*s*xh)) and dscale = sum over rows of g * xh, all in fp32.  The
// reference defines no backward for its Pallas kernel; this is the
// gradient of the same function.  It keeps the forward's lane groups: a
// lane loads its vectors of x, g and scale, the group reduces sum(x^2) and
// sum(g*s*x) together, and the lane writes dx and adds g * xh to its own
// dscale partials.  Blocks walk the rows with a stride of the grid
// (``blocks`` from kernels/rmsnorm.py: bwd_blocks), sum their rows'
// partials in shared memory in row order and write one row of partials
// each; the second kernel sums those rows in block order, one thread a
// column.  No float atomics, so dscale is the same on every run.  Bound:
// bytes, x, g and dx once each, scale and dscale.
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
__global__ void __launch_bounds__(block_threads<LANES>())
rmsnorm_bwd_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int d,
                   int nv, float eps) {
  using V = Vec<T, VEC>;
  using VS = Vec<TS, VEC>;
  constexpr int kThreads = block_threads<LANES>();
  constexpr int kRows = kThreads / LANES;
  extern __shared__ float block_sum[];   // d floats: the block's dscale
  const int lane = threadIdx.x % LANES;
  const int sub = threadIdx.x / LANES;
  const int nvec = d / VEC;
  const VS* sr = reinterpret_cast<const VS*>(scale);

  float acc[kMaxNV][VEC];                // this lane's dscale partials
#pragma unroll
  for (int i = 0; i < kMaxNV; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;

  // the loop runs the same number of times in every thread of the block
  for (long long row0 = static_cast<long long>(blockIdx.x) * kRows;
       row0 < rows; row0 += static_cast<long long>(gridDim.x) * kRows) {
    const long long row = row0 + sub;
    const bool active = row < rows;
    const V* xr = reinterpret_cast<const V*>(x + (active ? row : 0) * d);
    const V* gr = reinterpret_cast<const V*>(g + (active ? row : 0) * d);
    V xb[kMaxNV], gb[kMaxNV];
    VS sb[kMaxNV];
#pragma unroll
    for (int i = 0; i < kMaxNV; ++i) {
      const int vi = lane + i * LANES;
      if (active && i < nv && vi < nvec) {
        xb[i] = xr[vi];
        gb[i] = gr[vi];
        sb[i] = sr[vi];
      }
    }
    float ss = 0.f, gsx = 0.f;           // sum(x^2), sum(g*s*x)
#pragma unroll
    for (int i = 0; i < kMaxNV; ++i) {
      const int vi = lane + i * LANES;
      if (active && i < nv && vi < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xf = repro::to_f32(xb[i].v[e]);
          ss += xf * xf;
          gsx += repro::to_f32(gb[i].v[e]) * repro::to_f32(sb[i].v[e]) * xf;
        }
      }
    }
#pragma unroll
    for (int o = (LANES < 32 ? LANES : 32) / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      gsx += __shfl_xor_sync(0xffffffffu, gsx, o);
    }
    if constexpr (LANES > 32) {
      constexpr int kWarps = LANES / 32;
      __shared__ float warp_sums[2][kThreads / 32];
      if (threadIdx.x % 32 == 0) {
        warp_sums[0][threadIdx.x / 32] = ss;
        warp_sums[1][threadIdx.x / 32] = gsx;
      }
      __syncthreads();
      ss = gsx = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        ss += warp_sums[0][sub * kWarps + w];
        gsx += warp_sums[1][sub * kWarps + w];
      }
      __syncthreads();                   // read before the next row writes
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float mean_gsxh = r * gsx / static_cast<float>(d);
    if (active) {
      V* dxr = reinterpret_cast<V*>(dx + row * d);
#pragma unroll
      for (int i = 0; i < kMaxNV; ++i) {
        const int vi = lane + i * LANES;
        if (i < nv && vi < nvec) {
          V out;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xh = repro::to_f32(xb[i].v[e]) * r;
            const float gf = repro::to_f32(gb[i].v[e]);
            out.v[e] = repro::from_f32<T>(
                r * (gf * repro::to_f32(sb[i].v[e]) - xh * mean_gsxh));
            acc[i][e] += gf * xh;
          }
          dxr[vi] = out;
        }
      }
    }
  }

  // the block's rows in order: group 0, then 1, ... into shared memory
  for (int s = 0; s < kRows; ++s) {
    if (sub == s) {
#pragma unroll
      for (int i = 0; i < kMaxNV; ++i) {
        const int vi = lane + i * LANES;
        if (i < nv && vi < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int col = vi * VEC + e;
            block_sum[col] = (s > 0 ? block_sum[col] : 0.f) + acc[i][e];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < d; c += kThreads)
    partial[static_cast<long long>(blockIdx.x) * d + c] = block_sum[c];
}

// dscale[c] = the sum of the blocks' partials of column c, in block order
template <typename TS>
__global__ void __launch_bounds__(256)
rmsnorm_dscale_kernel(const float* __restrict__ partial,
                      TS* __restrict__ dscale, int blocks, int d) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= d) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += partial[static_cast<long long>(b) * d + c];
  dscale[c] = repro::from_f32<TS>(sum);
}

// One launch of either direction.  The forward reads x and scale and
// writes y; the backward (g != nullptr) also reads g, writes dx into y,
// the blocks' partials and dscale.
struct Args {
  const void* x;
  const void* scale;
  const void* g;          // null: the forward
  void* y;                // y, or dx
  float* partial;         // (blocks, d) fp32 scratch of the backward
  void* dscale;
  long long rows;
  int d, nv, rows_per_block, blocks;
  float eps;
  cudaStream_t stream;
};

template <typename T, typename TS, int VEC, int LANES>
cudaError_t launch(const Args& a) {
  constexpr int kThreads = block_threads<LANES>();
  // a vector group never spans more than kMaxVecSpan elements (MAX_D =
  // 8192 at 8 vectors a lane): wider ones are not built
  if constexpr (VEC > 1 && LANES * VEC > kMaxVecSpan) {
    return cudaErrorInvalidValue;
  } else {
    const int d = a.d, nv = a.nv;
    // the shape must cover the row once: every vector has a slot, and no
    // lane's last slot lies wholly past the row
    if (a.rows_per_block != kThreads / LANES || nv < 1 || nv > kMaxNV ||
        d % VEC != 0 || LANES * nv < d / VEC || LANES * (nv - 1) >= d / VEC)
      return cudaErrorInvalidValue;
    const long long blocks =
        (a.rows + a.rows_per_block - 1) / a.rows_per_block;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (a.g == nullptr) {
      rmsnorm_kernel<T, TS, VEC, LANES>
          <<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
              static_cast<const T*>(a.x), static_cast<const TS*>(a.scale),
              static_cast<T*>(a.y), a.rows, d, nv, a.eps);
      return cudaGetLastError();
    }
    if (a.blocks < 1 || a.blocks > blocks || a.partial == nullptr)
      return cudaErrorInvalidValue;
    rmsnorm_bwd_kernel<T, TS, VEC, LANES>
        <<<a.blocks, kThreads, d * sizeof(float), a.stream>>>(
            static_cast<const T*>(a.x), static_cast<const TS*>(a.scale),
            static_cast<const T*>(a.g), static_cast<T*>(a.y), a.partial,
            a.rows, d, nv, a.eps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    rmsnorm_dscale_kernel<TS><<<(d + 255) / 256, 256, 0, a.stream>>>(
        a.partial, static_cast<TS*>(a.dscale), a.blocks, d);
    return cudaGetLastError();
  }
}

template <typename T, typename TS, int VEC>
cudaError_t dispatch_lanes(int lanes, const Args& a) {
  switch (lanes) {
    case 8:    return launch<T, TS, VEC, 8>(a);
    case 16:   return launch<T, TS, VEC, 16>(a);
    case 32:   return launch<T, TS, VEC, 32>(a);
    case 64:   return launch<T, TS, VEC, 64>(a);
    case 128:  return launch<T, TS, VEC, 128>(a);
    case 256:  return launch<T, TS, VEC, 256>(a);
    case 512:  return launch<T, TS, VEC, 512>(a);
    case 1024: return launch<T, TS, VEC, 1024>(a);
    default:   return cudaErrorInvalidValue;
  }
}

template <typename T, typename TS>
cudaError_t dispatch_vec(int vec, int lanes, const Args& a) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == 1) return dispatch_lanes<T, TS, 1>(lanes, a);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // the scale is read in vectors of kVec of its own elements
  if (vec != kVec || !aligned(a.x) || !aligned(a.y) || !aligned(a.scale) ||
      !aligned(a.g))
    return cudaErrorInvalidValue;
  return dispatch_lanes<T, TS, kVec>(lanes, a);
}

cudaError_t dispatch(int x_dtype, int scale_dtype, int vec, int lanes,
                     const Args& a) {
  using bf16 = __nv_bfloat16;
  if (x_dtype == repro::kFloat32 && scale_dtype == repro::kFloat32)
    return dispatch_vec<float, float>(vec, lanes, a);
  if (x_dtype == repro::kFloat32 && scale_dtype == repro::kBFloat16)
    return dispatch_vec<float, bf16>(vec, lanes, a);
  if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kFloat32)
    return dispatch_vec<bf16, float>(vec, lanes, a);
  if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kBFloat16)
    return dispatch_vec<bf16, bf16>(vec, lanes, a);
  return cudaErrorInvalidValue;
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
  const Args a{x, scale, nullptr, y, nullptr, nullptr, rows, d, nv,
               rows_per_block, 0, eps, static_cast<cudaStream_t>(stream)};
  return dispatch(x_dtype, scale_dtype, vec, lanes, a);
}

// The backward of repro_rmsnorm: g, dx like x; dscale like scale; partial:
// a (blocks, d) fp32 scratch, blocks from kernels/rmsnorm.py: bwd_blocks.
// Same launch shape as the forward.  Returns the cudaError_t of the
// launches.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* g, void* dx, void* partial,
                                 void* dscale, long long rows, int d,
                                 int x_dtype, int scale_dtype, float eps,
                                 int lanes, int nv, int rows_per_block,
                                 int vec, int blocks, void* stream) {
  if (g == nullptr) return cudaErrorInvalidValue;
  const Args a{x, scale, g, dx, static_cast<float*>(partial), dscale, rows,
               d, nv, rows_per_block, blocks, eps,
               static_cast<cudaStream_t>(stream)};
  return dispatch(x_dtype, scale_dtype, vec, lanes, a);
}
