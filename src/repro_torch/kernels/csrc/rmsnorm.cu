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
// vectors, so a lane keeps several loads in flight.  Vector groups span at
// most kMaxVecSpan = 2048 elements, so this register-held body takes rows of
// up to 16,384 elements in vectors (bf16 256 lanes x 8, fp32 512 x 8; at
// command-r-plus's 12,288: 256 x 6 and 512 x 6) and 8,192 in single
// elements (1024 lanes x 8).  A lane starts all its
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
// Wider rows (past 16,384 in vectors, past 8,192 in single elements, as a
// width that is no multiple of the vector or an unaligned pointer gives)
// walk the looped body, rmsnorm_loop_kernel: a block of kLoopLanes = 1024
// threads a row, the sum of squares in one pass over the row, then the
// scale pass reading the row again (from L2: a row is at most tens of KB);
// the block's sums meet in a fixed order (block_sum2).  It moves the row
// twice through L2, once from HBM; ptxas gives it 28 registers (its
// backward 32), no spills.
//
// Backward (rmsnorm_bwd_kernel, then rmsnorm_dscale_kernel): with
// r = rsqrt(mean(x^2) + eps) and xh = x * r, dx = r * (g*s - xh *
// mean(g*s*xh)) and dscale = sum over rows of g * xh, all in fp32.  The
// reference defines no backward for its Pallas kernel; this is the
// gradient of the same function.  Bound: bytes, x, g and dx once each,
// scale and dscale.
//   * Rows: the forward's lane groups, at most 4 16-byte vectors a lane
//     (max_nv_bwd; 8 single elements), so a block of 256 threads keeps
//     its registers under 128 a thread; vector groups span at most
//     kMaxVecSpanBwd = 4096 elements, rows up to 16,384 (bf16 512 lanes x
//     4 vectors, fp32 1024 x 4, both one row a block).  Wider rows walk
//     rmsnorm_bwd_loop_kernel: 1024 threads a row, two passes over it as
//     the looped forward, each thread adding g * xh of its own columns to
//     the block's partial row in device memory, rows in order.  One
//     block an SM of an H100 (kernels/rmsnorm.py: bwd_blocks), each
//     walking its row groups with the grid's stride; the SM's 8 warps
//     overlap one's loads with another's math.  Scale is read from the
//     cache where it is used.  Each lane adds g * xh of its rows to its own
//     dscale partials.  On an H100 neither a second row group loaded ahead
//     into registers, nor a ring of 4 row groups in shared memory filled
//     by TMA bulk copies, nor 2 or 3 blocks an SM was faster than this
//     plain form: what remains is HBM's rate and the latency of the first
//     loads of a launch that moves some 190 KB an SM at (1024, 4096) bf16.
//   * Partials: one fp32 row a block (132 rows at most, where the first
//     design wrote one a 4-row block: 256 at (1024, 4096)).  The block's
//     row groups meet in shared memory in group order, after one barrier.
//   * dscale: rmsnorm_dscale_kernel spreads the sum over the card: a
//     block owns 32 columns, its 8 warps each sum every 8th partial row
//     in order, and warp 0 sums the 8 in order.  It is launched as a
//     programmatic dependent of the row kernel (griddepcontrol), so its
//     blocks are in place and waiting when the row kernel ends.  No float
//     atomics: the order is a function of the shape alone, so dscale is
//     the same on every run.
//
// Split rows (repro_rmsnorm_split, repro_rmsnorm_split_bwd): a row split
// over ranks, each holding d of its d_total columns (mamba2's gated norm
// over d_inner under tensor parallelism, the heads over `model`).  It
// replaces no TPU kernel of its own: the reference's Pallas RMSNorm runs
// whole rows, and GSPMD partitions the jnp norm of the tensor-parallel
// mixer with one all-reduce of the sum of squares.  This is that
// partition, on the same row loops: every body above takes a template
// mode (kSplit).  kSumSq runs the row loop's loads and sums and writes
// each row's sum over this rank's columns (the forward: sum(x^2); the
// backward: sum(x^2) and sum(g*s*x), two floats a row) and writes nothing
// else; the caller all-reduces them over the ranks; kApply reads the
// summed values and runs the rest of the body with d_total in place of d
// (the forward: y; the backward: dx, the partial rows and dscale, this
// rank's columns of it).  At d_total = d, with one rank, the two launches
// give the whole-row kernel's bits: the same sums in the same order.
// Bound: bytes, as the whole-row kernel, plus one read of x (and g) more
// in the second launch; the sums are 4 or 8 bytes a row.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxNV = 8;       // vectors held in registers per lane
constexpr int kMinBlock = 256;  // threads a block, or LANES if wider
constexpr int kMaxVecSpan = 2048;  // LANES * VEC of the widest vector build
constexpr int kMaxVecSpanBwd = 4096;  // the same for the backward
constexpr int kMaxLanes = 1024;    // the widest lane group
constexpr int kLoopLanes = 1024;   // threads a block of the looped bodies
constexpr int kDscaleCols = 32;    // columns a block of the dscale pass
constexpr int kDscaleWarps = 8;    // warps a block of the dscale pass

constexpr int kMaxSmemBwd = 32 << 10;  // the backward's group sums, fp32

// the row bodies' modes: the whole row here; this rank's share of a split
// row's sums written to ``sums``; the rest of the body from the summed ones
enum Split : int { kWhole = 0, kSumSq = 1, kApply = 2 };

// vectors a lane holds in the backward: 4 of 16 bytes, or 8 elements
template <int VEC>
__host__ __device__ constexpr int max_nv_bwd() {
  return VEC > 1 ? 4 : 8;
}

// the widest row the register-held bodies take (16,384 in vectors of 16
// bytes, 8,192 in single elements); wider rows walk the looped bodies
template <int VEC, bool kBwd>
constexpr long long max_register_d() {
  return VEC == 1 ? static_cast<long long>(kMaxLanes) * kMaxNV
         : kBwd   ? static_cast<long long>(kMaxVecSpanBwd) * max_nv_bwd<VEC>()
                  : static_cast<long long>(kMaxVecSpan) * kMaxNV;
}

template <int LANES>
__host__ __device__ constexpr int block_threads() {
  return LANES > kMinBlock ? LANES : kMinBlock;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, typename TS, int VEC, int LANES, int kSplit>
__global__ void __launch_bounds__(block_threads<LANES>())
rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
               T* __restrict__ y, float* __restrict__ sums, long long rows,
               int d, int nv, float eps, int d_total) {
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
  if constexpr (kSplit != kSumSq) {
#pragma unroll
    for (int i = 0; i < kMaxNV; ++i) {
      const int vi = lane + i * LANES;
      if (active && i < nv && vi < nvec) sbuf[i] = sr[vi];
    }
  }
  float ss = 0.f;
  if constexpr (kSplit != kApply) {
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
  }
  if constexpr (kSplit == kSumSq) {
    if (active && lane == 0) sums[row] = ss;
    return;
  }
  const float r =
      kSplit == kApply
          ? rsqrtf(sums[active ? row : 0] / static_cast<float>(d_total) + eps)
          : rsqrtf(ss / static_cast<float>(d) + eps);

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

template <typename T, typename TS, int VEC, int LANES, int kSplit>
__global__ void __launch_bounds__(block_threads<LANES>())
rmsnorm_bwd_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ partial, float* __restrict__ sums,
                   long long rows, int d, int nv, float eps, int d_total) {
  using V = Vec<T, VEC>;
  using VS = Vec<TS, VEC>;
  constexpr int kThreads = block_threads<LANES>();
  constexpr int kRows = kThreads / LANES;
  constexpr int NV = max_nv_bwd<VEC>();
  __shared__ float warp_sums[2][kThreads / 32];   // wide groups' sums
  const int lane = threadIdx.x % LANES;
  const int sub = threadIdx.x / LANES;
  const int nvec = d / VEC;
  auto has = [&](int i) { return i < nv && lane + i * LANES < nvec; };
  // scale at this lane's columns, read where it is used (the cache keeps
  // it: d elements for the whole grid)
  const VS* sr = reinterpret_cast<const VS*>(scale);

  float acc[NV][VEC];                    // this lane's dscale partials
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;

  // the loop runs the same number of times in every thread of the block
  // the dscale pass may start to take its places on the SMs
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (long long row0 = static_cast<long long>(blockIdx.x) * kRows;
       row0 < rows; row0 += static_cast<long long>(gridDim.x) * kRows) {
    const long long row = row0 + sub;
    const bool active = row < rows;
    V xb[NV], gb[NV];
    if (active) {
      const V* xr = reinterpret_cast<const V*>(x + row * d);
      const V* gr = reinterpret_cast<const V*>(g + row * d);
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (has(i)) {
          xb[i] = xr[lane + i * LANES];
          gb[i] = gr[lane + i * LANES];
        }
    }
    float ss = 0.f, gsx = 0.f;           // sum(x^2), sum(g*s*x)
    if constexpr (kSplit != kApply) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (active && has(i)) {
          const VS sv = sr[lane + i * LANES];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xf = repro::to_f32(xb[i].v[e]);
            ss += xf * xf;
            gsx += repro::to_f32(gb[i].v[e]) * repro::to_f32(sv.v[e]) * xf;
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
        __syncthreads();                 // read before the next row writes
      }
    }
    if constexpr (kSplit == kSumSq) {
      if (active && lane == 0) {
        sums[2 * row] = ss;
        sums[2 * row + 1] = gsx;
      }
      continue;
    }
    float dn = static_cast<float>(d);
    if constexpr (kSplit == kApply) {
      if (active) {
        ss = sums[2 * row];
        gsx = sums[2 * row + 1];
      }
      dn = static_cast<float>(d_total);
    }
    const float r = rsqrtf(ss / dn + eps);
    const float mean_gsxh = r * gsx / dn;
    if (!active) continue;
    V* dxr = reinterpret_cast<V*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (has(i)) {
        const VS sv = sr[lane + i * LANES];
        V out;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = repro::to_f32(xb[i].v[e]) * r;
          const float gf = repro::to_f32(gb[i].v[e]);
          out.v[e] = repro::from_f32<T>(
              r * (gf * repro::to_f32(sv.v[e]) - xh * mean_gsxh));
          acc[i][e] += gf * xh;
        }
        dxr[lane + i * LANES] = out;
      }
    }
  }

  if constexpr (kSplit == kSumSq) return;
  // the block's row groups in group order, then one partial row a block
  float* prow = partial + static_cast<long long>(blockIdx.x) * d;
  if constexpr (kRows > 1) {
    extern __shared__ float group_sums[];  // kRows x d
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (has(i)) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          group_sums[sub * d + (lane + i * LANES) * VEC + e] = acc[i][e];
      }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float sum = 0.f;
#pragma unroll 4
      for (int s = 0; s < kRows; ++s) sum += group_sums[s * d + c];
      prow[c] = sum;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (has(i)) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          prow[(lane + i * LANES) * VEC + e] = acc[i][e];
      }
  }
}

// dscale[c] = the sum of the blocks' partials of column c: a block owns
// kDscaleCols columns; warp w sums partial rows w, w + kDscaleWarps, ...
// in order, then the warps' sums are added in warp order
template <typename TS>
__global__ void __launch_bounds__(kDscaleCols * kDscaleWarps)
rmsnorm_dscale_kernel(const float* __restrict__ partial,
                      TS* __restrict__ dscale, int blocks, int d) {
  __shared__ float sums[kDscaleWarps][kDscaleCols];
  // the row kernel's partials are complete and visible after this
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x % kDscaleCols, w = threadIdx.x / kDscaleCols;
  const int c = blockIdx.x * kDscaleCols + lane;
  float sum = 0.f;
  if (c < d)
    for (int b = w; b < blocks; b += kDscaleWarps)
      sum += partial[static_cast<long long>(b) * d + c];
  sums[w][lane] = sum;
  __syncthreads();
  if (w == 0 && c < d) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kDscaleWarps; ++i) total += sums[i][lane];
    dscale[c] = repro::from_f32<TS>(total);
  }
}

// The sums of v.x and v.y over a block of kLoopLanes threads in a fixed
// order: each warp's by shuffles (lane 0's result kept), then the warps'
// in warp order; every thread gets the same two sums.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll 8
  for (int w = 0; w < kLoopLanes / 32; ++w) {
    s.x += warp_sums[w].x;
    s.y += warp_sums[w].y;
  }
  __syncthreads();                       // read before the next row writes
  return s;
}

// The looped forward, for rows wider than the register-held body takes: a
// block a row, its threads walking the row's vectors; the scale pass reads
// the row again (from L2: a row is at most a few tens of KB).
template <typename T, typename TS, int VEC, int kSplit>
__global__ void __launch_bounds__(kLoopLanes)
rmsnorm_loop_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                    T* __restrict__ y, float* __restrict__ sums, int d,
                    float eps, int d_total) {
  using V = Vec<T, VEC>;
  using VS = Vec<TS, VEC>;
  __shared__ float2 warp_sums[kLoopLanes / 32];
  const long long row = blockIdx.x;
  const int nvec = d / VEC;
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  const VS* sr = reinterpret_cast<const VS*>(scale);
  float r;
  if constexpr (kSplit == kApply) {
    r = rsqrtf(sums[row] / static_cast<float>(d_total) + eps);
  } else {
    float ss = 0.f;
    for (int vi = threadIdx.x; vi < nvec; vi += kLoopLanes) {
      const V b = xr[vi];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = repro::to_f32(b.v[e]);
        ss += f * f;
      }
    }
    const float total = block_sum2(make_float2(ss, 0.f), warp_sums).x;
    if constexpr (kSplit == kSumSq) {
      if (threadIdx.x == 0) sums[row] = total;
      return;
    }
    r = rsqrtf(total / static_cast<float>(d) + eps);
  }
  V* yr = reinterpret_cast<V*>(y + row * d);
  for (int vi = threadIdx.x; vi < nvec; vi += kLoopLanes) {
    const V b = xr[vi];
    const VS sv = sr[vi];
    V out;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out.v[e] = repro::from_f32<T>(repro::to_f32(b.v[e]) * r *
                                    repro::to_f32(sv.v[e]));
    yr[vi] = out;
  }
}

// p[0 .. VEC) += v, in 16-byte pieces where VEC allows (p 16-byte aligned)
template <int VEC>
__device__ __forceinline__ void add_to(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      float4 a = *reinterpret_cast<float4*>(p + e);
      a.x += v[e];
      a.y += v[e + 1];
      a.z += v[e + 2];
      a.w += v[e + 3];
      *reinterpret_cast<float4*>(p + e) = a;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] += v[e];
  }
}

// The looped backward: blocks walk their rows with the grid's stride as the
// register-held backward does, a row at a time; each thread adds g * xh of
// its columns to the block's partial row in device memory (its own
// columns only, rows in order, so the sums keep a fixed order).
template <typename T, typename TS, int VEC, int kSplit>
__global__ void __launch_bounds__(kLoopLanes)
rmsnorm_bwd_loop_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                        const T* __restrict__ g, T* __restrict__ dx,
                        float* __restrict__ partial, float* __restrict__ sums,
                        long long rows, int d, float eps, int d_total) {
  using V = Vec<T, VEC>;
  using VS = Vec<TS, VEC>;
  __shared__ float2 warp_sums[kLoopLanes / 32];
  const int nvec = d / VEC;
  const VS* sr = reinterpret_cast<const VS*>(scale);
  float* prow = partial + static_cast<long long>(blockIdx.x) * d;
  if constexpr (kSplit != kSumSq) {
    for (int vi = threadIdx.x; vi < nvec; vi += kLoopLanes)
#pragma unroll
      for (int e = 0; e < VEC; ++e) prow[vi * VEC + e] = 0.f;
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const V* xr = reinterpret_cast<const V*>(x + row * d);
    const V* gr = reinterpret_cast<const V*>(g + row * d);
    float2 t;                              // sum(x^2), sum(g*s*x)
    if constexpr (kSplit == kApply) {
      t = make_float2(sums[2 * row], sums[2 * row + 1]);
    } else {
      float ss = 0.f, gsx = 0.f;
      for (int vi = threadIdx.x; vi < nvec; vi += kLoopLanes) {
        const V xb = xr[vi], gb = gr[vi];
        const VS sv = sr[vi];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xf = repro::to_f32(xb.v[e]);
          ss += xf * xf;
          gsx += repro::to_f32(gb.v[e]) * repro::to_f32(sv.v[e]) * xf;
        }
      }
      t = block_sum2(make_float2(ss, gsx), warp_sums);
    }
    if constexpr (kSplit == kSumSq) {
      if (threadIdx.x == 0) {
        sums[2 * row] = t.x;
        sums[2 * row + 1] = t.y;
      }
      continue;
    }
    const float dn = static_cast<float>(kSplit == kApply ? d_total : d);
    const float r = rsqrtf(t.x / dn + eps);
    const float mean_gsxh = r * t.y / dn;
    V* dxr = reinterpret_cast<V*>(dx + row * d);
    for (int vi = threadIdx.x; vi < nvec; vi += kLoopLanes) {
      const V xb = xr[vi], gb = gr[vi];
      const VS sv = sr[vi];
      V out;
      float gxh[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = repro::to_f32(xb.v[e]) * r;
        const float gf = repro::to_f32(gb.v[e]);
        out.v[e] = repro::from_f32<T>(
            r * (gf * repro::to_f32(sv.v[e]) - xh * mean_gsxh));
        gxh[e] = gf * xh;
      }
      dxr[vi] = out;
      add_to(prow + vi * VEC, gxh);
    }
  }
}

// One launch of either direction.  The forward reads x and scale and
// writes y; the backward (g != nullptr) also reads g, writes dx into y,
// the blocks' partials and dscale.  A split row (split != kWhole) writes
// or reads ``sums`` (rows floats forward, 2 rows backward) and normalises
// over d_total columns.
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
  float* sums = nullptr;
  int split = kWhole;
  int d_total = 0;
};

// the shape must cover the row once: every vector has a slot, and no
// lane's last slot lies wholly past the row
inline bool covers(const Args& a, int lanes, int rows_per_block, int max_nv,
                   int vec) {
  const int nvec = a.d / vec;
  return a.rows_per_block == rows_per_block && a.nv >= 1 &&
         a.nv <= max_nv && a.d % vec == 0 &&
         static_cast<long long>(lanes) * a.nv >= nvec &&
         static_cast<long long>(lanes) * (a.nv - 1) < nvec;
}

// the dscale pass over the backward's partial rows, launched as a
// programmatic dependent of the row kernel: its blocks take their places
// while the row kernel runs and wait for it there (griddepcontrol.wait),
// so the launch's latency is hidden
template <typename TS>
cudaError_t launch_dscale(const Args& a) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.d + kDscaleCols - 1) / kDscaleCols);
  cfg.blockDim = dim3(kDscaleCols * kDscaleWarps);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rmsnorm_dscale_kernel<TS>,
                            static_cast<const float*>(a.partial),
                            static_cast<TS*>(a.dscale), a.blocks, a.d);
}

// the backward's grid: at least one block, at most one a row group (the
// sums pass writes no partial rows)
inline bool bwd_grid_ok(const Args& a) {
  const long long groups = (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  return a.blocks >= 1 && a.blocks <= groups &&
         (a.partial != nullptr || a.split == kSumSq);
}

template <typename T, typename TS, int VEC, int LANES, int kSplit>
cudaError_t launch_fwd(const Args& a) {
  constexpr int kThreads = block_threads<LANES>();
  // a vector group never spans more than kMaxVecSpan elements (16,384 at 8
  // vectors a lane): wider ones are not built
  if constexpr (VEC > 1 && LANES * VEC > kMaxVecSpan) {
    return cudaErrorInvalidValue;
  } else {
    if (!covers(a, LANES, kThreads / LANES, kMaxNV, VEC))
      return cudaErrorInvalidValue;
    const long long blocks =
        (a.rows + a.rows_per_block - 1) / a.rows_per_block;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_kernel<T, TS, VEC, LANES, kSplit>
        <<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
            static_cast<const T*>(a.x), static_cast<const TS*>(a.scale),
            static_cast<T*>(a.y), a.sums, a.rows, a.d, a.nv, a.eps,
            a.d_total);
    return cudaGetLastError();
  }
}

template <typename T, typename TS, int VEC, int LANES, int kSplit>
cudaError_t launch_bwd(const Args& a) {
  constexpr int kThreads = block_threads<LANES>();
  // at most 4 vectors a lane: 16,384 needs vector groups of 4096
  if constexpr (VEC > 1 && LANES * VEC > kMaxVecSpanBwd) {
    return cudaErrorInvalidValue;
  } else {
    if (!covers(a, LANES, kThreads / LANES, max_nv_bwd<VEC>(), VEC) ||
        !bwd_grid_ok(a))
      return cudaErrorInvalidValue;
    constexpr int kRows = kThreads / LANES;
    const size_t smem = kRows > 1 ? sizeof(float) * kRows * a.d : 0;
    if (smem > kMaxSmemBwd) return cudaErrorInvalidValue;
    rmsnorm_bwd_kernel<T, TS, VEC, LANES, kSplit>
        <<<a.blocks, kThreads, kSplit == kSumSq ? 0 : smem, a.stream>>>(
            static_cast<const T*>(a.x), static_cast<const TS*>(a.scale),
            static_cast<const T*>(a.g), static_cast<T*>(a.y), a.partial,
            a.sums, a.rows, a.d, a.nv, a.eps, a.d_total);
    if constexpr (kSplit == kSumSq) return cudaGetLastError();
    return launch_dscale<TS>(a);
  }
}

template <typename T, typename TS, int VEC, int LANES, int kSplit>
cudaError_t launch_dir(const Args& a) {
  return a.g == nullptr ? launch_fwd<T, TS, VEC, LANES, kSplit>(a)
                        : launch_bwd<T, TS, VEC, LANES, kSplit>(a);
}

template <typename T, typename TS, int VEC, int LANES>
cudaError_t launch(const Args& a) {
  switch (a.split) {
    case kWhole:  return launch_dir<T, TS, VEC, LANES, kWhole>(a);
    case kSumSq:  return launch_dir<T, TS, VEC, LANES, kSumSq>(a);
    case kApply:  return launch_dir<T, TS, VEC, LANES, kApply>(a);
    default:      return cudaErrorInvalidValue;
  }
}

// rows wider than the register-held bodies take: kLoopLanes threads a row,
// one row a block
template <typename T, typename TS, int VEC, int kSplit>
cudaError_t launch_loop_dir(const Args& a) {
  if (a.g == nullptr) {
    if (a.rows > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_loop_kernel<T, TS, VEC, kSplit>
        <<<static_cast<unsigned>(a.rows), kLoopLanes, 0, a.stream>>>(
            static_cast<const T*>(a.x), static_cast<const TS*>(a.scale),
            static_cast<T*>(a.y), a.sums, a.d, a.eps, a.d_total);
    return cudaGetLastError();
  }
  if (!bwd_grid_ok(a)) return cudaErrorInvalidValue;
  rmsnorm_bwd_loop_kernel<T, TS, VEC, kSplit>
      <<<a.blocks, kLoopLanes, 0, a.stream>>>(
          static_cast<const T*>(a.x), static_cast<const TS*>(a.scale),
          static_cast<const T*>(a.g), static_cast<T*>(a.y), a.partial,
          a.sums, a.rows, a.d, a.eps, a.d_total);
  if constexpr (kSplit == kSumSq) return cudaGetLastError();
  return launch_dscale<TS>(a);
}

template <typename T, typename TS, int VEC>
cudaError_t launch_loop(int lanes, const Args& a) {
  if (lanes != kLoopLanes || !covers(a, kLoopLanes, 1, 1 << 30, VEC))
    return cudaErrorInvalidValue;
  switch (a.split) {
    case kWhole:  return launch_loop_dir<T, TS, VEC, kWhole>(a);
    case kSumSq:  return launch_loop_dir<T, TS, VEC, kSumSq>(a);
    case kApply:  return launch_loop_dir<T, TS, VEC, kApply>(a);
    default:      return cudaErrorInvalidValue;
  }
}

template <typename T, typename TS, int VEC>
cudaError_t dispatch_lanes(int lanes, const Args& a) {
  const long long widest = a.g == nullptr ? max_register_d<VEC, false>()
                                          : max_register_d<VEC, true>();
  if (a.d > widest) return launch_loop<T, TS, VEC>(lanes, a);
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

// A row split over ranks, this rank holding d of its d_total columns:
// split 1 (kSumSq) writes sums[row] = sum(x^2) over them; split 2
// (kApply) writes y from the sums all-reduced over the ranks.  x, y, scale
// and the launch shape as repro_rmsnorm's; sums (rows,) fp32.
extern "C" int repro_rmsnorm_split(const void* x, const void* scale, void* y,
                                   void* sums, long long rows, int d,
                                   int d_total, int split, int x_dtype,
                                   int scale_dtype, float eps, int lanes,
                                   int nv, int rows_per_block, int vec,
                                   void* stream) {
  if (sums == nullptr || d_total < d || (split != kSumSq && split != kApply))
    return cudaErrorInvalidValue;
  Args a{x, scale, nullptr, y, nullptr, nullptr, rows, d, nv,
         rows_per_block, 0, eps, static_cast<cudaStream_t>(stream)};
  a.sums = static_cast<float*>(sums);
  a.split = split;
  a.d_total = d_total;
  return dispatch(x_dtype, scale_dtype, vec, lanes, a);
}

// Its backward: split 1 writes sums[2 row] = sum(x^2) and sums[2 row + 1]
// = sum(g * scale * x) over this rank's columns; split 2 reads them
// all-reduced and writes dx and this rank's dscale (its columns), through
// the partial rows as repro_rmsnorm_bwd.  sums (rows, 2) fp32; partial may
// be null for split 1.
extern "C" int repro_rmsnorm_split_bwd(const void* x, const void* scale,
                                       const void* g, void* dx, void* partial,
                                       void* dscale, void* sums,
                                       long long rows, int d, int d_total,
                                       int split, int x_dtype,
                                       int scale_dtype, float eps, int lanes,
                                       int nv, int rows_per_block, int vec,
                                       int blocks, void* stream) {
  if (g == nullptr || sums == nullptr || d_total < d ||
      (split != kSumSq && split != kApply))
    return cudaErrorInvalidValue;
  Args a{x, scale, g, dx, static_cast<float*>(partial), dscale, rows, d, nv,
         rows_per_block, blocks, eps, static_cast<cudaStream_t>(stream)};
  a.sums = static_cast<float*>(sums);
  a.split = split;
  a.d_total = d_total;
  return dispatch(x_dtype, scale_dtype, vec, lanes, a);
}
