// Flash attention forward for Hopper (sm_90a): online softmax, GQA,
// causal or not.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel), with its semantics kept exactly:
//   * top-left causal mask, q_pos >= k_pos, both counted from 0 (also when
//     S != T);
//   * kv tiles above the diagonal are skipped;
//   * padded keys are masked with k_pos < T, ragged S and T are masked
//     here, never padded on the host;
//   * the mask value is the finite -1e30, and the denominator is clamped
//     at 1e-30;
//   * the running max m, sum l and the accumulator stay in fp32.
// GQA reads kv head h / (H / Hkv) directly instead of materialising the
// repeated kv heads (src/repro/kernels/ops.py:24-27 does jnp.repeat).
//
// Bound on an H100: operations, 4*B*H*D*(unmasked q,k pairs) flops (QK^T
// plus PV; about half of S*T when causal) at 989 TFLOP/s bf16; the bytes
// (q, k, v, o once each) are small beside them.  The TPU kernel's grid is
// (B, H, q blocks, kv blocks) with the kv axis sequential, carrying m, l
// and acc in VMEM from one grid step to the next; here one block owns one
// (head, batch, q tile) and walks the kv tiles in a loop, m, l and acc in
// registers.
//
// bf16: the tensor-core body (flash_fwd_wgmma_kernel).
//   * Tiles: a block owns BQ = 128 q rows as two consumer warpgroups of 64
//     rows and walks kv tiles of BK = 64 keys.  Q tiles are launched last
//     first (grid z reversed), so the causal blocks with the most work
//     start first.
//   * Copies: one producer warpgroup; one of its threads keeps a ring of four
//     K/V stages full with TMA (cp.async.bulk.tensor over 4-D tensor maps
//     of the strided (B, H, S, D) views, completion on an mbarrier per
//     stage; rows past S or T arrive as zeros).  A consumer warp releases
//     a stage on a second mbarrier once its PV product has read it.  No
//     block barrier runs inside the loop.
//   * Shared memory, all bf16: the ring (BK x D a K or V tile) and Q (BQ x
//     D) for the whole block, 160 KB at D = 128.  A tile is stored in
//     column blocks of 128-byte rows (64-byte and 32-byte at D = 32 and
//     16), swizzled as TMA writes them, so K serves QK^T as a K-major
//     operand and the same V layout serves PV as an MN-major (transposed)
//     one.
//   * QK^T: wgmma m64n64k16, A = Q and B = the K tile, both from shared
//     memory through descriptors, fp32 accumulators in registers (a bf16
//     product summed in fp32 is exact, so this matches the fp32
//     specification up to summation order).
//   * Softmax in registers on the accumulator fragments: scale, mask (only
//     on tiles that cross the diagonal or T), row max and sum with quad
//     shuffles, exp2 (ex2.approx) with log2(e) folded into the scale.
//   * PV: wgmma m64n{D}k16 with A = P from registers (the m64nN
//     accumulator layout of S is the register-A layout of the m64k16
//     slices) and B = the V tile from shared memory, transposed.  P is
//     split into hi = bf16(P) and lo = bf16(P - hi), two wgmmas into the
//     same fp32 accumulator: P keeps about 16 significant bits, as the
//     reference's fp32 P needs (a single bf16 P moves outputs by about one
//     bf16 rounding step, the whole of the check's tolerance).
//   * Pipeline inside a warpgroup: S of tile t and PV of tile t - 1 go to
//     the tensor cores together, and the softmax of tile t runs while PV
//     is still on them.  The wgmma calls sit on straight-line code, never
//     under a branch, so the compiler keeps them asynchronous.
//   * Registers: the producer warpgroup gives all but 40 of its registers
//     to the consumers (setmaxnreg), which may use 232 each.
// fp32: the FMA body (flash_fwd_kernel): BQ = BK = 64, 256 threads, each
// owning a 4x4 block of scores and a 4 x D/16 block of the output, the
// products as fp32 FMAs from shared memory.  A TF32 tensor-core path would
// miss the fp32 specification by design.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "common.cuh"

namespace {


constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Strides {            // element strides of a (B, H, S, D) view
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int group,
                 int S, int Tk, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale, int causal) {
  constexpr int DP = D + 1;     // padded rows: conflict-free column reads
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x DP
  float* Ks = Qs + BQ * DP;     // BK x DP
  float* Vs = Ks + BK * DP;     // BK x D
  float* Ps = Vs + BK * D;      // BQ x PP

  const int tid = threadIdx.x;
  const int ty = tid / 16;      // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;      // score cols tx + 16*j, out cols tx + 16*j
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, s = q_start + r;
    Qs[r * DP + c] = s < S ? repro::to_f32(qb[s * qs.s + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q_start + BQ - 1) / BK + 1);  // k_start <= q_end

  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();            // Q stored / last tile's readers finished
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, t = k_start + r;
      const bool ok = t < Tk;
      Ks[r * DP + c] = ok ? repro::to_f32(kb[t * ks.s + c]) : 0.f;
      Vs[r * D + c] = ok ? repro::to_f32(vb[t * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_start + ty * 4 + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k_start + tx + 16 * j;
        const bool keep = k_pos < Tk && (!causal || q_pos >= k_pos);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      // the 16 lanes sharing ty hold one row: reduce within the half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_cur = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_cur);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_cur);
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_pos = q_start + ty * 4 + i;
    if (s_pos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[s_pos * os.s + tx + 16 * j] = repro::from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int S, int Tk, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;   // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / Hkv, S, Tk, qs, ks,
      vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int Hkv, int S, int Tk,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16:  return launch<T, 16>(q, k, v, o, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 32:  return launch<T, 32>(q, k, v, o, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 64:  return launch<T, 64>(q, k, v, o, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    default:  return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TBQ = 128;                  // q rows a block: 2 warpgroups
constexpr int TBK = 64;                   // keys a kv tile
constexpr int kConsumers = 256;           // 2 consumer warpgroups
constexpr int kThreadsTC = kConsumers + 128;  // + 1 producer warpgroup
// registers a thread after the producer hands most of its own over
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kStages = 4;                // K/V ring
constexpr float kLog2e = 1.4426950408889634f;
// V is read by PV as an MN-major (transposed) B operand
constexpr int kTransV = 1;

// A tile of R rows x D bf16 lies in shared memory as D*2/kRow column
// blocks, each R rows of kRow bytes, swizzled the way TMA writes them (and
// wgmma reads them) for a kRow-byte swizzle: 128 bytes at D >= 64.
template <int D>
struct Layout {
  static constexpr int kRow = D * 2 < 128 ? D * 2 : 128;   // bytes
  static constexpr int kBlocks = D * 2 / kRow;             // column blocks
  static constexpr int kSlices = kRow / 32;     // k16 slices a block row
  static constexpr uint64_t kSwizzle = kRow == 128 ? 1 : kRow == 64 ? 2 : 3;
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * D * 2;
  }
  __host__ __device__ static constexpr int block_bytes(int rows) {
    return rows * kRow;
  }
};

template <int D>
__host__ __device__ constexpr size_t smem_bytes_tc() {
  return 1024 +                           // room to align the base
         static_cast<size_t>(Layout<D>::bytes(TBQ)) +
         static_cast<size_t>(kStages) * 2 * Layout<D>::bytes(TBK) +
         (2 * kStages + 1) * 8;           // mbarriers
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor: start address, leading and stride byte offsets
// (16-byte units) and the swizzle mode (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (swz << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: box {c0 .. c0 + box0, c1 .. c1 + box1} of head c2, batch c3 of a
// (B, H, S, D) view into shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// rows [row0, row0 + R) of one head's matrix, every column block
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int row0, int h, int b,
                                         uint32_t bar) {
  using L = Layout<D>;
#pragma unroll
  for (int blk = 0; blk < L::kBlocks; ++blk)
    tma_load(dst + blk * L::block_bytes(R), map, blk * L::kRow / 2, row0, h,
             b, bar);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (+)= A B for one m64nNk16 slice: A and B from shared memory (QK^T)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D += A B for one m64nNk16 slice: A from registers, B from shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTransV));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTransV));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTransV));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTransV));
}


// 2^x in one MUFU instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       bf16* __restrict__ o, int group, int S, int Tk,
                       Strides os, float scale, int causal) {
  using L = Layout<D>;
  constexpr int kSbo = 8 * L::kRow;       // bytes between 8-row groups
  constexpr int kTile = L::bytes(TBK);
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  // swizzled tiles need 1024-byte aligned column blocks; the ring comes
  // first, then Q, then the barriers
  const uint32_t skv = (smem_addr(smem_tc) + 1023) & ~1023u;
  const uint32_t sq = skv + kStages * 2 * kTile;
  const uint32_t bars = sq + L::bytes(TBQ);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t q_full = bars + 16 * kStages;
  // tile t's stage: its K tile, then its V tile
  auto stage = [&](int t) { return skv + (t % kStages) * 2 * kTile; };

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * TBQ;  // last tile first
  const int kvh = h / group;
  int nk = (Tk + TBK - 1) / TBK;
  if (causal) nk = min(nk, (q_start + TBQ - 1) / TBK + 1);  // k_start <= q_end

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kConsumers / 32);   // one arrival a warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else, never joined again, so that the compiler can give each
  // side its own register budget.
  if (tid >= kConsumers) {
    // producer warpgroup: one thread keeps the ring full with TMA copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, L::bytes(TBQ));
      tma_tile<D, TBQ>(sq, &q_map, q_start, h, b, q_full);
      for (int t = 0; t < nk; ++t) {
        const int s = t % kStages;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);   // stage free
        mbar_expect_tx(full(s), 2 * kTile);
        tma_tile<D, TBK>(stage(t), &k_map, t * TBK, kvh, b, full(s));
        tma_tile<D, TBK>(stage(t) + kTile, &v_map, t * TBK, kvh, b,
                         full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    // consumers: warpgroup wg owns q rows wg_start .. wg_start + 63
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    bf16* ob = o + b * os.b + h * os.h;
    const int wg_start = q_start + 64 * wg;
    const int row0 = wg_start + 16 * warp + lane / 4;
    const int rows[2] = {row0, row0 + 8};
    const int col0 = 2 * (lane % 4);
    const float scale2 = scale * kLog2e;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};                // this thread's columns only
    float s[TBK / 2];
#pragma unroll
    for (int i = 0; i < TBK / 2; ++i) s[i] = 0.f;
    uint32_t p_hi[TBK / 16][4], p_lo[TBK / 16][4];   // P of the last tile
    float alpha[2];

    // The wgmma calls sit on straight-line code (no branch around them), so
    // the compiler keeps them asynchronous.
    auto launch_qk = [&](int t) {            // S = Q K_t^T over D in k16 slices
      // descriptors advance by adding the slice's byte offset / 16; the
      // empty asm keeps the compiler from holding every slice's Q
      // descriptor in registers across the loop
      uint64_t qd = make_desc(sq + wg * 64 * L::kRow, 16, kSbo, L::kSwizzle);
      asm volatile("" : "+l"(qd));
      const uint64_t kd = make_desc(stage(t), 16, kSbo, L::kSwizzle);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int blk = kk / L::kSlices, off = (kk % L::kSlices) * 32;
        wgmma_ss<TBK>(s, qd + ((blk * L::block_bytes(TBQ) + off) >> 4),
                      kd + ((blk * L::block_bytes(TBK) + off) >> 4), kk > 0);
      }
      wgmma_commit();
    };
    auto launch_pv = [&](int t) {            // O += P V_t over its keys
      const uint64_t vd = make_desc(stage(t) + kTile, L::block_bytes(TBK),
                                    kSbo, L::kSwizzle);
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk) {
        wgmma_rs<D>(acc, p_hi[kk], vd + ((2 * kSbo * kk) >> 4));
        wgmma_rs<D>(acc, p_lo[kk], vd + ((2 * kSbo * kk) >> 4));
      }
      wgmma_commit();
    };
    // tile t's softmax on S: s becomes P (fp32), m and l move on, and alpha
    // holds the factors that rescale O
    auto softmax = [&](int t) {
      // s[4j + 2r + e]: row rows[r], key k_start + 8j + col0 + e
      const int k_start = t * TBK;
      const bool edge = k_start + TBK > Tk ||
                        (causal && k_start + TBK - 1 > wg_start);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < TBK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[4 * j + 2 * r + e] * scale2;
            if (edge) {
              const int key = k_start + 8 * j + col0 + e;
              if (key >= Tk || (causal && key > rows[r])) x = kNegInf;
            }
            s[4 * j + 2 * r + e] = x;
            mx[r] = fmaxf(mx[r], x);
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = fast_exp2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < TBK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = fast_exp2(s[4 * j + 2 * r + e] - m[r]);
            s[4 * j + 2 * r + e] = p;
            l[r] += p;
          }
    };
    // O *= alpha, then P = hi + lo in bf16: register a[r] of k16 slice kk
    // holds s[8kk + 2r], s[8kk + 2r + 1]
    auto rescale_and_split = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a0 = s[8 * kk + 2 * r], a1 = s[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a0, a1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][r] = pack_bf16(a0 - hf.x, a1 - hf.y);
        }
    };
    // this warp is done with stage t (its PV has completed)
    auto release = [&](int t) {
      if (lane == 0) mbar_arrive(empty(t % kStages));
    };

    mbar_wait(q_full, 0);
    mbar_wait(full(0), 0);
    fence_regs(s);
    wgmma_fence();
    launch_qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
    rescale_and_split();

    // Tile t: S = Q K_t^T and O += P_{t-1} V_{t-1} go to the tensor cores
    // together; tile t's softmax runs while the PV product is still on them,
    // and O is rescaled once it is done.
    for (int t = 1; t < nk; ++t) {
      mbar_wait(full(t % kStages), (t / kStages) & 1);
      fence_regs(s);
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
      launch_qk(t);
      launch_pv(t - 1);
      wgmma_wait<1>();                      // S is in; PV may still run
      fence_regs(s);
      softmax(t);
      wgmma_wait<0>();                      // O and the old P are free again
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      release(t - 1);
      rescale_and_split();
    }
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
    launch_pv(nk - 1);
    wgmma_wait<0>();
    fence_regs(acc);

    // acc[4j + 2r + e]: row rows[r], column 8j + col0 + e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      if (rows[r] >= S) continue;
      const float inv = 1.f / fmaxf(lr, 1e-30f);
      bf16* orow = ob + rows[r] * os.s;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// A 4-D tensor map over a (B, H, rows, D) bf16 view with element strides
// st (b, h, row), read in boxes of box_rows rows x one swizzle block of
// columns.  cuTensorMapEncodeTiled is looked up at run time with
// cudaGetDriverEntryPoint, so the library needs no link against libcuda.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int H,
                     int rows, int D, Strides st, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const int row_bytes = D * 2 < 128 ? D * 2 : 128;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(row_bytes / 2),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int H, int Hkv, int S, int Tk, Strides qs,
                      Strides ks, Strides vs, Strides os, float scale,
                      int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_tc<D>();
  static bool configured = false;   // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap q_map, k_map, v_map;
  cudaError_t e = make_map(&q_map, q, B, H, S, D, qs, TBQ);
  if (e == cudaSuccess) e = make_map(&k_map, k, B, Hkv, Tk, D, ks, TBK);
  if (e == cudaSuccess) e = make_map(&v_map, v, B, Hkv, Tk, D, vs, TBK);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, (S + TBQ - 1) / TBQ);
  flash_fwd_wgmma_kernel<D><<<grid, kThreadsTC, smem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), H / Hkv, S, Tk, os, scale,
      causal);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v,
                        void* o, int B, int H, int Hkv, int S, int Tk,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16:  return launch_tc<16>(q, k, v, o, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 32:  return launch_tc<32>(q, k, v, o, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 64:  return launch_tc<64>(q, k, v, o, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 128: return launch_tc<128>(q, k, v, o, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    default:  return cudaErrorInvalidValue;
  }
}

// every row start 16-byte aligned: TMA reads rows of 16-byte multiples
bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.s % 8 == 0;
}

}  // namespace

// q, o: (B, H, S, D) views; k, v: (B, Hkv, T, D) views, each given by its
// element strides over (b, h, s) with the last axis contiguous.  All four
// share one dtype.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int S, int Tk, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int dtype,
    void* stream) {
  if (H % Hkv != 0 || S < 1 || Tk < 1 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_d<float>(D, q, k, v, o, B, H, Hkv, S, Tk, qs, ks, vs, os,
                             scale, causal, s);
  if (dtype == repro::kBFloat16) {
    if (!aligned16(q, qs) || !aligned16(k, ks) || !aligned16(v, vs) ||
        !aligned16(o, os) || B > 65535 || S > 65535 * TBQ)
      return cudaErrorInvalidValue;
    return dispatch_tc(D, q, k, v, o, B, H, Hkv, S, Tk, qs, ks, vs, os,
                       scale, causal, s);
  }
  return cudaErrorInvalidValue;
}
