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
// bf16: the tensor-core body (flash_fwd_wgmma_kernel<D>), at every D in
// {16, 32, 64, 128, 160, 256}.
//   * Tiles: a block owns BQ = 128 q rows as two consumer warpgroups of 64
//     rows and walks kv tiles of BK = 64 keys.  Q tiles are launched last
//     first (grid z reversed), so the causal blocks with the most work
//     start first.
//   * Copies: one producer warpgroup; one of its threads keeps a ring of four
//     K/V stages (two at D = 256) full with TMA (cp.async.bulk.tensor over
//     4-D tensor maps of the strided (B, H, S, D) views, completion on an
//     mbarrier per stage; rows past S or T arrive as zeros).  A consumer
//     warp releases a stage on a second mbarrier once its PV product has
//     read it.  No block barrier runs inside the loop.
//   * Shared memory, all bf16: the ring (BK x D a K or V tile) and Q (BQ x
//     D) for the whole block: 160 KB at D = 128, 200 KB at D = 160 (four
//     stages), 192 KB at D = 256 (two stages), of a block's 227 KB.  A
//     tile is stored in column blocks of kRow-byte rows, kRow the largest
//     of 128, 64 and 32 that divides a row (D = 160: five blocks of 32
//     columns in the 64-byte swizzle, TMA boxes 32 columns wide), swizzled
//     as TMA writes them, so K serves QK^T as a K-major operand and the
//     same V layout serves PV as an MN-major (transposed) one, the column
//     blocks its leading byte offset.
//   * QK^T: wgmma m64n64k16, A = Q and B = the K tile, both from shared
//     memory through descriptors, fp32 accumulators in registers (a bf16
//     product summed in fp32 is exact, so this matches the fp32
//     specification up to summation order).
//   * Softmax in registers on the accumulator fragments: scale, mask (only
//     on tiles that cross the diagonal or T), row max and sum with quad
//     shuffles, exp2 (ex2.approx) with log2(e) folded into the scale.
//   * PV: wgmma m64n{D}k16 with A = P from registers (the m64nN
//     accumulator layout of S is the register-A layout of the m64k16
//     slices) and B = the V tile from shared memory, transposed; at D =
//     160 and 256 two products into one accumulator, n128 + n32 and n128 +
//     n128 (wgmma_rs_wide).  P is
//     split into hi = bf16(P) and lo = bf16(P - hi), two wgmmas into the
//     same fp32 accumulator: P keeps about 16 significant bits, as the
//     reference's fp32 P needs (a single bf16 P moves outputs by about one
//     bf16 rounding step, the whole of the check's tolerance).
//   * Pipeline inside a warpgroup: S of tile t and PV of tile t - 1 go to
//     the tensor cores together, and the softmax of tile t runs while PV
//     is still on them.  The wgmma calls sit on straight-line code, never
//     under a branch, so the compiler keeps them asynchronous.
//   * Registers: the producer warpgroup gives all but 40 of its registers
//     to the consumers (setmaxnreg), which may use 232 each: the output's
//     D / 2 fp32 accumulators a thread (80 at D = 160, 128 at D = 256), S
//     (32) and P as hi + lo (32).
// fp32 at D <= 128: the split-TF32 tensor-core body
// (flash_fwd_tf32_kernel<D>).
//   * Precision: every product runs on the tensor cores as mma.sync
//     m16n8k8 with TF32 operands and fp32 accumulators, each fp32 operand
//     x split into big = x with its low 13 mantissa bits cleared and small
//     = x - big (split_tf32, hopper.cuh; the tensor cores read small's top
//     19 bits), the product as small.big + big.small + big.big (mma3_n,
//     term by term over a group of accumulators, so that no product waits
//     on the one before it).  The pair keeps about 20 significant bits, so
//     the outputs stay within a few 1e-6 of the fp32 plain version; one
//     TF32 pass misses the fp32 check by 20x (tests/test_torch_kernels.py
//     emulates both).
//   * Tiles follow the sequence: a warp owns 16 q rows, a block one to
//     eight warps (as many 16-row slices as S has, up to eight, dealt
//     evenly: S = 65 is one block of five warps, 80 rows); slices past S
//     are not computed.  Keys come in tiles of 80 (32 at D = 128), so that
//     ViT-B's 65 keys are one tile: a head is 80 x 80 scores, not 128 x
//     128.  The loops run over every 8-key slice of a tile without a
//     branch (keys past T arrive as zero rows and are masked), which lets
//     the compiler overlap the slices' loads and products; a tile wholly
//     above a warp's rows is skipped.
//   * Copies: each warp reads its Q fragments from device memory once and
//     keeps them in registers as fp32 (split at each use); K and V tiles
//     arrive by 16-byte cp.async into rows padded to D + 4 floats, which
//     keeps the fragment reads free of bank conflicts, double-buffered
//     where T takes more than one tile (one stage, 44 KB at D = 64,
//     otherwise).
//   * PV takes P from the accumulators of S in registers: the k order of
//     each 8-key slice is permuted (k = t <-> key 2t, k = t + 4 <-> key 2t
//     + 1) so that the m16n8 accumulator layout is the A layout, and V's
//     fragments are read in the same order.
//   * Softmax in registers as the bf16 body's: exp2 with log2(e) folded
//     into the scale, quad shuffles for the row max and sum.
//   Bound at ViT-B's shape (B=256 S=T=65 H=12 D=64, fp32): the bytes, q, k,
//   v and o once each (204 MB, 0.061 ms); three TF32 products a product
//   at 495 TFLOP/s take 0.020 ms.
// fp32 at D = 160 and 256 (no path runs them): the FMA body
// (flash_fwd_kernel): BQ = BK = 64, 256 threads, each owning a 4x4 block
// of scores and a 4 x D/16 block of the output, the products as fp32 FMAs
// from shared memory.
//
// Both bodies can write each row's logsumexp, lse = m + log(max(l, 1e-30))
// in natural log and fp32, into a (B, H, S) array: the backward
// (flash_attention_bwd.cu) recomputes P = exp(scale * q.k - lse) from it.
// The caller passes a null pointer when it needs no gradient.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int group, int S, int Tk,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale,
                 int causal) {
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
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * S + s_pos] =
          m[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int S, int Tk,
                   Strides qs,
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, H / Hkv, S, Tk, qs,
      ks, vs, os, scale, causal);
  return cudaGetLastError();
}

// the head dims built, kernels/flash_attention.py: HEAD_DIMS
template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int H, int Hkv, int S,
                       int Tk, Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16:  return launch<T, 16>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 32:  return launch<T, 32>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 64:  return launch<T, 64>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 160: return launch<T, 160>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    default:  return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// fp32 split-TF32 tensor-core body (D <= 128)
// ---------------------------------------------------------------------------

template <int D>
struct Tf32 {
  // keys a kv tile: 80 at D <= 64, so that ViT-B's 65 keys are one tile
  static constexpr int kBK = D <= 64 ? 80 : 32;
  static constexpr int kLD = D + 4;                // padded row, floats
  static constexpr int kMaxWarps = 8;              // 16 q rows each
  // one (K, V) stage, or two when the keys take more than one tile
  static constexpr size_t smem(int stages) {
    return sizeof(float) * stages * 2 * kBK * kLD;
  }
};
constexpr float kLog2eF = 1.4426950408889634f;
constexpr float kLn2F = 0.6931471805599453f;

// A split product is three TF32 products, smallest first: term 0 is
// small.big, term 1 big.small, term 2 big.big (mma_term); one TF32 pass
// would be term 2 alone
constexpr int kFirstTerm = 0;

// launch bounds: at most 128 registers a thread (a few spill), so that
// three blocks of ViT-B's five warps share an SM
template <int D>
__global__ void __launch_bounds__(32 * Tf32<D>::kMaxWarps, 2)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int group, int S, int Tk,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      float scale, int causal) {
  using C = Tf32<D>;
  constexpr int BK = C::kBK, LD = C::kLD, NJ = BK / 8, DK = D / 8;
  // accumulators a group of products, term by term (NJ = 10 at D <= 64)
  constexpr int NG = NJ % 5 == 0 ? 5 : 4, NI = DK < 4 ? DK : 4;
  extern __shared__ __align__(16) float smem_f[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int W = blockDim.x / 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_head = h / group;
  // the last rows first: with a causal mask they have the most keys
  const int blk0 = (gridDim.x - 1 - blockIdx.x) * 16 * W;
  const int r0 = blk0 + 16 * warp;         // this warp's rows r0 .. r0 + 15
  const bool live = r0 < S;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kv_head * ks.h;
  const float* vb = v + b * vs.b + kv_head * vs.h;
  auto stage = [&](int i) { return smem_f + (i & 1) * 2 * BK * LD; };

  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (min(S, blk0 + 16 * W) - 1) / BK + 1);
  cp_rows<D>(stage(0), kb, ks.s, 0, Tk, BK);
  cp_rows<D>(stage(0) + BK * LD, vb, vs.s, 0, Tk, BK);
  cp_async_commit();

  // Q's A fragments, kept as fp32 and split at each use: rows r0 + g and
  // r0 + g + 8, columns 8kk + t and 8kk + t + 4
  const int ra = r0 + g, rb = r0 + g + 8;
  float qr[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const int c = 8 * kk + t;
    qr[kk][0] = ra < S ? qb[ra * qs.s + c] : 0.f;
    qr[kk][1] = rb < S ? qb[rb * qs.s + c] : 0.f;
    qr[kk][2] = ra < S ? qb[ra * qs.s + c + 4] : 0.f;
    qr[kk][3] = rb < S ? qb[rb * qs.s + c + 4] : 0.f;
  }

  const float scale2 = scale * kLog2eF;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                  // this thread's columns only
  float acc[DK][4];
#pragma unroll
  for (int i = 0; i < DK; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {                      // the next tile, while this one
      cp_rows<D>(stage(it + 1), kb, ks.s, (it + 1) * BK, Tk, BK);
      cp_rows<D>(stage(it + 1) + BK * LD, vb, vs.s, (it + 1) * BK, Tk, BK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Ks = stage(it);
    const float* Vs = Ks + BK * LD;
    const int k0 = it * BK;
    // a tile wholly above this warp's rows adds nothing; keys past T (zero
    // rows) and above the diagonal are masked, so the loops below run over
    // every 8-key slice of the tile without a branch
    if (live && !(causal && k0 > r0 + 15)) {
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = Q K^T
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t ab[4], as[4];
        split_n(qr[kk], ab, as);
#pragma unroll
        for (int j0 = 0; j0 < NJ; j0 += NG) {
          uint32_t bb[NG][2], bs[NG][2];
#pragma unroll
          for (int j = 0; j < NG; ++j)
            bt_frag(Ks, LD, 8 * (j0 + j), 8 * kk, bb[j], bs[j]);
          mma3_n<NG, kFirstTerm>(s + j0, ab, as, bb, bs);
        }
      }
      // softmax: s[j][e] is row r0 + g + 8 (e / 2), key k0 + 8j + 2t + e % 2
      const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > r0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int row = r0 + g + 8 * (e >> 1);
            if (key >= Tk || (causal && key > row)) x = kNegInf;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m[e >> 1]);
          s[j][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < DK; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
      // O += P V: P's slice j in the permuted k order
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ab[4], as[4];
        acc_as_a(s[j], ab, as);
#pragma unroll
        for (int i0 = 0; i0 < DK; i0 += NI) {
          uint32_t bb[NI][2], bs[NI][2];
#pragma unroll
          for (int i = 0; i < NI; ++i)
            bp_frag(Vs, LD, 8 * j, 8 * (i0 + i), bb[i], bs[i]);
          mma3_n<NI, kFirstTerm>(acc + i0, ab, as, bb, bs);
        }
      }
    }
    __syncthreads();                        // this stage is free again
  }

  if (!live) return;
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(lr, 1e-30f);
    const float inv = 1.f / denom;
    // m is in log2 units (the scores were scaled by log2(e))
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * S + row] =
          m[r] * kLn2F + logf(denom);
#pragma unroll
    for (int i = 0; i < DK; ++i)
      *reinterpret_cast<float2*>(ob + row * os.s + 8 * i + 2 * t) =
          make_float2(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int Hkv, int S, int Tk,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        float scale, int causal, cudaStream_t stream) {
  using C = Tf32<D>;
  static bool configured = false;   // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::smem(2)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const size_t smem = C::smem(Tk > C::kBK ? 2 : 1);
  // 16-row slices, dealt to as few blocks of at most kMaxWarps warps as
  // take them, as evenly as they go
  const int slices = (S + 15) / 16;
  const int blocks = (slices + C::kMaxWarps - 1) / C::kMaxWarps;
  const int warps = (slices + blocks - 1) / blocks;
  flash_fwd_tf32_kernel<D><<<dim3(blocks, H, B), 32 * warps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H / Hkv, S,
      Tk, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

// the head dims of the split-TF32 body, kernels/flash_attention.py:
// TF32_DIMS
cudaError_t dispatch_tf32(int D, const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int H, int Hkv, int S,
                          int Tk, Strides qs, Strides ks, Strides vs,
                          Strides os, float scale, int causal,
                          cudaStream_t stream) {
  switch (D) {
    case 16:  return launch_tf32<16>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 32:  return launch_tf32<32>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 64:  return launch_tf32<64>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 128: return launch_tf32<128>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
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
// the K/V ring: four stages, two at D = 256 (Q and four stages of 64 KB
// would be 320 KB, more than a block's 227 KB)
template <int D>
constexpr int kStages = D > 160 ? 2 : 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// V is read by PV as an MN-major (transposed) B operand
constexpr int kTransV = 1;

// A tile of R rows x D bf16 lies in shared memory as D*2/kRow column
// blocks, each R rows of kRow bytes, swizzled the way TMA writes them (and
// wgmma reads them) for a kRow-byte swizzle: the largest of 128, 64 and 32
// bytes that divides a row (128 at D = 64, 128 and 256; 64 at D = 32 and
// 160, five blocks of 32 columns; 32 at D = 16).
template <int D>
struct Layout {
  static constexpr int kRow = D * 2 % 128 == 0 ? 128
                              : D * 2 % 64 == 0 ? 64 : 32;   // bytes
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
         static_cast<size_t>(kStages<D>) * 2 * Layout<D>::bytes(TBK) +
         (2 * kStages<D> + 1) * 8;        // mbarriers
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

// 2^x in one MUFU instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       int group, int S, int Tk, Strides os, float scale,
                       int causal) {
  using L = Layout<D>;
  constexpr int kSbo = 8 * L::kRow;       // bytes between 8-row groups
  constexpr int kTile = L::bytes(TBK);
  constexpr int kSt = kStages<D>;
  // V's column 128 (the second PV product at D = 160 and 256), 16-byte units
  constexpr uint32_t kRest = (256 / L::kRow) * L::block_bytes(TBK) >> 4;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  // swizzled tiles need 1024-byte aligned column blocks; the ring comes
  // first, then Q, then the barriers
  const uint32_t skv = (smem_addr(smem_tc) + 1023) & ~1023u;
  const uint32_t sq = skv + kSt * 2 * kTile;
  const uint32_t bars = sq + L::bytes(TBQ);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kSt + s); };
  const uint32_t q_full = bars + 16 * kSt;
  // tile t's stage: its K tile, then its V tile
  auto stage = [&](int t) { return skv + (t % kSt) * 2 * kTile; };

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * TBQ;  // last tile first
  const int kvh = h / group;
  int nk = (Tk + TBK - 1) / TBK;
  if (causal) nk = min(nk, (q_start + TBQ - 1) / TBK + 1);  // k_start <= q_end

  if (tid == 0) {
    for (int i = 0; i < kSt; ++i) {
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
        const int s = t % kSt;
        mbar_wait(empty(s), ((t / kSt) & 1) ^ 1);   // stage free
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
        const uint64_t vk = vd + ((2 * kSbo * kk) >> 4);
        wgmma_rs_wide<kTransV>(acc, p_hi[kk], vk, kRest);
        wgmma_rs_wide<kTransV>(acc, p_lo[kk], vk, kRest);
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
      if (lane == 0) mbar_arrive(empty(t % kSt));
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
      mbar_wait(full(t % kSt), (t / kSt) & 1);
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
      // m is in log2 units (the scores were scaled by log2(e))
      if (lse != nullptr && col0 == 0)
        lse[(static_cast<long long>(b) * gridDim.x + h) * S + rows[r]] =
            m[r] * kLn2 + logf(fmaxf(lr, 1e-30f));
      bf16* orow = ob + rows[r] * os.s;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int Hkv, int S, int Tk,
                      Strides qs,
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
  constexpr int kBox = Layout<D>::kRow / 2;    // columns a swizzle block
  cudaError_t e = make_map(&q_map, q, B, H, S, D, qs, TBQ, kBox);
  if (e == cudaSuccess) e = make_map(&k_map, k, B, Hkv, Tk, D, ks, TBK, kBox);
  if (e == cudaSuccess) e = make_map(&v_map, v, B, Hkv, Tk, D, vs, TBK, kBox);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, (S + TBQ - 1) / TBQ);
  flash_fwd_wgmma_kernel<D><<<grid, kThreadsTC, smem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), lse, H / Hkv, S, Tk, os,
      scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int H, int Hkv, int S,
                        int Tk, Strides qs, Strides ks, Strides vs,
                        Strides os, float scale, int causal,
                        cudaStream_t stream) {
  switch (D) {
    case 16:  return launch_tc<16>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 32:  return launch_tc<32>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 64:  return launch_tc<64>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 128: return launch_tc<128>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 160: return launch_tc<160>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 256: return launch_tc<256>(q, k, v, o, lse, B, H, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    default:  return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, H, S, D) views; k, v: (B, Hkv, T, D) views, each given by its
// element strides over (b, h, s) with the last axis contiguous.  All four
// share one dtype.  lse: a contiguous fp32 (B, H, S) array for the rows'
// logsumexp, or null.  bf16 runs the tensor-core body at every D, fp32
// the split-TF32 body at D <= 128 (both need every row start 16-byte
// aligned) and the FMA body at D = 160 and 256.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Hkv, int S, int Tk, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int dtype,
    void* stream) {
  if (H % Hkv != 0 || S < 1 || Tk < 1 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == repro::kFloat32) {
    if (D > 128)
      return dispatch_d<float>(D, q, k, v, o, l, B, H, Hkv, S, Tk, qs, ks,
                               vs, os, scale, causal, s);
    if (!aligned16(q, qs, 4) || !aligned16(k, ks, 4) ||
        !aligned16(v, vs, 4) || !aligned16(o, os, 4))
      return cudaErrorInvalidValue;
    return dispatch_tf32(D, q, k, v, o, l, B, H, Hkv, S, Tk, qs, ks, vs, os,
                         scale, causal, s);
  }
  if (dtype == repro::kBFloat16) {
    if (!aligned16(q, qs, 2) || !aligned16(k, ks, 2) ||
        !aligned16(v, vs, 2) || !aligned16(o, os, 2) || B > 65535 ||
        S > 65535 * TBQ)
      return cudaErrorInvalidValue;
    return dispatch_tc(D, q, k, v, o, l, B, H, Hkv, S, Tk, qs, ks, vs, os,
                       scale, causal, s);
  }
  return cudaErrorInvalidValue;
}
