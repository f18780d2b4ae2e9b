// Flash attention forward for Hopper (sm_90a) — online softmax, GQA,
// causal or not.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel), with its semantics kept exactly:
//   * top-left causal mask, q_pos >= k_pos, both counted from 0 (also when
//     S != T);
//   * a kv tile runs only if k_start <= q_start + BQ - 1 (tiles above the
//     diagonal are skipped);
//   * padded keys are masked with k_pos < T, ragged S and T are masked
//     here, never padded on the host;
//   * the mask value is the finite -1e30, and the denominator is clamped
//     at 1e-30;
//   * the running max m, sum l and the accumulator stay in fp32.
// GQA reads kv head h / (H / Hkv) directly instead of materialising the
// repeated kv heads (src/repro/kernels/ops.py:24-27 does jnp.repeat).
//
// Grid and loop: the TPU kernel's grid is (B, H, q blocks, kv blocks)
// with the kv axis sequential, carrying m, l and acc in VMEM scratch from
// one grid step to the next.  Hopper's blocks run in no order, so here one
// block owns one (q tile, head, batch) and walks the kv tiles in a loop,
// carrying m, l and acc in registers.
//
// Bound on an H100: operations, 4*B*H*D*(unmasked q,k pairs) flops (QK^T
// plus PV; about half of S*T when causal) at 989 TFLOP/s bf16 — the bytes
// (q, k, v, o once each) are tiny beside them.  This first version does
// the products with fp32 FMAs from shared memory (BQ = BK = 64, 256
// threads, each owning a 4x4 block of scores and a 4 x D/16 block of the
// output) — right and simple first, so it runs far from that bound; the
// tensor-core version (mma/wgmma, TMA) is later work.  What it does keep
// is the flash property: the S x T scores never touch device memory, and
// kv is read once per q tile.
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
  if (dtype == repro::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, S, Tk, qs, ks,
                                     vs, os, scale, causal, s);
  return cudaErrorInvalidValue;
}
