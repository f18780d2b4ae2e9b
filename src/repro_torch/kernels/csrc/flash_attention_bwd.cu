// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of the
// causal (or not), top-left-masked, GQA forward of flash_attention.cu.
//
// The TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel) has no backward: the reference trains through plain jnp
// attention.  The port runs its forward kernel in training too, so its
// gradient needs a kernel of its own.  It keeps what the forward keeps:
//   * top-left causal mask, q_pos >= k_pos, both counted from 0 (also when
//     S != T); tiles wholly above the diagonal are skipped;
//   * keys past T and rows past S are masked here (P = 0 there, which is
//     what the finite -1e30 mask gives after the softmax);
//   * q head h reads kv head h / (H / Hkv); dK and dV of a kv head are the
//     sum over its group of q heads, taken inside one block in a fixed
//     order, so the result is deterministic (no atomics).
// P is recomputed from the forward's logsumexp, P = exp(scale * q.k - lse),
// so nothing of size S x T is stored between the passes.
//
// Three kernels a call, all fp32 FMA from shared memory:
//   1. flash_bwd_dot_kernel: Di = rowsum(dO * O) for every (b, h, row),
//      one warp a row;
//   2. flash_bwd_dkdv_kernel: a block owns BK keys of one (b, kv head) and
//      walks the q tiles of each q head of its group: S^T = K Q^T and
//      dP^T = V dO^T, P and dS = P * (dP - Di) into shared memory, then
//      dV += P^T dO and dK += dS^T Q in registers;
//   3. flash_bwd_dq_kernel: a block owns BQ rows of one (b, q head) and
//      walks the kv tiles: S, dP and dS as above, dQ += dS K in registers.
// Bound on an H100: operations, 10 * B * H * D * (unmasked pairs) flops
// (S and dP twice, dV, dK, dQ) at 67 TFLOP/s fp32 or 989 bf16; the bytes
// are small beside them at the model's shapes.  This design does the five
// products at the fp32 FMA rate whatever the input type (bf16 inputs are
// widened when a tile is loaded) and recomputes S and dP once in each of
// kernels 2 and 3; tensor cores are for a later design.
//
// Tiles: BQ = BK = 64 at D <= 160, 32 at D = 256 (shared memory: four
// tiles of rows x (D + 1) fp32 plus P and dS, 198 KB at D = 160, 140 KB at
// D = 256).  256 threads as 16 x 16: a thread owns a (rows/16) x (cols/16)
// block of each score tile and (rows/16) rows x D/16 columns of each
// output tile; rows padded to D + 1 floats keep column reads free of bank
// conflicts.
#include <stdint.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;

template <int D>
struct Tile {
  static constexpr int kRows = D > 160 ? 32 : 64;   // BQ = BK
  static constexpr int kPer = kRows / 16;           // rows (cols) a thread
  static constexpr int kDP = D + 1;                 // padded row
  static constexpr int kPP = kRows + 1;
  static constexpr int kDJ = D / 16;                // output cols a thread
  static constexpr size_t smem() {
    return sizeof(float) *
           (4 * kRows * kDP + 2 * kRows * kPP + 2 * kRows);
  }
};

// whether query q_pos sees key k_pos: inside the sequences and, when
// causal, at or below the diagonal
__device__ __forceinline__ bool visible(int q_pos, int k_pos, int S, int Tk,
                                        int causal) {
  return q_pos < S && k_pos < Tk && (!causal || q_pos >= k_pos);
}

// dS = P * (dP - Di): the softmax's backward for one score
__device__ __forceinline__ float dsoftmax(float p, float dp, float di) {
  return p * (dp - di);
}

// rows [row0, row0 + R) of one head's (rows, D) matrix into shared memory
// as fp32, rows past n as zeros
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int n) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, s = row0 + r;
    dst[r * DP + c] = s < n ? to_f32(src[s * row_stride + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, int H, int S, int D,
                     Strides os, Strides dos, long long rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + warp;
  if (row >= rows) return;
  const int s = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const T* orow = o + b * os.b + h * os.h + s * os.s;
  const T* drow = dout + b * dos.b + h * dos.h + s * dos.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f32(orow[c]) * to_f32(drow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int group, int S, int Tk,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dks, Strides dvs, float scale, int causal) {
  using L = Tile<D>;
  constexpr int R = L::kRows, PR = L::kPer, DP = L::kDP, PP = L::kPP,
                DJ = L::kDJ;
  extern __shared__ float smem[];
  float* Ks = smem;              // R x DP
  float* Vs = Ks + R * DP;       // R x DP
  float* Qs = Vs + R * DP;       // R x DP
  float* dOs = Qs + R * DP;      // R x DP
  float* Pt = dOs + R * DP;      // P^T: R keys x PP
  float* dSt = Pt + R * PP;      // dS^T
  float* lse_s = dSt + R * PP;   // R
  float* di_s = lse_s + R;       // R

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k_start = blockIdx.x * R;
  const int hk = blockIdx.y, b = blockIdx.z;
  load_tile<T, D, R>(Ks, k + b * ks.b + hk * ks.h, ks.s, k_start, Tk);
  load_tile<T, D, R>(Vs, v + b * vs.b + hk * vs.h, vs.s, k_start, Tk);

  float adk[PR][DJ], adv[PR][DJ];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // the first q tile with a row at or below this key tile's first key
  const int qt0 = causal ? k_start / R : 0;
  const int nq = (S + R - 1) / R;
  const int h0 = hk * group;
  for (int h = h0; h < h0 + group; ++h) {
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * dos.b + h * dos.h;
    const float* lb = lse + (static_cast<long long>(b) * H + h) * S;
    const float* dlb = delta + (static_cast<long long>(b) * H + h) * S;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q_start = qt * R;
      __syncthreads();           // the last tile's readers are done
      load_tile<T, D, R>(Qs, qb, qs.s, q_start, S);
      load_tile<T, D, R>(dOs, db, dos.s, q_start, S);
      for (int r = tid; r < R; r += kThreads) {
        const bool in = q_start + r < S;
        lse_s[r] = in ? lb[q_start + r] : 0.f;
        di_s[r] = in ? dlb[q_start + r] : 0.f;
      }
      __syncthreads();

      // S^T[i][j] = K[key i] . Q[row j], dP^T[i][j] = V[key i] . dO[row j]
      float st[PR][PR], dpt[PR][PR];
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < PR; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[PR], vv[PR], qv[PR], dv_[PR];
#pragma unroll
        for (int i = 0; i < PR; ++i) {
          kv[i] = Ks[(ty * PR + i) * DP + d];
          vv[i] = Vs[(ty * PR + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < PR; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + d];
          dv_[j] = dOs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < PR; ++i)
#pragma unroll
          for (int j = 0; j < PR; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], dv_[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < PR; ++j) {
          const int kr = ty * PR + i, qr = tx + 16 * j;
          const float p = visible(q_start + qr, k_start + kr, S, Tk, causal)
                              ? expf(st[i][j] * scale - lse_s[qr])
                              : 0.f;
          Pt[kr * PP + qr] = p;
          dSt[kr * PP + qr] = dsoftmax(p, dpt[i][j], di_s[qr]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over this tile's rows
#pragma unroll 4
      for (int jj = 0; jj < R; ++jj) {
        float pv[PR], sv[PR];
#pragma unroll
        for (int i = 0; i < PR; ++i) {
          pv[i] = Pt[(ty * PR + i) * PP + jj];
          sv[i] = dSt[(ty * PR + i) * PP + jj];
        }
#pragma unroll
        for (int c = 0; c < DJ; ++c) {
          const float dov = dOs[jj * DP + tx + 16 * c];
          const float qv = Qs[jj * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < PR; ++i) {
            adv[i][c] = fmaf(pv[i], dov, adv[i][c]);
            adk[i][c] = fmaf(sv[i], qv, adk[i][c]);
          }
        }
      }
    }
  }

  // keys no query sees (past S when causal) get zeros, never garbage
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int key = k_start + ty * PR + i;
    if (key >= Tk) continue;
    T* dkr = dk + b * dks.b + hk * dks.h + key * dks.s;
    T* dvr = dv + b * dvs.b + hk * dvs.h + key * dvs.s;
#pragma unroll
    for (int c = 0; c < DJ; ++c) {
      dkr[tx + 16 * c] = from_f32<T>(adk[i][c] * scale);
      dvr[tx + 16 * c] = from_f32<T>(adv[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int group, int S, int Tk, Strides qs, Strides ks,
                    Strides vs, Strides dos, Strides dqs, float scale,
                    int causal) {
  using L = Tile<D>;
  constexpr int R = L::kRows, PR = L::kPer, DP = L::kDP, PP = L::kPP,
                DJ = L::kDJ;
  extern __shared__ float smem[];
  float* Qs = smem;              // R x DP
  float* dOs = Qs + R * DP;      // R x DP
  float* Ks = dOs + R * DP;      // R x DP
  float* Vs = Ks + R * DP;       // R x DP
  float* dSs = Vs + R * DP;      // dS: R rows x PP
  float* lse_s = dSs + 2 * R * PP;
  float* di_s = lse_s + R;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q_start = blockIdx.x * R;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int H = gridDim.y;
  load_tile<T, D, R>(Qs, q + b * qs.b + h * qs.h, qs.s, q_start, S);
  load_tile<T, D, R>(dOs, dout + b * dos.b + h * dos.h, dos.s, q_start, S);
  const float* lb = lse + (static_cast<long long>(b) * H + h) * S;
  const float* dlb = delta + (static_cast<long long>(b) * H + h) * S;
  for (int r = tid; r < R; r += kThreads) {
    const bool in = q_start + r < S;
    lse_s[r] = in ? lb[q_start + r] : 0.f;
    di_s[r] = in ? dlb[q_start + r] : 0.f;
  }
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  float acc[PR][DJ];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int nk = (Tk + R - 1) / R;
  if (causal) nk = min(nk, (q_start + R - 1) / R + 1);   // k_start <= q_end
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * R;
    __syncthreads();             // Q stored / the last tile's readers done
    load_tile<T, D, R>(Ks, kb, ks.s, k_start, Tk);
    load_tile<T, D, R>(Vs, vb, vs.s, k_start, Tk);
    __syncthreads();

    // S[i][j] = Q[row i] . K[key j], dP[i][j] = dO[row i] . V[key j]
    float sc[PR][PR], dp[PR][PR];
#pragma unroll
    for (int i = 0; i < PR; ++i)
#pragma unroll
      for (int j = 0; j < PR; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[PR], dv_[PR], kv[PR], vv[PR];
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        qv[i] = Qs[(ty * PR + i) * DP + d];
        dv_[i] = dOs[(ty * PR + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < PR; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < PR; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(dv_[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < PR; ++i)
#pragma unroll
      for (int j = 0; j < PR; ++j) {
        const int qr = ty * PR + i, kr = tx + 16 * j;
        const float p = visible(q_start + qr, k_start + kr, S, Tk, causal)
                            ? expf(sc[i][j] * scale - lse_s[qr])
                            : 0.f;
        dSs[qr * PP + kr] = dsoftmax(p, dp[i][j], di_s[qr]);
      }
    __syncthreads();

    // dQ += dS K over this tile's keys
#pragma unroll 4
    for (int kk = 0; kk < R; ++kk) {
      float sv[PR];
#pragma unroll
      for (int i = 0; i < PR; ++i) sv[i] = dSs[(ty * PR + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DJ; ++c) {
        const float kv = Ks[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < PR; ++i) acc[i][c] = fmaf(sv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int row = q_start + ty * PR + i;
    if (row >= S) continue;
    T* dqr = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
    for (int c = 0; c < DJ; ++c)
      dqr[tx + 16 * c] = from_f32<T>(acc[i][c] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int Hkv, int S, int Tk, Strides qs, Strides ks,
                   Strides vs, Strides os, Strides dos, Strides dqs,
                   Strides dks, Strides dvs, float scale, int causal,
                   cudaStream_t stream) {
  using L = Tile<D>;
  constexpr size_t smem = L::smem();
  static bool configured = false;   // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* dot = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * H * S;
  const long long dot_blocks = (rows + 7) / 8;
  if (dot_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>(dot_blocks), kThreads, 0,
                            stream>>>(static_cast<const T*>(o), dot, delta,
                                      H, S, D, os, dos, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int R = L::kRows;
  flash_bwd_dkdv_kernel<T, D>
      <<<dim3((Tk + R - 1) / R, Hkv, B), kThreads, smem, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), H, H / Hkv, S, Tk, qs, ks, vs, dos, dks, dvs,
          scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, D>
      <<<dim3((S + R - 1) / R, H, B), kThreads, smem, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), H / Hkv, S, Tk,
          qs, ks, vs, dos, dqs, scale, causal);
  return cudaGetLastError();
}

// the head dims built, kernels/flash_attention.py: HEAD_DIMS
template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int H, int Hkv, int S, int Tk, Strides qs, Strides ks,
                       Strides vs, Strides os, Strides dos, Strides dqs,
                       Strides dks, Strides dvs, float scale, int causal,
                       cudaStream_t st) {
#define REPRO_BWD_CASE(DIM)                                                   \
  case DIM:                                                                   \
    return launch<T, DIM>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,     \
                          Hkv, S, Tk, qs, ks, vs, os, dos, dqs, dks, dvs,     \
                          scale, causal, st);
  switch (D) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(160)
    REPRO_BWD_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_CASE
}

}  // namespace

// The gradients of repro_flash_attention's o.  q, o, dout, dq: (B, H, S, D)
// views; k, v, dk, dv: (B, Hkv, T, D) views; each given by its element
// strides over (b, h, s) with the last axis contiguous, all of one dtype.
// lse: the forward's contiguous fp32 (B, H, S) logsumexp; delta: a
// contiguous fp32 (B, H, S) scratch for Di.  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int S, int Tk, int D,
    const long long* strides, float scale, int causal, int dtype,
    void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || S < 1 || Tk < 1 || H > 65535 ||
      Hkv > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  // strides: 3 each for q, k, v, o, dout, dq, dk, dv, in that order
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  if (dtype == kFloat32)
    return dispatch_d<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, H,
                             Hkv, S, Tk, st[0], st[1], st[2], st[3], st[4],
                             st[5], st[6], st[7], scale, causal, s);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, dq, dk, dv,
                                     B, H, Hkv, S, Tk, st[0], st[1], st[2],
                                     st[3], st[4], st[5], st[6], st[7], scale,
                                     causal, s);
  return cudaErrorInvalidValue;
}
