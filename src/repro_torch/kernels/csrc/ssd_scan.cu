// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan
// (_ssd_kernel).  Per chunk of Q rows, with cum = cumsum(a) over the chunk:
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//        + exp(cum_i) C_i . h                                      (inter)
//   h'   = exp(cum_{Q-1}) h + sum_j exp(cum_{Q-1} - cum_j) dt_j x_j (x) B_j
// all in fp32, h0 in and h_final out.  The semantics are the TPU kernel's:
//   * Q = min(chunk, S) is chosen by the caller (any 1 <= Q <= 128); the
//     ragged tail of the last chunk reads dt = a = 0 and x = B = C = 0
//     (decay 1, no input: the state is untouched), exactly the TPU
//     wrapper's zero padding, done here instead of on the host;
//   * the causal mask SELECTS: exp(cum_i - cum_j) is evaluated only where
//     j <= i.  Above the diagonal it may overflow to inf, and a multiply by
//     a 0/1 mask would turn inf * 0 into NaN;
//   * groups are not expanded to heads: head h reads group h / (H / G) of
//     B and C directly (src/repro/kernels/ops.py:40-42 copies them).
// Inputs arrive in the model's layout through element strides (x, y:
// (b, s, h) with p contiguous; B, C: (b, s, g) with n contiguous; dt, a:
// (b, s, h)), so the host copies nothing.
//
// Grid and loop: the TPU kernel's grid is (B, H, chunks) with the chunk
// axis sequential and h in VMEM scratch.  Hopper's blocks run in no order,
// so here a block owns (b, h, a tile of PT = 16 rows of h over P) and walks
// the chunks in a loop, h's tile in shared memory.  The rows of h (and the
// columns of y) are independent, so the P tiles are exact and give the
// card B*H*P/16 blocks (192 at the served batch of 1) instead of 48.  The
// price: every P tile recomputes the chunk's C.B^T scores.
//
// Shared memory: one chunk of B and C at their input type (a Q x N chunk
// of both in fp32 is 128 KB; in bf16 half that), the x tile, the h tile,
// and a RT x Q tile of scores (rows tiled so the Q x Q matrix never needs
// 64 KB at once).  163 KB at Q = N = 128 in fp32, 99 KB in bf16 (two
// blocks an SM).  Rows are padded one word so column walks miss no bank.
// The state update gives a thread 8 rows of h at one column, so one B
// load feeds 8 FMAs.
//
// Bound on an H100: operations.  At the served prefill chunk (B=1, S=256,
// H=48, G=1, P=64, N=128, Q=128) one call is about 0.51 GFLOP over the
// causal triangle (C.B^T once per group, the rest once per head) and moves
// about 8 MB, so 0.0075 ms at 67 TFLOP/s fp32 against 0.0024 ms at
// 3.35 TB/s.  This first version multiplies with fp32 FMAs from shared
// memory and recomputes the scores in each of the 4 P tiles and each head;
// tensor cores (TF32 is not allowed here: the scan is specified in fp32)
// and TMA are later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int PT = 16;        // rows of h (columns of y) per block
constexpr int RT = 32;        // score rows per tile
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
static_assert(PT % 8 == 0, "the state update gives a thread 8 rows of h");

struct Strides {              // element strides over (b, head or group, s)
  long long b, h, s;
};

template <typename T>
__host__ __device__ constexpr int padded_ld(int n) {
  return n + 4 / static_cast<int>(sizeof(T));   // one 4-byte word per row
}

// bytes of the B and C tiles, rounded up so the fp32 arrays after them
// start 16-byte aligned (the state update reads the x tile as float4)
template <typename T>
__host__ __device__ size_t bc_bytes(int Q, int N) {
  return (2 * static_cast<size_t>(Q) * padded_ld<T>(N) * sizeof(T) + 15) &
         ~static_cast<size_t>(15);
}

template <typename T>
size_t smem_bytes(int Q, int N) {
  return bc_bytes<T>(Q, N) +
         sizeof(float) * (static_cast<size_t>(Q) * PT + PT * (N + 1) +
                          RT * (Q + 1) + 4 * Q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dt,
                const float* __restrict__ av, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hout, int H,
                int group, int S, int P, int N, int Q, Strides xs,
                Strides bs, Strides cs, Strides dts, Strides as,
                Strides ys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldb = padded_ld<T>(N);
  const int ldh = N + 1;
  const int lds = Q + 1;
  T* Bs = reinterpret_cast<T*>(smem_raw);           // Q x ldb
  T* Cs = Bs + Q * ldb;                             // Q x ldb
  float* Xs = reinterpret_cast<float*>(smem_raw + bc_bytes<T>(Q, N));  // Q x PT
  float* Hs = Xs + Q * PT;                          // PT x ldh
  float* Ss = Hs + PT * ldh;                        // RT x lds
  float* cum = Ss + RT * lds;                       // Q
  float* dtv = cum + Q;                             // Q
  float* wdec = dtv + Q;                            // exp(cum_Q - cum_j) dt_j
  float* ecum = wdec + Q;                           // exp(cum_i)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / group;
  const T* xb = x + b * xs.b + h * xs.h;
  const T* bb = bm + b * bs.b + g * bs.h;
  const T* cb = cm + b * cs.b + g * cs.h;
  const float* dtb = dt + b * dts.b + h * dts.h;
  const float* ab = av + b * as.b + h * as.h;
  float* yb = y + b * ys.b + h * ys.h;
  const long long hoff = (static_cast<long long>(b) * H + h) * P * N;
  const T zero = repro::from_f32<T>(0.f);

  // this block's rows of h; rows past P stay 0 and are never written
  for (int idx = tid; idx < PT * N; idx += kThreads) {
    const int r = idx / N, n = idx % N, p = p0 + r;
    Hs[r * ldh + n] =
        (h0 != nullptr && p < P) ? h0[hoff + static_cast<long long>(p) * N + n]
                                 : 0.f;
  }

  const int nc = (S + Q - 1) / Q;
  const int n_rt = (Q + RT - 1) / RT;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();            // the last chunk's readers are done
    for (int idx = tid; idx < Q * N; idx += kThreads) {
      const int r = idx / N, n = idx % N, s = s0 + r;
      const bool ok = s < S;
      Bs[r * ldb + n] = ok ? bb[s * bs.s + n] : zero;
      Cs[r * ldb + n] = ok ? cb[s * cs.s + n] : zero;
    }
    for (int idx = tid; idx < Q * PT; idx += kThreads) {
      const int r = idx / PT, s = s0 + r, p = p0 + idx % PT;
      Xs[idx] = (s < S && p < P) ? repro::to_f32(xb[s * xs.s + p]) : 0.f;
    }
    if (tid < Q) {
      const int s = s0 + tid;
      dtv[tid] = s < S ? dtb[s * dts.s] : 0.f;
      cum[tid] = s < S ? ab[s * as.s] : 0.f;
    }
    __syncthreads();
    // inclusive cumsum of a, in row order: |cum| reaches thousands at
    // strong decay, where exp(cum_i - cum_j) inherits ~|cum|*eps of
    // relative error, so the order is that of the plain version
    // (torch.cumsum runs one sequential sum per column here)
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += cum[i];
        cum[i] = run;
      }
    }
    __syncthreads();
    if (tid < Q) {
      wdec[tid] = expf(cum[Q - 1] - cum[tid]) * dtv[tid];
      ecum[tid] = expf(cum[tid]);
    }

    for (int rt = 0; rt < n_rt; ++rt) {
      // scores of rows i = rt*RT + ty*4 + ii against columns j = tx + 32k;
      // column blocks k > rt lie wholly above the diagonal and are skipped
      {
        const int ty = tid / 32, tx = tid % 32;
        const int ibase = rt * RT + ty * 4;
        float acc[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[ii][k] = 0.f;
        const T* crow[4];
        const T* brow[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          crow[ii] = Cs + min(ibase + ii, Q - 1) * ldb;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          brow[k] = Bs + min(tx + 32 * k, Q - 1) * ldb;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) cv[ii] = repro::to_f32(crow[ii][n]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            bv[k] = k <= rt ? repro::to_f32(brow[k][n]) : 0.f;
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (k <= rt) acc[ii][k] = fmaf(cv[ii], bv[k], acc[ii][k]);
        }
        __syncthreads();        // wdec/ecum written; last tile's y read Ss
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = ibase + ii;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = tx + 32 * k;
            const bool keep = k <= rt && j <= i && i < Q;
            const float v =
                keep ? acc[ii][k] * expf(cum[i] - cum[j]) * dtv[j] : 0.f;
            if (j < Q) Ss[(ty * 4 + ii) * lds + j] = v;
          }
        }
      }
      __syncthreads();
      // y for the tile's rows: column p0 + pc, rows r and r + 16.  The
      // product runs over whole column blocks up to the diagonal one, as a
      // tiled matmul does, so the entries above the diagonal inside that
      // block are read: they are the zeros the select wrote.
      {
        const int pc = tid % PT;
        const int jend = min(Q, (rt + 1) * RT);
        const float* hrow = Hs + pc * ldh;
        for (int r = tid / PT; r < RT; r += kThreads / PT) {
          const int i = rt * RT + r;
          if (i >= Q) break;
          float intra = 0.f;
          const float* srow = Ss + r * lds;
          for (int j = 0; j < jend; ++j)
            intra = fmaf(srow[j], Xs[j * PT + pc], intra);
          float inter = 0.f;
          const T* crow = Cs + i * ldb;
          for (int n = 0; n < N; ++n)
            inter = fmaf(repro::to_f32(crow[n]), hrow[n], inter);
          const int s = s0 + i, p = p0 + pc;
          if (s < S && p < P)
            yb[static_cast<long long>(s) * ys.s + p] = intra + ecum[i] * inter;
        }
      }
    }
    __syncthreads();            // every y row has read this chunk's h, x
    // the state update's left factor, in place: x_j * exp(cum_Q - cum_j) dt_j
    for (int idx = tid; idx < Q * PT; idx += kThreads)
      Xs[idx] *= wdec[idx / PT];
    __syncthreads();
    // h' = exp(cum_Q) h + sum_j w_j (x) B_j: a thread owns 8 rows of h at
    // one column n, so each B load feeds 8 FMAs
    const float dlast = expf(cum[Q - 1]);
    for (int idx = tid; idx < (PT / 8) * N; idx += kThreads) {
      const int r0 = idx / N * 8, n = idx % N;
      float acc[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[m] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float b = repro::to_f32(Bs[j * ldb + n]);
        const float4 w0 = *reinterpret_cast<const float4*>(Xs + j * PT + r0);
        const float4 w1 =
            *reinterpret_cast<const float4*>(Xs + j * PT + r0 + 4);
        acc[0] = fmaf(w0.x, b, acc[0]);
        acc[1] = fmaf(w0.y, b, acc[1]);
        acc[2] = fmaf(w0.z, b, acc[2]);
        acc[3] = fmaf(w0.w, b, acc[3]);
        acc[4] = fmaf(w1.x, b, acc[4]);
        acc[5] = fmaf(w1.y, b, acc[5]);
        acc[6] = fmaf(w1.z, b, acc[6]);
        acc[7] = fmaf(w1.w, b, acc[7]);
      }
#pragma unroll
      for (int m = 0; m < 8; ++m)
        Hs[(r0 + m) * ldh + n] = dlast * Hs[(r0 + m) * ldh + n] + acc[m];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < PT * N; idx += kThreads) {
    const int r = idx / N, n = idx % N, p = p0 + r;
    if (p < P) hout[hoff + static_cast<long long>(p) * N + n] = Hs[r * ldh + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bm, const void* cm,
                   const void* dt, const void* a, const void* h0, void* y,
                   void* hout, int B, int H, int G, int S, int P, int N,
                   int Q, Strides xs, Strides bs, Strides cs, Strides dts,
                   Strides as, Strides ys, cudaStream_t stream) {
  static bool configured = false;   // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<T>(kMaxQ, kMaxN)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((P + PT - 1) / PT, H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem_bytes<T>(Q, N), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hout), H, H / G, S, P, N,
      Q, xs, bs, cs, dts, as, ys);
  return cudaGetLastError();
}

}  // namespace

// x: (B, S, H, P) and y: (B, S, H, P) fp32, each given by element strides
// over (b, h, s) with p contiguous; bm, cm: (B, S, G, N) by strides over
// (b, g, s) with n contiguous; dt, a: fp32 by strides over (b, h, s); h0
// (may be null: zeros) and hout: contiguous (B, H, P, N) fp32.  x, bm, cm
// share one dtype.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_ssd_scan(
    const void* x, const void* bm, const void* cm, const void* dt,
    const void* a, const void* h0, void* y, void* hout, int B, int H, int G,
    int S, int P, int N, int Q, long long x_sb, long long x_sh,
    long long x_ss, long long b_sb, long long b_sg, long long b_ss,
    long long c_sb, long long c_sg, long long c_ss, long long dt_sb,
    long long dt_sh, long long dt_ss, long long a_sb, long long a_sh,
    long long a_ss, long long y_sb, long long y_sh, long long y_ss,
    int dtype, void* stream) {
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || S < 1 || P < 1 || N < 1 ||
      N > kMaxN || Q < 1 || Q > kMaxQ || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const Strides xs{x_sb, x_sh, x_ss}, bs{b_sb, b_sg, b_ss},
      cs{c_sb, c_sg, c_ss}, dts{dt_sb, dt_sh, dt_ss}, as{a_sb, a_sh, a_ss},
      ys{y_sb, y_sh, y_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch<float>(x, bm, cm, dt, a, h0, y, hout, B, H, G, S, P, N, Q,
                         xs, bs, cs, dts, as, ys, s);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, bm, cm, dt, a, h0, y, hout, B, H, G, S,
                                 P, N, Q, xs, bs, cs, dts, as, ys, s);
  return cudaErrorInvalidValue;
}
