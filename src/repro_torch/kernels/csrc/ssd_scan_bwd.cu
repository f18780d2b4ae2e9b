// Backward of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a).  The TPU kernel it differentiates, src/repro/kernels/
// ssd_scan.py:ssd_scan, has no backward: the reference trains through the
// plain jnp scan (src/repro/models/mamba2.py:_ssd_chunked).  This is the
// gradient of the same function.
//
// One head of one chunk of Q rows, cum = cumsum(a) in row order, cl =
// cum_{Q-1}, L_ij = exp(cum_i - cum_j) where j <= i and 0 elsewhere (a
// select: above the diagonal exp overflows), CB_ij = C_i.B_j, h the state
// entering the chunk and dh the gradient of the state leaving it:
//   dh_prev = exp(cl) dh + sum_i exp(cum_i) dy_i (x) C_i
//   dx_j    = dt_j (sum_i CB_ij L_ij dy_i + exp(cl - cum_j) dh B_j)
//   dB_j    = dt_j (sum_i dS_ij L_ij C_i + exp(cl - cum_j) dh^T x_j)
//   dC_i    = sum_j dS_ij L_ij dt_j B_j + exp(cum_i) h^T dy_i
//   ddt_j   = sum_i dS_ij CB_ij L_ij + exp(cl - cum_j) x_j . dh B_j
//   dcum_k  = sum_j E_kj dt_j - dt_k ddt_k + exp(cum_k) C_k . h^T dy_k
//             (+ sum_j dt_j ddt^state_j + exp(cl) <dh, h> at the last row)
//   da_k    = sum_{i >= k} dcum_i                        (in row order)
// with dS_ij = dy_i . x_j and E_ij = dS_ij CB_ij L_ij; dB and dC summed
// over the H/G heads of a group.  Only exp(cum_i) and exp(cl - cum_j), both
// <= 1 for a <= 0, and the selected exp(cum_i - cum_j) are ever formed:
// exp(cum_i) exp(-cum_j) overflows, since |cum| reaches thousands at
// strong decay.
//
// Four kernels a call, mirroring the forward's three, no atomics (every
// sum is taken in a fixed order, so two calls give the same bits):
//   (a) ssd_bwd_chunk_kernel, parallel over (b, h, chunk, 128 rows of P):
//       the chunk's own state s_c = sum_j exp(cl - cum_j) dt_j x_j (x) B_j
//       (the forward's, recomputed) and u_c = sum_i exp(cum_i) dy_i (x)
//       C_i, and cl per chunk;
//   (b) ssd_bwd_pass_kernel, elementwise over (b, h, P, N), serial over
//       chunks: forward, h_c from h0 (slot c of s becomes the state entering
//       chunk c); then backward, dh from dh_final (slot c of u becomes the
//       gradient of the state leaving chunk c), ending at dh0;
//   (c) ssd_bwd_grad_kernel, one block a (b, h, chunk): every gradient
//       above for the chunk's rows; dB and dC per head into a scratch;
//   (d) ssd_bwd_group_kernel: dB, dC summed over each group's heads in
//       head order and cast to the inputs' type.
// The states are recomputed, not kept from the forward: the fp32 forward
// body writes none, and keeping the bf16 body's (25 MB a layer at the
// train shape of mamba2-780m) would hold 1.2 GB across 48 layers for work
// that (a) and (b) redo in a few per cent of the call.
//
// The bodies are fp32 FMA loops, the first version (tensor cores are a
// later redesign): every product is one primitive, a 128 x 32 output tile
// over 256 threads, 4 x 4 a thread, both operands from shared memory as
// float4 (mm_tile).  (c) keeps CB L and dS L (128 x 128 fp32 each) in
// shared memory and streams the other operands through two 16 KB staging
// tiles; the triangle above the diagonal is skipped where a whole slice of
// the loop lies there.  Bound on an H100 at the train shape of
// mamba2-780m (B=2, S=1024, H=48, P=64, N=128, Q=128): operations, ~26
// GFLOP counted on the bf16 tensor cores (chip_smoke.py: ssd_bwd_work),
// 0.026 ms; these fp32 FMA loops take ~70 times that.
#include <stdint.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;     // rows of an output tile (= max Q, max N)
constexpr int kCols = 32;      // columns of an output tile
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;

struct BwdArgs {
  const void* x;
  const void* bm;
  const void* cm;
  const float* dt;
  const float* a;
  const float* h0;
  const float* dy;     // (B, S, H, P) contiguous
  const float* dhf;    // (B, H, P, N) or null
  void* dx;            // (B, S, H, P) contiguous, x's type
  void* dbm;           // (B, S, G, N) contiguous, x's type
  void* dcm;
  float* ddt;          // (B, S, H) contiguous
  float* da;
  float* dh0;          // (B, H, P, N) or null
  float* st;           // (B, H, nc, P, N): s_c, then h entering chunk c
  float* ut;           // (B, H, nc, P, N): u_c, then dh leaving chunk c
  float* cl;           // (B, H, nc)
  float* dbp;          // (B, S, H, N): per-head dB
  float* dcp;          // (B, S, H, N): per-head dC
  int H, G, S, P, N, Q, nc;
  Strides xs, bs, cs, dts, as;
};

__device__ __forceinline__ int group_of(int h, int H, int G) {
  return h / (H / G);
}

// acc[i][j] += sum_{k0 <= k < k1} A[k * lda + r0 + i] * Bp[k * ldb + c0 + j]
// (both operands k-major in shared memory, r0, c0, lda, ldb multiples of 4)
__device__ __forceinline__ void mm_tile(float (&acc)[4][4], const float* A,
                                        int lda, const float* Bp, int ldb,
                                        int k0, int k1, int r0, int c0) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(A + k * lda + r0);
    const float4 bv = *reinterpret_cast<const float4*>(Bp + k * ldb + c0);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// dst[r * ldd + c] = f(r) * src[r * rs + c0 + c] for r < rows, c < cols
// (zero where r >= nr or c0 + c >= nc_): rows of a (row, column) array,
// as they lie in memory
template <typename T, typename F>
__device__ __forceinline__ void stage_rows(float* dst, int ldd,
                                           const T* src, long long rs,
                                           int nr, int c0, int nc_, int rows,
                                           int cols, F f) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, c = idx % cols;
    dst[r * ldd + c] = (r < nr && c0 + c < nc_)
                           ? f(r) * to_f32(src[r * rs + c0 + c]) : 0.f;
  }
}

// dst[c * ldd + r] = src[r * rs + c0 + c] for r < rows, c < cols (zero
// where r >= nr or c0 + c >= nc_): the same array transposed, so that its
// columns are the k of a product
template <typename T>
__device__ __forceinline__ void stage_cols(float* dst, int ldd, const T* src,
                                           long long rs, int nr, int c0,
                                           int nc_, int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx % rows, c = idx / rows;
    dst[c * ldd + r] = (r < nr && c0 + c < nc_)
                           ? to_f32(src[r * rs + c0 + c]) : 0.f;
  }
}

struct One {
  __device__ float operator()(int) const { return 1.f; }
};
struct Scale {
  const float* v;
  __device__ float operator()(int r) const { return v[r]; }
};

// cum = cumsum(a) over the chunk's rows in row order (rows past S read 0,
// rows past Q copy cl), dt; -> cl
__device__ float chunk_cum(const BwdArgs& p, int b, int h, int s0, int q,
                           float* cum, float* dtv) {
  const int tid = threadIdx.x;
  if (tid < kMaxQ) {
    const bool ok = tid < q;
    const long long s = s0 + tid;
    cum[tid] = ok ? p.a[b * p.as.b + h * p.as.h + s * p.as.s] : 0.f;
    dtv[tid] = ok ? p.dt[b * p.dts.b + h * p.dts.h + s * p.dts.s] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < p.Q; ++i) {
      run += cum[i];
      cum[i] = run;
    }
    for (int i = p.Q; i < kMaxQ; ++i) cum[i] = run;
  }
  __syncthreads();
  return cum[kMaxQ - 1];
}

// (a) s_c[p][n] = sum_j exp(cl - cum_j) dt_j x_j[p] B_j[n] and u_c[p][n] =
// sum_i exp(cum_i) dy_i[p] C_i[n] for 128 rows p of one (b, h, chunk)
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const BwdArgs p) {
  extern __shared__ __align__(16) float sm[];
  float* A = sm;                            // [j][p]   128 x 128
  float* Pn = A + kMaxQ * kRows;            // [j][n]   128 x 32
  float* cum = Pn + kMaxQ * kCols;
  float* dtv = cum + kMaxQ;
  float* w = dtv + kMaxQ;

  const int tid = threadIdx.x, r0 = (tid >> 3) * 4, c0 = (tid & 7) * 4;
  const int z = blockIdx.x, c = z % p.nc, bh = z / p.nc;
  const int h = bh % p.H, b = bh / p.H, g = group_of(h, p.H, p.G);
  const int s0 = c * p.Q, q = min(p.Q, p.S - s0), p0 = blockIdx.y * kRows;
  const float cl = chunk_cum(p, b, h, s0, q, cum, dtv);
  if (tid == 0 && blockIdx.y == 0) p.cl[z] = cl;
  const T* xb = static_cast<const T*>(p.x) + b * p.xs.b + h * p.xs.h +
                s0 * p.xs.s;
  const T* bb = static_cast<const T*>(p.bm) + b * p.bs.b + g * p.bs.h +
                s0 * p.bs.s;
  const T* cb = static_cast<const T*>(p.cm) + b * p.cs.b + g * p.cs.h +
                s0 * p.cs.s;
  const float* dyb = p.dy + ((static_cast<long long>(b) * p.S + s0) * p.H +
                             h) * p.P;
  const long long dys = static_cast<long long>(p.H) * p.P;
  const size_t pn = static_cast<size_t>(p.P) * p.N;

  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();                        // the last pass's readers
    if (tid < kMaxQ)
      w[tid] = pass == 0 ? expf(cl - cum[tid]) * dtv[tid] : expf(cum[tid]);
    __syncthreads();
    if (pass == 0)
      stage_rows(A, kRows, xb, p.xs.s, q, p0, p.P, kMaxQ, kRows, Scale{w});
    else
      stage_rows(A, kRows, dyb, dys, q, p0, p.P, kMaxQ, kRows, Scale{w});
    float* out = (pass == 0 ? p.st : p.ut) + static_cast<size_t>(z) * pn;
    for (int n0 = 0; n0 < p.N; n0 += kCols) {
      __syncthreads();
      if (pass == 0)
        stage_rows(Pn, kCols, bb, p.bs.s, q, n0, p.N, kMaxQ, kCols, One{});
      else
        stage_rows(Pn, kCols, cb, p.cs.s, q, n0, p.N, kMaxQ, kCols, One{});
      __syncthreads();
      float acc[4][4];
      zero(acc);
      mm_tile(acc, A, kRows, Pn, kCols, 0, q, r0, c0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pr = p0 + r0 + i, n = n0 + c0 + j;
          if (pr < p.P && n < p.N) out[pr * p.N + n] = acc[i][j];
        }
    }
  }
}

// (b) the two serial passes over the chunks, one (b, h, p, n) a thread.
// Loads go out kBatch chunks at a time, ahead of the stores that depend on
// them: the loop is a chain of memory latencies otherwise.
constexpr int kBatch = 8;
__global__ void __launch_bounds__(256) ssd_bwd_pass_kernel(const BwdArgs p) {
  const int bh = blockIdx.x;
  const int pn = p.P * p.N;
  const int idx = blockIdx.y * 256 + threadIdx.x;
  if (idx >= pn) return;
  const size_t base = static_cast<size_t>(bh) * pn + idx;
  const float* cl = p.cl + bh * p.nc;
  float* st = p.st + static_cast<size_t>(bh) * p.nc * pn + idx;
  float* ut = p.ut + static_cast<size_t>(bh) * p.nc * pn + idx;
  float h = p.h0 != nullptr ? p.h0[base] : 0.f;
  for (int c0 = 0; c0 < p.nc; c0 += kBatch) {
    float v[kBatch], e[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < p.nc) {
        v[k] = st[static_cast<size_t>(c0 + k) * pn];
        e[k] = expf(cl[c0 + k]);
      }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < p.nc) {
        st[static_cast<size_t>(c0 + k) * pn] = h;       // h entering c
        h = e[k] * h + v[k];
      }
  }
  float dh = p.dhf != nullptr ? p.dhf[base] : 0.f;
  for (int c0 = p.nc - 1; c0 >= 0; c0 -= kBatch) {
    float v[kBatch], e[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 - k >= 0) {
        v[k] = ut[static_cast<size_t>(c0 - k) * pn];
        e[k] = expf(cl[c0 - k]);
      }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 - k >= 0) {
        ut[static_cast<size_t>(c0 - k) * pn] = dh;      // dh leaving c
        dh = e[k] * dh + v[k];
      }
  }
  if (p.dh0 != nullptr) p.dh0[base] = dh;
}

constexpr int kQQ = kMaxQ * kMaxQ;
constexpr size_t kGradSmem =
    sizeof(float) * (2 * kQQ + 2 * kMaxQ * kCols + 8 * kMaxQ + 7 * kMaxQ +
                     kThreads);

// (c) every gradient of one (b, h, chunk)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)   // shared memory: one a SM
ssd_bwd_grad_kernel(const BwdArgs p) {
  extern __shared__ __align__(16) float sm[];
  float* Km = sm;                    // [i][j] CB L; later [j][i] dS L dt_j
  float* Dm = Km + kQQ;              // [i][j] dS L
  float* sa = Dm + kQQ;              // staging [32][128] (or col partials)
  float* sb = sa + kMaxQ * kCols;    // staging [128][32] or [32][32]
  float* rp = sb + kMaxQ * kCols;    // row partials [8][128]
  float* cum = rp + 8 * kMaxQ;
  float* dtv = cum + kMaxQ;
  float* ecum = dtv + kMaxQ;         // exp(cum_i)
  float* edec = ecum + kMaxQ;        // exp(cl - cum_j)
  float* vddt = edec + kMaxQ;        // ddt
  float* vdds = vddt + kMaxQ;        // ddt's state term
  float* vdcum = vdds + kMaxQ;       // dcum
  float* red = vdcum + kMaxQ;        // [256]

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int r0 = rg * 4, c0 = cg * 4;
  const int z = blockIdx.x, c = z % p.nc, bh = z / p.nc;
  const int h = bh % p.H, b = bh / p.H, g = group_of(h, p.H, p.G);
  const int s0 = c * p.Q, q = min(p.Q, p.S - s0);
  const float cl = chunk_cum(p, b, h, s0, q, cum, dtv);
  if (tid < kMaxQ) {
    ecum[tid] = expf(cum[tid]);
    edec[tid] = expf(cl - cum[tid]);
  }
  const T* xb = static_cast<const T*>(p.x) + b * p.xs.b + h * p.xs.h +
                s0 * p.xs.s;
  const T* bb = static_cast<const T*>(p.bm) + b * p.bs.b + g * p.bs.h +
                s0 * p.bs.s;
  const T* cb = static_cast<const T*>(p.cm) + b * p.cs.b + g * p.cs.h +
                s0 * p.cs.s;
  const long long rs = static_cast<long long>(p.H) * p.P;  // dy, dx rows
  const long long row0 = (static_cast<long long>(b) * p.S + s0) * p.H + h;
  const float* dyb = p.dy + row0 * p.P;
  T* dxb = static_cast<T*>(p.dx) + row0 * p.P;
  const long long gs = static_cast<long long>(p.H) * p.N;  // dB, dC rows
  float* dbb = p.dbp + row0 * p.N;
  float* dcb = p.dcp + row0 * p.N;
  const size_t pn = static_cast<size_t>(p.P) * p.N;
  const float* hin = p.st + static_cast<size_t>(z) * pn;
  const float* dhl = p.ut + static_cast<size_t>(z) * pn;

  // 1. CB = C B^T over N -> Km = CB L; 2. dS = dy x^T over P -> Dm = dS L,
  // with E = CB L dS summed by row (times dt_j) and by column.  Output
  // columns j = 32 jt + c0 + jj of rows i = r0 + ii; a tile whose columns
  // all lie above the diagonal of this thread's rows is skipped.
  float acc[4][4][4];
  for (int pass = 0; pass < 2; ++pass) {
    const int K = pass == 0 ? p.N : p.P;
#pragma unroll
    for (int jt = 0; jt < 4; ++jt) zero(acc[jt]);
    for (int k0 = 0; k0 < K; k0 += kCols) {
      __syncthreads();
      if (pass == 0) {
        stage_cols(sa, kMaxQ, cb, p.cs.s, q, k0, K, kMaxQ, kCols);
        stage_cols(sb, kMaxQ, bb, p.bs.s, q, k0, K, kMaxQ, kCols);
      } else {
        stage_cols(sa, kMaxQ, dyb, rs, q, k0, K, kMaxQ, kCols);
        stage_cols(sb, kMaxQ, xb, p.xs.s, q, k0, K, kMaxQ, kCols);
      }
      __syncthreads();
#pragma unroll
      for (int jt = 0; jt < 4; ++jt)
        if (32 * jt <= r0 + 3)
          mm_tile(acc[jt], sa, kMaxQ, sb + 32 * jt, kMaxQ, 0, kCols, r0, c0);
    }
    __syncthreads();                        // sa, sb free
    float rowp[4] = {0.f, 0.f, 0.f, 0.f};
    float colp[4][4];
#pragma unroll
    for (int jt = 0; jt < 4; ++jt) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) colp[jt][jj] = 0.f;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = r0 + ii;
        float o[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 32 * jt + c0 + jj;
          const bool keep = j <= i && i < q;
          const float l = keep ? expf(cum[i] - cum[j]) : 0.f;   // select
          const float v = acc[jt][ii][jj];
          if (pass == 0) {
            o[jj] = v * l;
          } else {
            const float e = Km[i * kMaxQ + j] * v;     // dS CB L
            rowp[ii] = fmaf(e, dtv[j], rowp[ii]);
            colp[jt][jj] += e;
            o[jj] = v * l;
          }
        }
        float* dst = (pass == 0 ? Km : Dm) + i * kMaxQ + 32 * jt + c0;
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    if (pass == 1) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) rp[cg * kMaxQ + r0 + ii] = rowp[ii];
#pragma unroll
      for (int jt = 0; jt < 4; ++jt)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          sa[rg * kMaxQ + 32 * jt + c0 + jj] = colp[jt][jj];
    }
  }
  __syncthreads();
  if (tid < kMaxQ) {                        // fixed order: 32 row groups
    float col = 0.f, row = 0.f;
    for (int r = 0; r < 32; ++r) col += sa[r * kMaxQ + tid];
    for (int k = 0; k < 8; ++k) row += rp[k * kMaxQ + tid];
    vddt[tid] = col;
    vdcum[tid] = row - dtv[tid] * col;
  }

  // 3. dx_j = dt_j (sum_i Km_ij dy_i + edec_j dh B_j) over 32-column tiles
  // of P, and ddt's state term edec_j x_j . dh B_j
  float dsp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p0 = 0; p0 < p.P; p0 += kCols) {
    float a1[4][4], a2[4][4];
    zero(a1);
    zero(a2);
    __syncthreads();
    stage_rows(sb, kCols, dyb, rs, q, p0, p.P, kMaxQ, kCols, One{});
    __syncthreads();
    mm_tile(a1, Km, kMaxQ, sb, kCols, r0, q, r0, c0);   // i >= j >= r0
    for (int n0 = 0; n0 < p.N; n0 += kCols) {
      __syncthreads();
      stage_cols(sa, kMaxQ, bb, p.bs.s, q, n0, p.N, kMaxQ, kCols);
      // sb[n][p] = dh[p0 + p][n0 + n]
      stage_cols(sb, kCols, dhl + static_cast<size_t>(p0) * p.N, p.N,
                 min(kCols, p.P - p0), n0, p.N, kCols, kCols);
      __syncthreads();
      mm_tile(a2, sa, kMaxQ, sb, kCols, 0, kCols, r0, c0);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int j = r0 + ii;
      if (j >= q) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int pc = p0 + c0 + jj;
        if (pc >= p.P) continue;
        dsp[ii] = fmaf(to_f32(xb[j * p.xs.s + pc]), a2[ii][jj], dsp[ii]);
        dxb[j * rs + pc] =
            from_f32<T>(dtv[j] * (a1[ii][jj] + edec[j] * a2[ii][jj]));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) rp[cg * kMaxQ + r0 + ii] = dsp[ii];
  __syncthreads();
  if (tid < kMaxQ) {
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += rp[k * kMaxQ + tid];
    s *= edec[tid];
    vdds[tid] = s;
    vddt[tid] += s;
    vdcum[tid] -= dtv[tid] * s;
  }

  // 4. dB_j = dt_j (sum_i Dm_ij C_i + edec_j dh^T x_j), per head
  for (int n0 = 0; n0 < p.N; n0 += kCols) {
    float a1[4][4], a2[4][4];
    zero(a1);
    zero(a2);
    __syncthreads();
    stage_rows(sb, kCols, cb, p.cs.s, q, n0, p.N, kMaxQ, kCols, One{});
    __syncthreads();
    mm_tile(a1, Dm, kMaxQ, sb, kCols, r0, q, r0, c0);
    for (int k0 = 0; k0 < p.P; k0 += kCols) {
      __syncthreads();
      stage_cols(sa, kMaxQ, xb, p.xs.s, q, k0, p.P, kMaxQ, kCols);
      stage_rows(sb, kCols, dhl + static_cast<size_t>(k0) * p.N, p.N,
                 min(kCols, p.P - k0), n0, p.N, kCols, kCols, One{});
      __syncthreads();
      mm_tile(a2, sa, kMaxQ, sb, kCols, 0, kCols, r0, c0);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int j = r0 + ii;
      if (j >= q) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = n0 + c0 + jj;
        if (n < p.N)
          dbb[j * gs + n] = dtv[j] * (a1[ii][jj] + edec[j] * a2[ii][jj]);
      }
    }
  }

  // 5. dC_i = sum_j Dm_ij dt_j B_j + ecum_i h^T dy_i, per head, and the
  // inter-chunk term of dcum, ecum_i C_i . h^T dy_i.  Km (free) takes
  // (Dm dt)^T.
  __syncthreads();
  for (int idx = tid; idx < kQQ; idx += kThreads) {
    const int i = idx / kMaxQ, j = idx % kMaxQ;
    Km[j * kMaxQ + i] = Dm[idx] * dtv[j];
  }
  float inter[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < p.N; n0 += kCols) {
    float a1[4][4], a2[4][4];
    zero(a1);
    zero(a2);
    __syncthreads();
    stage_rows(sb, kCols, bb, p.bs.s, q, n0, p.N, kMaxQ, kCols, One{});
    __syncthreads();
    mm_tile(a1, Km, kMaxQ, sb, kCols, 0, min(r0 + 4, q), r0, c0);  // j <= i
    for (int k0 = 0; k0 < p.P; k0 += kCols) {
      __syncthreads();
      stage_cols(sa, kMaxQ, dyb, rs, q, k0, p.P, kMaxQ, kCols);
      stage_rows(sb, kCols, hin + static_cast<size_t>(k0) * p.N, p.N,
                 min(kCols, p.P - k0), n0, p.N, kCols, kCols, One{});
      __syncthreads();
      mm_tile(a2, sa, kMaxQ, sb, kCols, 0, kCols, r0, c0);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = r0 + ii;
      if (i >= q) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = n0 + c0 + jj;
        if (n >= p.N) continue;
        inter[ii] = fmaf(to_f32(cb[i * p.cs.s + n]), a2[ii][jj], inter[ii]);
        dcb[i * gs + n] = a1[ii][jj] + ecum[i] * a2[ii][jj];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) rp[cg * kMaxQ + r0 + ii] = inter[ii];
  // 6. <dh, h>, each thread over a fixed stride, then in thread order
  float dot = 0.f;
  for (size_t e = tid; e < pn; e += kThreads) dot = fmaf(dhl[e], hin[e], dot);
  red[tid] = dot;
  __syncthreads();
  if (tid < kMaxQ) {
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += rp[k * kMaxQ + tid];
    vdcum[tid] += ecum[tid] * s;
  }
  __syncthreads();
  if (tid == 0) {
    float d = 0.f, r = 0.f;
    for (int k = 0; k < kThreads; ++k) d += red[k];
    for (int j = 0; j < q; ++j) r = fmaf(dtv[j], vdds[j], r);
    vdcum[q - 1] += r + expf(cl) * d;
    float run = 0.f;                        // da = reverse cumsum of dcum
    for (int k = q - 1; k >= 0; --k) {
      run += vdcum[k];
      vdcum[k] = run;
    }
  }
  __syncthreads();
  if (tid < q) {
    const long long at = row0 + static_cast<long long>(tid) * p.H;
    p.ddt[at] = vddt[tid];
    p.da[at] = vdcum[tid];
  }
}

// (d) dB, dC of each group: its heads' partials summed in head order
template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_group_kernel(const BwdArgs p,
                                                            long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % p.N);
  const long long rest = idx / p.N;
  const int g = static_cast<int>(rest % p.G);
  const long long bs = rest / p.G;
  const int hpg = p.H / p.G;
  const long long at = (bs * p.H + static_cast<long long>(g) * hpg) * p.N + n;
  float db = 0.f, dc = 0.f;
  for (int k = 0; k < hpg; ++k) {
    db += p.dbp[at + static_cast<long long>(k) * p.N];
    dc += p.dcp[at + static_cast<long long>(k) * p.N];
  }
  static_cast<T*>(p.dbm)[idx] = from_f32<T>(db);
  static_cast<T*>(p.dcm)[idx] = from_f32<T>(dc);
}

constexpr size_t kChunkSmem =
    sizeof(float) * (kMaxQ * kRows + kMaxQ * kCols + 3 * kMaxQ);

template <typename T>
cudaError_t launch(const BwdArgs& p, int B, cudaStream_t stream) {
  static bool configured = false;   // one attribute call per kernel
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(ssd_bwd_chunk_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kChunkSmem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(ssd_bwd_grad_kernel<T>),
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kGradSmem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int chunks = B * p.H * p.nc;
  ssd_bwd_chunk_kernel<T><<<dim3(chunks, (p.P + kRows - 1) / kRows),
                            kThreads, kChunkSmem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_pass_kernel<<<dim3(B * p.H, (p.P * p.N + 255) / 256), 256, 0,
                        stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_grad_kernel<T><<<chunks, kThreads, kGradSmem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(B) * p.S * p.G * p.N;
  ssd_bwd_group_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256,
                            0, stream>>>(p, total);
  return cudaGetLastError();
}

}  // namespace

// x: (B, S, H, P) by element strides over (b, h, s) with p contiguous; bm,
// cm: (B, S, G, N) by strides over (b, g, s) with n contiguous; dt, a: fp32
// by strides over (b, h, s); h0 (may be null: zeros): contiguous (B, H, P,
// N) fp32; dy: contiguous (B, S, H, P) fp32; dhf: contiguous (B, H, P, N)
// fp32 or null (no gradient).  Outputs, all contiguous: dx (B, S, H, P) and
// dbm, dcm (B, S, G, N) in x's type; ddt, da (B, S, H) fp32; dh0 (B, H, P,
// N) fp32 or null (not wanted).  scratch: fp32, 2 * B * H * nc * P * N +
// B * H * nc + 2 * B * S * H * N floats with nc = ceil(S / Q).  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* bm, const void* cm, const void* dt,
    const void* a, const void* h0, const void* dy, const void* dhf, void* dx,
    void* dbm, void* dcm, void* ddt, void* da, void* dh0, void* scratch,
    int B, int H, int G, int S, int P, int N, int Q, long long x_sb,
    long long x_sh, long long x_ss, long long b_sb, long long b_sg,
    long long b_ss, long long c_sb, long long c_sg, long long c_ss,
    long long dt_sb, long long dt_sh, long long dt_ss, long long a_sb,
    long long a_sh, long long a_ss, int dtype, void* stream) {
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || S < 1 || P < 1 || N < 1 ||
      N > kMaxN || Q < 1 || Q > kMaxQ || B > 65535 || scratch == nullptr)
    return cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  if (static_cast<long long>(B) * H * nc > 0x7fffffffLL ||
      (static_cast<long long>(P) * N + 255) / 256 > 65535)
    return cudaErrorInvalidValue;
  BwdArgs p;
  p.x = x; p.bm = bm; p.cm = cm;
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.h0 = static_cast<const float*>(h0);
  p.dy = static_cast<const float*>(dy);
  p.dhf = static_cast<const float*>(dhf);
  p.dx = dx; p.dbm = dbm; p.dcm = dcm;
  p.ddt = static_cast<float*>(ddt);
  p.da = static_cast<float*>(da);
  p.dh0 = static_cast<float*>(dh0);
  const size_t states = static_cast<size_t>(B) * H * nc * P * N;
  p.st = static_cast<float*>(scratch);
  p.ut = p.st + states;
  p.cl = p.ut + states;
  p.dbp = p.cl + static_cast<size_t>(B) * H * nc;
  p.dcp = p.dbp + static_cast<size_t>(B) * S * H * N;
  p.H = H; p.G = G; p.S = S; p.P = P; p.N = N; p.Q = Q; p.nc = nc;
  p.xs = Strides{x_sb, x_sh, x_ss};
  p.bs = Strides{b_sb, b_sg, b_ss};
  p.cs = Strides{c_sb, c_sg, c_ss};
  p.dts = Strides{dt_sb, dt_sh, dt_ss};
  p.as = Strides{a_sb, a_sh, a_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(p, B, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(p, B, s);
  return cudaErrorInvalidValue;
}
