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
// No atomics: every sum is taken in a fixed order, so two calls give the
// same bits.  The states are recomputed, not kept from the forward: the
// fp32 forward body writes none, and keeping the bf16 body's (25 MB a
// layer at the train shape of mamba2-780m) would hold 1.2 GB across 48
// layers for work that (a) and (b) below redo in a few per cent of the
// call.
//
// fp32: the FMA body, the first version, four kernels a call:
//   (a) ssd_bwd_chunk_kernel, parallel over (b, h, chunk, 128 rows of P):
//       the chunk's own state s_c = sum_j exp(cl - cum_j) dt_j x_j (x) B_j
//       (the forward's, recomputed) and u_c = sum_i exp(cum_i) dy_i (x)
//       C_i, and cl per chunk;
//   (b) ssd_bwd_pass_kernel, elementwise over (b, h, P, N) (four elements
//       a thread, float4, where the states are 16-byte aligned), serial
//       over chunks: forward, h_c from h0 (slot c of s becomes the state entering
//       chunk c); then backward, dh from dh_final (slot c of u becomes the
//       gradient of the state leaving chunk c), ending at dh0;
//   (c) ssd_bwd_grad_kernel, one block a (b, h, chunk): every gradient
//       above for the chunk's rows; dB and dC per head into a scratch;
//   (d) ssd_bwd_group_kernel: dB, dC summed over each group's heads in
//       head order and cast to the inputs' type.
// Every product is one primitive, a 128 x 32 output tile over 256 threads,
// 4 x 4 a thread, both operands from shared memory as float4 (mm_tile).
// (c) keeps CB L and dS L (128 x 128 fp32 each) in shared memory and
// streams the other operands through two 16 KB staging tiles.
//
// bf16: four kernels a call, every product on the tensor cores (wgmma
// m64n64k16, fp32 accumulators), each fp32 factor as bf16 hi + lo (two
// products; three, hi.hi + hi.lo + lo.hi, where both factors are fp32), as
// the forward does:
//   (a) ssd_bwd_chunk_wgmma_kernel, a block of two warpgroups a (b, h,
//       chunk, 64 rows of P): s_c = w^T B and u_c = (exp(cum) dy)^T C, the
//       forward's ssd_state_kernel twice, one a warpgroup;
//   (b) ssd_bwd_pass_kernel, as above;
//   (c) ssd_bwd_grad_wgmma_kernel, a block of two warpgroups a (b, group,
//       chunk, slice of the group's heads): C.B^T once, then each head of
//       the slice in head order.  Every Q x Q product is taken with the
//       key j as its row (warpgroup w owns rows 64w ..): dS^T = x dy^T,
//       K^T = (B C^T) o L^T, dx = dt o (K^T dy + edec o B dh^T), ddt and
//       dcum from E^T = K^T o dS^T in registers.  dB and dC are sums over
//       the heads, and their Q x Q terms share B and C, so
//         dB = Mbar^T C + sum_h diag(dt edec) x_h dh_h,
//         dC = Mbar B + sum_h diag(ecum) dy_h h_h,
//       with Mbar = sum_h D_h diag(dt_h) (D = dS o L) summed over the
//       slice's heads in registers: the Q x Q products of dB and dC run
//       once a slice, not once a head.  A second pass over the heads adds
//       the state terms into the same accumulators, and dcum's state term
//       (ecum_i dy_i . (C h^T)_i), and finishes da; the slice's dB and dC
//       go to a partial (B, G, slice, S, N);
//   (d) ssd_bwd_slice_sum_kernel: the slices' partials summed in slice
//       order and cast to bf16.
// The slices are as many as fit one wave of 132 blocks (the H100's SMs),
// one head each at most: mamba2-780m's 48 heads of one group are 8 slices
// of 6 at its train shape (B * nc = 16, 128 blocks).  A head's P goes in
// 64-column blocks (one tile of x and dy each; every sum over p is a sum
// over the blocks).  Loads: x, B and C by TMA
// over the forward's 4-D tensor maps, dy by TMA as fp32 boxes, h and dh
// by bulk copies where N = 128 (rows past S and columns past P or N
// zero-filled), all on one mbarrier, and the next head's issued while
// this one computes; where a row stride or a base is not a 16-byte
// multiple, or N != 128 (h and dh), every thread loads.  The fp32 tiles land where their hi + lo tiles go and are split
// in place.  The mask selects: only exp(cum_i - cum_j) for j <= i,
// exp(cum_i) and exp(cl - cum_j) are formed.  cum is summed in row order;
// dcum's reverse cumsum, and the column and row sums of E, run in a fixed
// order.
//
// Bound on an H100 at the train shape of mamba2-780m (B=2, S=1024, H=48,
// P=64, N=128, Q=128): operations on the bf16 tensor cores
// (chip_smoke.py: ssd_bwd_work).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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
  float* dbp;          // fp32: (B, S, H, N) per-head dB; bf16: (B, G,
  float* dcp;          // nsl, S, N) each head slice's dB; dC the same
  int H, G, S, P, N, Q, nc;
  int nsl, tma;        // bf16: head slices a group, x/B/C loaded by TMA,
  int tma_dy, bulk;    // dy by TMA, h and dh (N = 128) by bulk copies
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

// (b) the two serial passes over the chunks, V's elements of one (b, h)'s
// (P, N) a thread: float, or float4 where P N is a multiple of 4 and every
// state is 16-byte aligned (the same arithmetic in the same order).  Loads
// go out kBatch chunks at a time, ahead of the stores that depend on them:
// the loop is a chain of memory latencies otherwise.
constexpr int kBatch = 8;
__device__ __forceinline__ float decay(float e, float s, float v) {
  return e * s + v;
}
__device__ __forceinline__ float4 decay(float e, float4 s, float4 v) {
  return make_float4(e * s.x + v.x, e * s.y + v.y, e * s.z + v.z,
                     e * s.w + v.w);
}

template <typename V>
__global__ void __launch_bounds__(256) ssd_bwd_pass_kernel(const BwdArgs p) {
  const int bh = blockIdx.x;
  const int pn = p.P * p.N / static_cast<int>(sizeof(V) / sizeof(float));
  const int idx = blockIdx.y * 256 + threadIdx.x;
  if (idx >= pn) return;
  const size_t base = static_cast<size_t>(bh) * pn + idx;
  const float* cl = p.cl + bh * p.nc;
  V* st = reinterpret_cast<V*>(p.st) + static_cast<size_t>(bh) * p.nc * pn +
          idx;
  V* ut = reinterpret_cast<V*>(p.ut) + static_cast<size_t>(bh) * p.nc * pn +
          idx;
  V h = p.h0 != nullptr ? reinterpret_cast<const V*>(p.h0)[base] : V{};
  for (int c0 = 0; c0 < p.nc; c0 += kBatch) {
    V v[kBatch];
    float e[kBatch];
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
        h = decay(e[k], h, v[k]);
      }
  }
  V dh = p.dhf != nullptr ? reinterpret_cast<const V*>(p.dhf)[base] : V{};
  for (int c0 = p.nc - 1; c0 >= 0; c0 -= kBatch) {
    V v[kBatch];
    float e[kBatch];
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
        dh = decay(e[k], dh, v[k]);
      }
  }
  if (p.dh0 != nullptr) reinterpret_cast<V*>(p.dh0)[base] = dh;
}

// (b) for both bodies, on float4 where it can be
cudaError_t launch_pass(const BwdArgs& p, int B, cudaStream_t stream) {
  const auto a16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if (p.P * p.N % 4 == 0 && a16(p.h0) && a16(p.dhf) && a16(p.dh0))
    ssd_bwd_pass_kernel<float4><<<dim3(B * p.H, (p.P * p.N / 4 + 255) / 256),
                                  256, 0, stream>>>(p);
  else
    ssd_bwd_pass_kernel<float><<<dim3(B * p.H, (p.P * p.N + 255) / 256), 256,
                                 0, stream>>>(p);
  return cudaGetLastError();
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
  e = launch_pass(p, B, stream);
  if (e != cudaSuccess) return e;
  ssd_bwd_grad_kernel<T><<<chunks, kThreads, kGradSmem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(B) * p.S * p.G * p.N;
  ssd_bwd_group_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256,
                            0, stream>>>(p, total);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWG = 128;            // threads of a warpgroup
constexpr int kGrad = 2 * kWG;      // threads of the gradient kernel
constexpr int kBox = 64;            // rows of a TMA box
constexpr int kBlk = kBox * 128;    // bytes of 64 rows x 64 bf16 columns
constexpr int kTile = kMaxQ * 128;  // bytes of a chunk's rows x 64 columns
constexpr int kSbo = 8 * 128;       // bytes between 8-row groups
// blocks of a wave: the SMs of an H100 SXM, fixed so that the head slices
// (head_slices) and so the bits of a call are a function of the shape
// alone; on a card with fewer SMs (the H100 PCIe's 114) a call that fills
// this wave takes two
constexpr int kWave = 132;
constexpr int kMaxP = 64;           // columns of a block of P (one tile)

// 8 fp32 values src[0 .. 7], those at n and past it 0
__device__ __forceinline__ void load8(float (&v)[8], const float* src, int n,
                                      bool vec) {
  if (vec && n >= 8) {
    const float4 u0 = reinterpret_cast<const float4*>(src)[0];
    const float4 u1 = reinterpret_cast<const float4*>(src)[1];
    v[0] = u0.x; v[1] = u0.y; v[2] = u0.z; v[3] = u0.w;
    v[4] = u1.x; v[5] = u1.y; v[6] = u1.z; v[7] = u1.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n ? src[e] : 0.f;
  }
}

// f * v as one 16-byte piece of hi and one of lo at byte `at`
__device__ __forceinline__ void put8(unsigned char* hi, unsigned char* lo,
                                     int at, const float (&v)[8], float f) {
  uint4 h4, l4;
  split2(f * v[0], f * v[1], h4.x, l4.x);
  split2(f * v[2], f * v[3], h4.y, l4.y);
  split2(f * v[4], f * v[5], h4.z, l4.z);
  split2(f * v[6], f * v[7], h4.w, l4.w);
  *reinterpret_cast<uint4*>(hi + at) = h4;
  *reinterpret_cast<uint4*>(lo + at) = l4;
}

// The fp32 operands (dy, h, dh) land in the very 32 KB their hi + lo tiles
// take (by TMA and bulk copies, or by every thread where a row is not
// 16-byte aligned or N != 128), then are split in place: the copies hold
// no registers while they fly, so a head's loads go out together, and the
// next head's while this one computes.  A staged tile is 1024 pieces of 8
// floats (32 bytes, piece t at 32 t; every thread stages 16 bytes at a
// time, consecutive threads consecutive bytes), split 4 pieces a thread.
constexpr int kIt = kMaxQ * 8 / kGrad;   // pieces a thread, 256 threads

// 4 floats at src, those at n and past it 0, into dst.  The thread loads
// below stage one such piece at a time (their loops are not unrolled):
// unrolled, all of a tile's loads would be held in registers at once where
// the kernel already holds its accumulators, and ptxas spills them on
// every path, taken or not (648 bytes a thread at P <= 64, and a slower
// call where the fallback is never taken).
__device__ __forceinline__ void stage4(unsigned char* dst, const float* src,
                                       int n) {
  float* d = reinterpret_cast<float*>(dst);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = e < n ? src[e] : 0.f;
}

// rows [0, 128) x columns [0, 64) of a head's fp32 rows (B, S, H, P) from
// src (row stride rs) staged at dst, row-major; rows at q and past it,
// columns at P and past it, 0
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const float* src, long long rs,
                                           int q, int P) {
#pragma unroll 1
  for (int it = 0; it < 2 * kIt; ++it) {
    const int u = threadIdx.x + it * kGrad, r = u >> 4, c4 = u & 15;
    stage4(dst + 16 * u, src + r * rs + 4 * c4, r < q ? P - 4 * c4 : 0);
  }
}

// a (P, N) fp32 state from src (rows p, columns n, row stride N) staged at
// dst as 64 rows of 128 floats, as a bulk copy lays it where N = 128; rows
// past P and columns past N 0
__device__ __forceinline__ void stage_state(unsigned char* dst,
                                            const float* src, int P, int N) {
#pragma unroll 1
  for (int it = 0; it < 2 * kIt; ++it) {
    const int u = threadIdx.x + it * kGrad, r = u >> 5, n4 = u & 31;
    stage4(dst + 16 * u, src + r * N + 4 * n4, r < P ? N - 4 * n4 : 0);
  }
}

// this thread's staged pieces
__device__ __forceinline__ void read_staged(float (&v)[kIt][8],
                                            const unsigned char* at) {
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const float4* f = reinterpret_cast<const float4*>(
        at + 32 * (threadIdx.x + it * kGrad));
    const float4 u0 = f[0], u1 = f[1];
    v[it][0] = u0.x; v[it][1] = u0.y; v[it][2] = u0.z; v[it][3] = u0.w;
    v[it][4] = u1.x; v[it][5] = u1.y; v[it][6] = u1.z; v[it][7] = u1.w;
  }
}

// the staged rows at hi (hi and lo the two halves of it) split in place
// into hi + lo tiles of 128 rows x 64 columns, times f[row] (f may be
// null).  Every thread calls it.
__device__ void split_rows(unsigned char* hi, unsigned char* lo,
                           const float* f) {
  float v[kIt][8];
  read_staged(v, hi);
  __syncthreads();                           // every piece read
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int t = threadIdx.x + it * kGrad, r = t >> 3, cc = t & 7;
    put8(hi, lo, sw128(r, cc), v[it], f == nullptr ? 1.f : f[r]);
  }
}

// the staged state at hi split in place into hi + lo: two column blocks of
// 64 rows each (piece t: column block t / 512, row t / 8 % 64, columns 8
// (t % 8) ..).  With `other` (a state staged the same way) given, returns
// this thread's share of <state, other>.  Every thread calls it.
__device__ __forceinline__ int state_piece(int t) {
  return (t / 8 % kBox) * 512 + (t / (kBox * 8)) * 256 + (t % 8) * 32;
}

__device__ float split_state(unsigned char* hi, unsigned char* lo,
                             const unsigned char* other) {
  float v[kIt][8];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const float4* f = reinterpret_cast<const float4*>(
        hi + state_piece(threadIdx.x + it * kGrad));
    const float4 u0 = f[0], u1 = f[1];
    v[it][0] = u0.x; v[it][1] = u0.y; v[it][2] = u0.z; v[it][3] = u0.w;
    v[it][4] = u1.x; v[it][5] = u1.y; v[it][6] = u1.z; v[it][7] = u1.w;
  }
  float dot = 0.f;
  if (other != nullptr) {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const float4* f = reinterpret_cast<const float4*>(
          other + state_piece(threadIdx.x + it * kGrad));
      const float4 u0 = f[0], u1 = f[1];
      const float o[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(v[it][e], o[e], dot);
    }
  }
  __syncthreads();                           // every piece read
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int t = threadIdx.x + it * kGrad;
    const int kb = t / (kBox * 8), r = t / 8 % kBox, cc = t % 8;
    put8(hi, lo, kb * kBlk + sw128(r, cc), v[it], 1.f);
  }
  return dot;
}

// the chunk kernel's dy rows: this thread's kIt pieces, loaded into
// registers (every load issued before any value is used)
__device__ __forceinline__ void load_rows(float (&v)[kIt][8], const float* src,
                                          long long rs, int q, int P) {
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int t = threadIdx.x + it * kGrad, r = t >> 3, cc = t & 7;
    load8(v[it], src + r * rs + cc * 8, r < q ? P - cc * 8 : 0, vec);
  }
}

// f[r] * those rows as hi + lo tiles (128 rows x 64 columns)
__device__ __forceinline__ void put_rows(unsigned char* hi, unsigned char* lo,
                                         const float (&v)[kIt][8],
                                         const float* f) {
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int t = threadIdx.x + it * kGrad, r = t >> 3, cc = t & 7;
    put8(hi, lo, sw128(r, cc), v[it], f[r]);
  }
}

// a and dt of chunk row threadIdx.x < 128 (0 at q and past it)
__device__ __forceinline__ float2 row_a_dt(const BwdArgs& p, int b, int h,
                                           int s0, int q) {
  const int r = threadIdx.x;
  if (r >= q || r >= kMaxQ) return make_float2(0.f, 0.f);
  const long long s = s0 + r;
  return make_float2(p.a[b * p.as.b + h * p.as.h + s * p.as.s],
                     p.dt[b * p.dts.b + h * p.dts.h + s * p.dts.s]);
}

// cum (holding each row's a) summed in place in row order: rows at q and
// past it hold a = 0, so they hold cl; -> cl.  One thread adds from
// registers, 32 rows at a time.  Every thread calls it.
__device__ float scan_cum(float* cum) {
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int k0 = 0; k0 < kMaxQ; k0 += 32) {
      float4* c4 = reinterpret_cast<float4*>(cum + k0);
      float v[32];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 f = c4[k];
        v[4 * k] = f.x; v[4 * k + 1] = f.y; v[4 * k + 2] = f.z;
        v[4 * k + 3] = f.w;
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        run += v[k];
        v[k] = run;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        c4[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                            v[4 * k + 3]);
    }
  }
  __syncthreads();
  return cum[kMaxQ - 1];
}

// x's bf16 tile (128 rows x 64 columns) at src times f[row] as hi + lo
// tiles: piece t holds row t / 8 wherever the swizzle put it.  hi or lo
// may be src itself: each piece is read before it is written.
__device__ __forceinline__ void scale_x(unsigned char* hi, unsigned char* lo,
                                        const unsigned char* src,
                                        const float* f) {
  for (int t = threadIdx.x; t < kMaxQ * 8; t += blockDim.x) {
    const float fr = f[t / 8];
    const uint4 xv = reinterpret_cast<const uint4*>(src)[t];
    const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
    uint4 h4, l4;
    uint32_t* hw = reinterpret_cast<uint32_t*>(&h4);
    uint32_t* lw = reinterpret_cast<uint32_t*>(&l4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xw[e]));
      split2(v.x * fr, v.y * fr, hw[e], lw[e]);
    }
    reinterpret_cast<uint4*>(hi)[t] = h4;
    reinterpret_cast<uint4*>(lo)[t] = l4;
  }
}

// (a) for one (b, h, chunk) and 64 rows of P (from p0, the M of the
// products): warpgroup 0 s_c = w^T B, w_j = exp(cl - cum_j) dt_j x_j;
// warpgroup 1 u_c = (exp(cum) dy)^T C; over both column blocks of N.  The
// A operands are MN-major (rows j), hi + lo; B and C MN-major.  Both
// warpgroups run the same instructions on operands picked by their index.
__global__ void __launch_bounds__(kGrad)
ssd_bwd_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap b_map,
                           const __grid_constant__ CUtensorMap c_map,
                           const BwdArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  unsigned char* bt = align1024(smem_tc);  // B: 2 x (chunk rows x 64 cols)
  unsigned char* ct = bt + 2 * kTile;       // C
  unsigned char* whi = ct + 2 * kTile;
  unsigned char* wlo = whi + kTile;         // x lands here, then w's lo
  unsigned char* uhi = wlo + kTile;         // exp(cum_i) dy_i
  unsigned char* ulo = uhi + kTile;
  float* cum = reinterpret_cast<float*>(ulo + kTile);
  float* fac = cum + kMaxQ;                 // exp(cl - cum_j) dt_j
  float* ecum = fac + kMaxQ;                // exp(cum_i)
  const uint32_t bar = smem_addr(ecum + kMaxQ);

  const int tid = threadIdx.x, wg = tid / kWG;
  const int z = blockIdx.x, c = z % p.nc, bh = z / p.nc;
  const int h = bh % p.H, b = bh / p.H, g = group_of(h, p.H, p.G);
  const int p0 = blockIdx.y * 64;
  const int s0 = c * p.Q, q = min(p.Q, p.S - s0);
  const int nb = (p.N + 63) / 64;
  init_bar(bar);
  if (p.tma) {
    if (tid == 0) {
      mbar_expect_tx(bar, (2 * nb + 1) * kTile);
      for (int k = 0; k < kMaxQ / kBox; ++k) {
        for (int kb = 0; kb < nb; ++kb) {
          tma_load(smem_addr(bt) + kb * kTile + k * kBlk, &b_map, kb * 64,
                   s0 + k * kBox, g, b, bar);
          tma_load(smem_addr(ct) + kb * kTile + k * kBlk, &c_map, kb * 64,
                   s0 + k * kBox, g, b, bar);
        }
        tma_load(smem_addr(wlo) + k * kBlk, &x_map, p0, s0 + k * kBox, h, b,
                 bar);
      }
    }
    for (int t = tid; t < (2 - nb) * kTile / 16; t += kGrad) {
      reinterpret_cast<uint4*>(bt + kTile)[t] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(ct + kTile)[t] = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int kb = 0; kb < 2; ++kb) {
      load_block(bt + kb * kTile,
                 static_cast<const bf16*>(p.bm) + b * p.bs.b + g * p.bs.h,
                 p.bs.s, s0, p.S, kb * 64, p.N, kMaxQ);
      load_block(ct + kb * kTile,
                 static_cast<const bf16*>(p.cm) + b * p.cs.b + g * p.cs.h,
                 p.cs.s, s0, p.S, kb * 64, p.N, kMaxQ);
    }
    load_block(wlo, static_cast<const bf16*>(p.x) + b * p.xs.b + h * p.xs.h,
               p.xs.s, s0, p.S, p0, p.P, kMaxQ);
  }
  const float2 ad = row_a_dt(p, b, h, s0, q);
  float vy[kIt][8];
  load_rows(vy,
            p.dy + ((static_cast<long long>(b) * p.S + s0) * p.H + h) * p.P +
                p0,
            static_cast<long long>(p.H) * p.P, q, p.P - p0);
  if (tid < kMaxQ) cum[tid] = ad.x;
  const float cl = scan_cum(cum);
  if (tid < kMaxQ) {
    fac[tid] = expf(cl - cum[tid]) * ad.y;
    ecum[tid] = expf(cum[tid]);
  }
  if (tid == 0 && blockIdx.y == 0) p.cl[z] = cl;
  __syncthreads();
  put_rows(uhi, ulo, vy, ecum);
  if (p.tma) mbar_wait(bar, 0);
  else __syncthreads();
  scale_x(whi, wlo, wlo, fac);
  fence_async_shared();
  __syncthreads();

  float acc[2][32];
#pragma unroll
  for (int kb = 0; kb < 2; ++kb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[kb][i] = 0.f;
  const uint64_t ad_hi = make_desc(smem_addr(wg ? uhi : whi), kTile, kSbo, 1);
  const uint64_t ad_lo = make_desc(smem_addr(wg ? ulo : wlo), kTile, kSbo, 1);
  const uint64_t bd = make_desc(smem_addr(wg ? ct : bt), kTile, kSbo, 1);
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < 2; ++kb)
#pragma unroll
    for (int kk = 0; kk < kMaxQ / 16; ++kk) {   // 16 rows j a slice
      const uint64_t off = (2 * kSbo * kk) >> 4;
      const uint64_t boff = (kb * kTile + 2 * kSbo * kk) >> 4;
      wgmma_ss<64, 1, 1>(acc[kb], ad_hi + off, bd + boff, 1);
      wgmma_ss<64, 1, 1>(acc[kb], ad_lo + off, bd + boff, 1);
    }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // acc[kb][4j + 2r + e]: row p0 + 16 warp + lane / 4 + 8r, column 64 kb +
  // 8j + 2 (lane % 4) + e
  // in column pairs (8-byte stores) where N is even
  const int warp = tid % kWG / 32, lane = tid % 32;
  float* out = (wg ? p.ut : p.st) + static_cast<size_t>(z) * p.P * p.N;
  const bool pairs = p.N % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = p0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= p.P) continue;
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 64 * kb + 8 * j + 2 * (lane % 4), k = 4 * j + 2 * r;
        if (pairs) {
          if (n < p.N)
            *reinterpret_cast<float2*>(out + row * p.N + n) =
                make_float2(acc[kb][k], acc[kb][k + 1]);
        } else {
          if (n < p.N) out[row * p.N + n] = acc[kb][k];
          if (n + 1 < p.N) out[row * p.N + n + 1] = acc[kb][k + 1];
        }
      }
  }
}

// this thread's two rows of a warpgroup tile: rows[r], r = 0, 1
struct Frag {
  int row[2];   // 64 wg + 16 warp + lane / 4 + 8r
  int c0;       // 2 (lane % 4): column of element e of n8 tile t: 8t + c0 + e
};

__device__ __forceinline__ Frag frag() {
  const int tid = threadIdx.x, lane = tid % 32;
  Frag f;
  f.row[0] = 64 * (tid / kWG) + 16 * (tid % kWG / 32) + lane / 4;
  f.row[1] = f.row[0] + 8;
  f.c0 = 2 * (lane % 4);
  return f;
}

// the sum over the four lanes that share a row (lane % 4 differs)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// the sum over the eight lanes that share a column (lane / 4 differs)
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// the sum over the block's threads of v, in a fixed order (warps by a
// shuffle tree, then the warps in order by thread 0); red: a scratch of
// one float a warp.  Every thread calls it; thread 0 gets the sum.
__device__ float block_sum(float v, float* red) {
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) s += red[w];
  return s;
}

constexpr size_t kChunkSmem =
    1024 + 8 * kTile + 3 * sizeof(float) * kMaxQ + 8;

// head h's operands for its 64-column block pb of P on their way into
// shared memory, on the mbarrier where a TMA or bulk copy takes them: x by
// TMA, dy by TMA as fp32 boxes, dh and (where hH is given) h by bulk
// copies, or each by every thread where it cannot be; -> a and dt
// of chunk row threadIdx.x.  Every thread calls it.
__device__ __forceinline__ float2 issue_head(const BwdArgs& p,
                                             const CUtensorMap* x_map,
                                             const CUtensorMap* dy_map,
                                             uint32_t bar, int b, int c,
                                             int h, int pb, int s0, int q,
                                             unsigned char* xT,
                                             unsigned char* dyH,
                                             unsigned char* hH,
                                             unsigned char* dhH) {
  const long long row0 = (static_cast<long long>(b) * p.S + s0) * p.H + h;
  const size_t zh = (static_cast<size_t>(b) * p.H + h) * p.nc + c;
  const int p0 = 64 * pb, pr = min(p.P - p0, 64);   // the block's rows p
  const size_t pn = static_cast<size_t>(p.P) * p.N, at = zh * pn +
                    static_cast<size_t>(p0) * p.N;
  const int sbytes = pr * p.N * 4;
  if (threadIdx.x == 0 && (p.tma || p.tma_dy || p.bulk)) {
    fence_async_shared();
    mbar_expect_tx(bar, (p.tma ? kTile : 0) + (p.tma_dy ? 2 * kTile : 0) +
                            (p.bulk ? (hH != nullptr ? 2 : 1) * sbytes : 0));
    if (p.tma)
      for (int k = 0; k < kMaxQ / kBox; ++k)
        tma_load(smem_addr(xT) + k * kBlk, x_map, p0, s0 + k * kBox, h, b,
                 bar);
    if (p.tma_dy) tma_load(smem_addr(dyH), dy_map, p0, s0, h, b, bar);
    if (p.bulk) {
      if (hH != nullptr) bulk_load(smem_addr(hH), p.st + at, sbytes, bar);
      bulk_load(smem_addr(dhH), p.ut + at, sbytes, bar);
    }
  }
  if (!p.tma)
    load_block(xT, static_cast<const bf16*>(p.x) + b * p.xs.b + h * p.xs.h,
               p.xs.s, s0, p.S, p0, p.P, kMaxQ);
  if (!p.tma_dy)
    stage_rows(dyH, p.dy + row0 * p.P + p0, static_cast<long long>(p.H) * p.P,
               q, pr);
  if (!p.bulk) {
    if (hH != nullptr) stage_state(hH, p.st + at, pr, p.N);
    stage_state(dhH, p.ut + at, pr, p.N);
  } else {                                     // rows past P of the states
    for (int t = sbytes / 16 + threadIdx.x; t < kBox * 32; t += kGrad) {
      if (hH != nullptr)
        reinterpret_cast<uint4*>(hH)[t] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(dhH)[t] = make_uint4(0, 0, 0, 0);
    }
  }
  return row_a_dt(p, b, h, s0, q);
}

// the gradient kernel's shared memory: C, B (2 column blocks of N each),
// the per-thread C.B^T (then Mbar^T as hi + lo, then x_j dt_j edec_j as hi
// + lo), x, dy as hi + lo (then exp(cum) dy), dh as hi + lo (64 rows p, 2
// column blocks of N); nine vectors of the chunk's rows, the 8 warps'
// column partials, a scratch for block sums, the mbarrier
constexpr int kVecs = 9;
constexpr size_t kGradSmem = 1024 + 11 * kTile + 4 * kBlk +
                             sizeof(float) * (kVecs * kMaxQ + 8 * kMaxQ +
                                              32) + 8;

// (c) every gradient of one slice of a group's heads for one (b, chunk);
// kOne: P <= 64, one block of P a head (the loops over blocks fold away)
template <bool kOne>
__global__ void __launch_bounds__(kGrad, 1)
ssd_bwd_grad_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap b_map,
                          const __grid_constant__ CUtensorMap c_map,
                          const __grid_constant__ CUtensorMap dy_map,
                          const BwdArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  unsigned char* cT = align1024(smem_tc);  // C: 2 x (128 rows x 64 cols)
  unsigned char* bT = cT + 2 * kTile;       // B; pass 2: h hi, h lo
  unsigned char* big = bT + 2 * kTile;      // 4 kTile, see above
  unsigned char* xT = big + 4 * kTile;      // x: 128 rows x 64 cols
  unsigned char* dyH = xT + kTile;          // dy hi, lo; pass 2: ecum dy
  unsigned char* dyL = dyH + kTile;
  unsigned char* dhH = dyL + kTile;         // dh hi, lo: 2 x (64 x 64)
  unsigned char* dhL = dhH + 2 * kBlk;
  float* cum = reinterpret_cast<float*>(dhL + 2 * kBlk);
  float* dtv = cum + kMaxQ;
  float* ecum = dtv + kMaxQ;                // exp(cum_i)
  float* edec = ecum + kMaxQ;               // exp(cl - cum_j)
  float* vddt = edec + kMaxQ;               // ddt
  float* vdds = vddt + kMaxQ;               // ddt's state term
  float* vdc = vdds + kMaxQ;                // dcum
  float* vst = vdc + kMaxQ;                 // dcum's state term
  float* fac = vst + kMaxQ;                 // dt_j edec_j
  float* colp = fac + kMaxQ;                // [8 warps][128 columns i]
  float* red = colp + 8 * kMaxQ;            // [32]
  const uint32_t bar = smem_addr(red + 32);
  float* cbs = reinterpret_cast<float*>(big);  // [64][kGrad] per thread
  unsigned char* mH = big;                  // Mbar^T hi: 2 x (128 x 64)
  unsigned char* mL = big + 2 * kTile;
  unsigned char* xsH = big;                 // pass 2: x dt edec hi, lo
  unsigned char* xsL = big + kTile;
  unsigned char* hH = bT;                   // pass 2: h hi, lo
  unsigned char* hL = bT + 2 * kBlk;

  const int tid = threadIdx.x, wg = tid / kWG, lane = tid % 32;
  const Frag fr = frag();
  const int z = blockIdx.x, sl = z % p.nsl, rest = z / p.nsl;
  const int c = rest % p.nc, bg = rest / p.nc, g = bg % p.G, b = bg / p.G;
  const int hpg = p.H / p.G;
  const int h_begin = g * hpg + sl * hpg / p.nsl;
  const int h_end = g * hpg + (sl + 1) * hpg / p.nsl;
  const int s0 = c * p.Q, q = min(p.Q, p.S - s0);
  const bf16* bg16 = static_cast<const bf16*>(p.bm);
  const bf16* cg16 = static_cast<const bf16*>(p.cm);
  const long long rs = static_cast<long long>(p.H) * p.P;  // dy, dx rows
  int ph = 0;                                // the mbarrier's phase
  const bool async_tx = p.tma || p.tma_dy || p.bulk;
  init_bar(bar);

  // C and B of the chunk, 2 column blocks of N each
  const int nb = (p.N + 63) / 64;
  if (p.tma) {
    if (tid == 0) {
      mbar_expect_tx(bar, 2 * nb * kTile);
      for (int kb = 0; kb < nb; ++kb)
        for (int k = 0; k < kMaxQ / kBox; ++k) {
          tma_load(smem_addr(cT) + kb * kTile + k * kBlk, &c_map, kb * 64,
                   s0 + k * kBox, g, b, bar);
          tma_load(smem_addr(bT) + kb * kTile + k * kBlk, &b_map, kb * 64,
                   s0 + k * kBox, g, b, bar);
        }
    }
    for (int t = tid; t < (2 - nb) * kTile / 16; t += kGrad) {
      reinterpret_cast<uint4*>(cT + kTile)[t] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(bT + kTile)[t] = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int kb = 0; kb < 2; ++kb) {
      load_block(cT + kb * kTile, cg16 + b * p.cs.b + g * p.cs.h, p.cs.s, s0,
                 p.S, kb * 64, p.N, kMaxQ);
      load_block(bT + kb * kTile, bg16 + b * p.bs.b + g * p.bs.h, p.bs.s, s0,
                 p.S, kb * 64, p.N, kMaxQ);
    }
  }
  fence_async_shared();
  __syncthreads();
  if (p.tma) {
    mbar_wait(bar, ph);
    ph ^= 1;
  }

  const uint64_t cK = make_desc(smem_addr(cT), 16, kSbo, 1);    // K-major
  const uint64_t bK = make_desc(smem_addr(bT), 16, kSbo, 1);
  const uint64_t cM = make_desc(smem_addr(cT), kTile, kSbo, 1); // MN-major
  const uint64_t bM = make_desc(smem_addr(bT), kTile, kSbo, 1);
  const uint64_t xK = make_desc(smem_addr(xT), 16, kSbo, 1);
  const uint64_t dyhK = make_desc(smem_addr(dyH), 16, kSbo, 1);
  const uint64_t dylK = make_desc(smem_addr(dyL), 16, kSbo, 1);
  const uint64_t dyhM = make_desc(smem_addr(dyH), kTile, kSbo, 1);
  const uint64_t dylM = make_desc(smem_addr(dyL), kTile, kSbo, 1);
  const uint64_t dhhK = make_desc(smem_addr(dhH), 16, kSbo, 1);
  const uint64_t dhlK = make_desc(smem_addr(dhL), 16, kSbo, 1);
  const uint64_t dhhM = make_desc(smem_addr(dhH), kBlk, kSbo, 1);
  const uint64_t dhlM = make_desc(smem_addr(dhL), kBlk, kSbo, 1);

  // CB^T = B C^T: rows j (this warpgroup's 64), columns i in two halves,
  // kept per thread in shared memory (fragment element k of half ih at
  // cbs[(32 ih + k) * kGrad + tid])
  {
    float cb[2][32];
#pragma unroll
    for (int ih = 0; ih < 2; ++ih)
#pragma unroll
      for (int k = 0; k < 32; ++k) cb[ih][k] = 0.f;
    fence_regs(cb[0]);
    fence_regs(cb[1]);
    wgmma_fence();
#pragma unroll
    for (int ih = 0; ih < 2; ++ih)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {          // 16 columns n a slice
        const int kb = kk / 4, ko = 32 * (kk % 4);
        wgmma_ss<64>(cb[ih], bK + ((kb * kTile + wg * kBlk + ko) >> 4),
                     cK + ((kb * kTile + ih * kBlk + ko) >> 4), 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cb[0]);
    fence_regs(cb[1]);
#pragma unroll
    for (int ih = 0; ih < 2; ++ih)
#pragma unroll
      for (int k = 0; k < 32; ++k)
        cbs[(32 * ih + k) * kGrad + tid] = cb[ih][k];
  }

  // pass 1, each head of the slice, each 64-column block pb of its P: dx,
  // dS^T, ddt, dcum (less its state term) and Mbar^T += diag(dt) D^T; the
  // row and column sums add up over the blocks (all of them are linear in
  // dS), ddt and dcum go out after the last.  The products that read x, dy
  // and dh run first, so the next block's copies fly during the
  // elementwise part.
  float mb[2][32];
#pragma unroll
  for (int ih = 0; ih < 2; ++ih)
#pragma unroll
    for (int k = 0; k < 32; ++k) mb[ih][k] = 0.f;
  float2 ad = make_float2(0.f, 0.f);         // a, dt of row tid, next head
  const int np = kOne ? 1 : (p.P + 63) / 64, nv = (h_end - h_begin) * np;
  if (nv > 0)
    ad = issue_head(p, &x_map, &dy_map, bar, b, c, h_begin, 0, s0, q, xT,
                    dyH, nullptr, dhH);
  for (int vi = 0; vi < nv; ++vi) {
    const int h = h_begin + (kOne ? vi : vi / np), pb = kOne ? 0 : vi % np;
    const long long row0 = (static_cast<long long>(b) * p.S + s0) * p.H + h;
    if (async_tx) {
      mbar_wait(bar, ph);
      ph ^= 1;
    }
    if (tid < kMaxQ) {
      cum[tid] = ad.x;
      dtv[tid] = ad.y;
    }
    __syncthreads();                           // every copy landed
    split_rows(dyH, dyL, nullptr);
    split_state(dhH, dhL, nullptr);
    const float cl = scan_cum(cum);
    if (tid < kMaxQ) edec[tid] = expf(cl - cum[tid]);
    fence_async_shared();
    __syncthreads();
    const float cj[2] = {cum[fr.row[0]], cum[fr.row[1]]};
    const float dj[2] = {dtv[fr.row[0]], dtv[fr.row[1]]};
    // the warp's first row: an n8 tile of keys i0 .. i0 + 7 holds nothing
    // it selects where i0 + 7 < jw (above the diagonal) or i0 >= q
    const int jw = fr.row[0] - lane / 4;

    // dx = dt o (edec o B dh^T + K^T dy): rows j, columns p
    float dxa[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) dxa[k] = 0.f;
    fence_regs(dxa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {            // 16 columns n a slice
      const int kb = kk / 4, ko = 32 * (kk % 4);
      const uint64_t a = bK + ((kb * kTile + wg * kBlk + ko) >> 4);
      const uint64_t o = (kb * kBlk + ko) >> 4;
      wgmma_ss<64>(dxa, a, dhhK + o, 1);
      wgmma_ss<64>(dxa, a, dhlK + o, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dxa);
    // ddt's state term edec_j x_j . (B dh^T)_j, then the edec_j scale
    {
      float xd[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  xT + sw128(fr.row[r], t) + 2 * fr.c0));
          xd[r] = fmaf(xv.x, dxa[4 * t + 2 * r], xd[r]);
          xd[r] = fmaf(xv.y, dxa[4 * t + 2 * r + 1], xd[r]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float ej = edec[fr.row[r]];
        const float v = ej * quad_sum(xd[r]);
        if (lane % 4 == 0)
          vdds[fr.row[r]] = pb == 0 ? v : vdds[fr.row[r]] + v;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          dxa[4 * t + 2 * r] *= ej;
          dxa[4 * t + 2 * r + 1] *= ej;
        }
      }
    }
    // K^T dy over keys i, four 16-key slices at a time: K^T from the
    // per-thread CB^T and L^T, hi + lo in registers; dy MN-major
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t khi[4][4], klo[4][4];
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          // register rr of the slice: elements 8 s4 + 2 rr + e of half
          // `half` of CB^T: n8 tile 2 s4 + rr / 2, row rr % 2
          const int r = rr & 1, t = 2 * s4 + (rr >> 1);
          const int i0 = 64 * half + 8 * t;
          if (i0 + 7 < jw || i0 >= q) {
            khi[s4][rr] = klo[s4][rr] = 0u;
            continue;
          }
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 64 * half + 8 * t + fr.c0 + e;
            const int k = 8 * s4 + 2 * rr + e;
            const bool in = fr.row[r] <= i && i < q;
            v[e] = in ? cbs[(32 * half + k) * kGrad + tid] *
                            expf(cum[i] - cj[r])
                      : 0.f;
          }
          split2(v[0], v[1], khi[s4][rr], klo[s4][rr]);
        }
      fence_regs(dxa);
      fence_regs(khi);
      fence_regs(klo);
      wgmma_fence();
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        const uint64_t o = (2 * kSbo * (4 * half + s4)) >> 4;
        wgmma_rs<1>(dxa, khi[s4], dyhM + o);
        wgmma_rs<1>(dxa, khi[s4], dylM + o);
        wgmma_rs<1>(dxa, klo[s4], dyhM + o);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dxa);
      fence_regs(khi);
      fence_regs(klo);
    }
    {
      bf16* dxb = static_cast<bf16*>(p.dx) + row0 * p.P + 64 * pb;
      const int pr = p.P - 64 * pb;             // the block's columns
      const bool pairs = p.P % 2 == 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = fr.row[r];
        if (j >= q) continue;
        const float dj2 = dj[r];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int col = 8 * t + fr.c0, k = 4 * t + 2 * r;
          bf16* dst = dxb + j * rs + col;
          if (pairs) {
            if (col < pr)
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(dj2 * dxa[k], dj2 * dxa[k + 1]);
          } else {
            if (col < pr) dst[0] = __float2bfloat16(dj2 * dxa[k]);
            if (col + 1 < pr) dst[1] = __float2bfloat16(dj2 * dxa[k + 1]);
          }
        }
      }
    }

    // dS^T = x dy^T (rows j, columns i), one 64-column half of i at a
    // time: D^T = dS^T o L^T, E^T = CB^T o D^T; ddt_j = sum_i E^T_ji
    // (rows), sum_j E^T_ji dt_j (columns, for dcum_i), Mbar^T += dt_j D^T.
    // The next head's copies go out once the last product has read x, dy
    // and dh.
    float rowe[2] = {0.f, 0.f};
#pragma unroll
    for (int ih = 0; ih < 2; ++ih) {
      float ds[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) ds[k] = 0.f;
      fence_regs(ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kMaxP / 16; ++kk) {  // 16 columns p a slice
        const uint64_t a = xK + ((wg * kBlk + 32 * kk) >> 4);
        const uint64_t o = (ih * kBlk + 32 * kk) >> 4;
        wgmma_ss<64>(ds, a, dyhK + o, 1);
        wgmma_ss<64>(ds, a, dylK + o, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ds);
      if (ih == 1) {
        __syncthreads();                       // x, dy, dh read
        if (vi + 1 < nv)
          ad = issue_head(p, &x_map, &dy_map, bar, b, c,
                          h_begin + (vi + 1) / np, (vi + 1) % np, s0, q, xT,
                          dyH, nullptr, dhH);
      }
      float col[8][2];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int i0 = 64 * ih + 8 * t;
        if (i0 + 7 < jw || i0 >= q) {
          col[t][0] = col[t][1] = 0.f;
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = i0 + fr.c0 + e;
          float cs = 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int k = 4 * t + 2 * r + e;
            const bool in = fr.row[r] <= i && i < q;
            const float lv = in ? expf(cum[i] - cj[r]) : 0.f;   // select
            const float d = ds[k] * lv;
            const float ev = cbs[(32 * ih + k) * kGrad + tid] * d;
            rowe[r] += ev;
            cs = fmaf(ev, dj[r], cs);
            mb[ih][k] = fmaf(dj[r], d, mb[ih][k]);
          }
          col[t][e] = column_sum(cs);
        }
      }
      if (lane < 4) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& cp = colp[(tid / 32) * kMaxQ + 64 * ih + 8 * t + fr.c0 + e];
            cp = pb == 0 ? col[t][e] : cp + col[t][e];
          }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(rowe[r]);
      if (lane % 4 == 0)
        vddt[fr.row[r]] = pb == 0 ? v : vddt[fr.row[r]] + v;
    }
    if (pb == np - 1) {                        // the head's last block
      __syncthreads();                           // vddt, vdds, colp written
      if (tid < 32) {                            // sum_j dt_j dds_j
        float v = 0.f;
        for (int j = 4 * tid; j < 4 * tid + 4; ++j)
          v = fmaf(dtv[j], vdds[j], v);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if (tid == 0) red[0] = v;
      }
      __syncthreads();
      // ddt; dcum less its state term (pass 2 adds it) into da for now
      if (tid < q) {
        float col = 0.f;
        for (int w = 0; w < kGrad / 32; ++w) col += colp[w * kMaxQ + tid];
        const float ddt = vddt[tid] + vdds[tid];
        const long long at = row0 + static_cast<long long>(tid) * p.H;
        p.ddt[at] = ddt;
        p.da[at] = col - dtv[tid] * ddt + (tid == q - 1 ? red[0] : 0.f);
      }
    }
    __syncthreads();                           // cum, dtv, red read
  }

  // dB = Mbar^T C and dC = Mbar B, Mbar^T as hi + lo in shared memory
  // (rows j, two column blocks of i): K-major for dB, MN-major for dC
  __syncthreads();                             // every C.B^T read
#pragma unroll
  for (int ih = 0; ih < 2; ++ih)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = 4 * t + 2 * r;
        uint32_t hi, lo;
        split2(mb[ih][k], mb[ih][k + 1], hi, lo);
        const int at = ih * kTile + sw128(fr.row[r], t) + 2 * fr.c0;
        *reinterpret_cast<uint32_t*>(mH + at) = hi;
        *reinterpret_cast<uint32_t*>(mL + at) = lo;
      }
  fence_async_shared();
  __syncthreads();
  float ab[2][32], ac[2][32];                  // dB rows j, dC rows i
#pragma unroll
  for (int kb = 0; kb < 2; ++kb)
#pragma unroll
    for (int k = 0; k < 32; ++k) ab[kb][k] = ac[kb][k] = 0.f;
  {
    const uint64_t mhK = make_desc(smem_addr(mH), 16, kSbo, 1);
    const uint64_t mlK = make_desc(smem_addr(mL), 16, kSbo, 1);
    const uint64_t mhM = make_desc(smem_addr(mH), kTile, kSbo, 1);
    const uint64_t mlM = make_desc(smem_addr(mL), kTile, kSbo, 1);
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      fence_regs(ab[kb]);
      fence_regs(ac[kb]);
    }
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {          // 16 keys a slice
        const uint64_t a = (kk / 4 * kTile + wg * kBlk + 32 * (kk % 4)) >> 4;
        const uint64_t am = (wg * kTile + 2 * kSbo * kk) >> 4;
        const uint64_t o = (kb * kTile + 2 * kSbo * kk) >> 4;
        wgmma_ss<64, 0, 1>(ab[kb], mhK + a, cM + o, 1);
        wgmma_ss<64, 0, 1>(ab[kb], mlK + a, cM + o, 1);
        wgmma_ss<64, 1, 1>(ac[kb], mhM + am, bM + o, 1);
        wgmma_ss<64, 1, 1>(ac[kb], mlM + am, bM + o, 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      fence_regs(ab[kb]);
      fence_regs(ac[kb]);
    }
  }

  // pass 2, each head of the slice, each 64-column block of its P: the
  // state terms of dB and dC into the same accumulators, dcum's state term
  // (and <dh, h>) summed over the blocks, and da after the last.  The next
  // block's copies fly during this one's epilogue.
  const uint64_t xshK = make_desc(smem_addr(xsH), 16, kSbo, 1);
  const uint64_t xslK = make_desc(smem_addr(xsL), 16, kSbo, 1);
  const uint64_t hhK = make_desc(smem_addr(hH), 16, kSbo, 1);
  const uint64_t hlK = make_desc(smem_addr(hL), 16, kSbo, 1);
  const uint64_t hhM = make_desc(smem_addr(hH), kBlk, kSbo, 1);
  const uint64_t hlM = make_desc(smem_addr(hL), kBlk, kSbo, 1);
  __syncthreads();                             // B and Mbar read
  if (nv > 0)
    ad = issue_head(p, &x_map, &dy_map, bar, b, c, h_begin, 0, s0, q, xT,
                    dyH, hH, dhH);
  float dot = 0.f;                             // this thread's <h, dh>
  for (int vi = 0; vi < nv; ++vi) {
    const int h = h_begin + (kOne ? vi : vi / np), pb = kOne ? 0 : vi % np;
    const long long row0 = (static_cast<long long>(b) * p.S + s0) * p.H + h;
    const float* dyb = p.dy + row0 * p.P + 64 * pb;
    if (async_tx) {
      mbar_wait(bar, ph);
      ph ^= 1;
    }
    if (tid < kMaxQ) {
      cum[tid] = ad.x;
      dtv[tid] = ad.y;
    }
    const float cl = scan_cum(cum);            // every copy landed, too
    if (tid < kMaxQ) {
      ecum[tid] = expf(cum[tid]);
      fac[tid] = dtv[tid] * expf(cl - cum[tid]);
    }
    __syncthreads();
    split_rows(dyH, dyL, ecum);                // exp(cum_i) dy_i
    dot = (pb == 0 ? 0.f : dot) + split_state(hH, hL, dhH);
    split_state(dhH, dhL, nullptr);
    scale_x(xsH, xsL, xT, fac);                // x_j dt_j edec_j
    fence_async_shared();
    __syncthreads();

    float tt[32];                              // C h^T: rows i, columns p
#pragma unroll
    for (int k = 0; k < 32; ++k) tt[k] = 0.f;
    fence_regs(tt);
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      fence_regs(ab[kb]);
      fence_regs(ac[kb]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {            // 16 columns n a slice
      const int kb = kk / 4, ko = 32 * (kk % 4);
      const uint64_t a = cK + ((kb * kTile + wg * kBlk + ko) >> 4);
      const uint64_t o = (kb * kBlk + ko) >> 4;
      wgmma_ss<64>(tt, a, hhK + o, 1);
      wgmma_ss<64>(tt, a, hlK + o, 1);
    }
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int kk = 0; kk < kMaxP / 16; ++kk) {  // 16 rows p a slice
        const uint64_t a = (wg * kBlk + 32 * kk) >> 4;
        const uint64_t o = (kb * kBlk + 2 * kSbo * kk) >> 4;
        wgmma_ss<64, 0, 1>(ab[kb], xshK + a, dhhM + o, 1);
        wgmma_ss<64, 0, 1>(ab[kb], xshK + a, dhlM + o, 1);
        wgmma_ss<64, 0, 1>(ab[kb], xslK + a, dhhM + o, 1);
        wgmma_ss<64, 0, 1>(ac[kb], dyhK + a, hhM + o, 1);
        wgmma_ss<64, 0, 1>(ac[kb], dyhK + a, hlM + o, 1);
        wgmma_ss<64, 0, 1>(ac[kb], dylK + a, hhM + o, 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tt);
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      fence_regs(ab[kb]);
      fence_regs(ac[kb]);
    }
    // dcum's state term ecum_i dy_i . (C h^T)_i
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = fr.row[r];
      float v = 0.f;
      if (i < q) {
        const float* dyr = dyb + i * rs;
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * t + fr.c0 + e;
            if (col < p.P - 64 * pb)
              v = fmaf(dyr[col], tt[4 * t + 2 * r + e], v);
          }
      }
      v = ecum[i] * quad_sum(v);
      if (lane % 4 == 0) vst[i] = pb == 0 ? v : vst[i] + v;
    }
    __syncthreads();                           // x, dy, h, dh read
    if (vi + 1 < nv)
      ad = issue_head(p, &x_map, &dy_map, bar, b, c, h_begin + (vi + 1) / np,
                      (vi + 1) % np, s0, q, xT, dyH, hH, dhH);
    if (pb < np - 1) continue;                 // not the head's last block
    const float dhh = block_sum(dot, red);     // <dh, h>, in thread 0
    if (tid == 0) red[31] = expf(cl) * dhh;
    __syncthreads();
    if (tid < q)
      vdc[tid] = p.da[row0 + static_cast<long long>(tid) * p.H] + vst[tid] +
                 (tid == q - 1 ? red[31] : 0.f);
    __syncthreads();
    if (tid == 0) {                            // da: dcum's reverse cumsum
      float run = 0.f;
      for (int k1 = q; k1 > 0; k1 -= 32) {
        const int k0 = max(0, k1 - 32);
        float rv[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) rv[k] = k0 + k < k1 ? vdc[k0 + k] : 0.f;
#pragma unroll
        for (int k = 31; k >= 0; --k) {
          run += rv[k];
          rv[k] = run;
        }
#pragma unroll
        for (int k = 0; k < 32; ++k)
          if (k0 + k < k1) vdc[k0 + k] = rv[k];
      }
    }
    __syncthreads();
    if (tid < q) p.da[row0 + static_cast<long long>(tid) * p.H] = vdc[tid];
    __syncthreads();                           // cum, ecum, vdc, red read
  }

  // this slice's dB (rows j) and dC (rows i) into its partial
  {
    const size_t slice = static_cast<size_t>(p.S) * p.N;
    const size_t at =
        ((static_cast<size_t>(b) * p.G + g) * p.nsl + sl) * slice;
    float* pb = p.dbp + at;
    float* pc = p.dcp + at;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = fr.row[r];
      if (j >= q) continue;
      const size_t row = static_cast<size_t>(s0 + j) * p.N;
#pragma unroll
      for (int kb = 0; kb < 2; ++kb)
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 64 * kb + 8 * t + fr.c0 + e;
            if (n < p.N) {
              pb[row + n] = ab[kb][4 * t + 2 * r + e];
              pc[row + n] = ac[kb][4 * t + 2 * r + e];
            }
          }
    }
  }
}

// (d) dB, dC of each group: its head slices' partials summed in slice
// order, cast to bf16
__global__ void __launch_bounds__(256) ssd_bwd_slice_sum_kernel(
    const BwdArgs p, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % p.N);
  const long long rest = idx / p.N;
  const int g = static_cast<int>(rest % p.G);
  const long long bs = rest / p.G;
  const long long b = bs / p.S, s = bs % p.S;
  const size_t slice = static_cast<size_t>(p.S) * p.N;
  const size_t at = (static_cast<size_t>(b) * p.G + g) * p.nsl * slice +
                    static_cast<size_t>(s) * p.N + n;
  float db = 0.f, dc = 0.f;
  for (int k = 0; k < p.nsl; ++k) {
    db += p.dbp[at + k * slice];
    dc += p.dcp[at + k * slice];
  }
  static_cast<bf16*>(p.dbm)[idx] = __float2bfloat16(db);
  static_cast<bf16*>(p.dcm)[idx] = __float2bfloat16(dc);
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t launch(const BwdArgs& p, int B, cudaStream_t stream) {
  static bool configured = false;   // one attribute call per kernel
  if (!configured) {
    cudaError_t e = set_smem(
        reinterpret_cast<const void*>(ssd_bwd_chunk_wgmma_kernel), kChunkSmem);
    if (e == cudaSuccess)
      e = set_smem(
          reinterpret_cast<const void*>(ssd_bwd_grad_wgmma_kernel<true>),
          kGradSmem);
    if (e == cudaSuccess)
      e = set_smem(
          reinterpret_cast<const void*>(ssd_bwd_grad_wgmma_kernel<false>),
          kGradSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap x_map{}, b_map{}, c_map{}, dy_map{};
  if (p.tma) {
    cudaError_t e = make_map(&x_map, p.x, B, p.H, p.S, p.P, p.xs, kBox, 64);
    if (e == cudaSuccess)
      e = make_map(&b_map, p.bm, B, p.G, p.S, p.N, p.bs, kBox, 64);
    if (e == cudaSuccess)
      e = make_map(&c_map, p.cm, B, p.G, p.S, p.N, p.cs, kBox, 64);
    if (e != cudaSuccess) return e;
  }
  if (p.tma_dy) {
    const long long hp = static_cast<long long>(p.H) * p.P;
    const cudaError_t e =
        make_map(&dy_map, p.dy, B, p.H, p.S, p.P,
                 Strides{hp * p.S, p.P, hp}, kMaxQ, 64, true);
    if (e != cudaSuccess) return e;
  }
  const int np = (p.P + 63) / 64;
  ssd_bwd_chunk_wgmma_kernel<<<dim3(B * p.H * p.nc, np), kGrad, kChunkSmem,
                               stream>>>(x_map, b_map, c_map, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_pass(p, B, stream);
  if (e != cudaSuccess) return e;
  const unsigned blocks = B * p.G * p.nc * p.nsl;
  if (p.P <= kMaxP)
    ssd_bwd_grad_wgmma_kernel<true><<<blocks, kGrad, kGradSmem, stream>>>(
        x_map, b_map, c_map, dy_map, p);
  else
    ssd_bwd_grad_wgmma_kernel<false><<<blocks, kGrad, kGradSmem, stream>>>(
        x_map, b_map, c_map, dy_map, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(B) * p.S * p.G * p.N;
  ssd_bwd_slice_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256,
                             0, stream>>>(p, total);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

namespace {

// head slices a group's heads are cut into by the bf16 body: as many as
// fill one wave of tc::kWave blocks (one a head at most), so a call of few
// chunks still spreads over the card; a function of the shape alone
int head_slices(int B, int H, int G, int S, int Q) {
  const long long groups = static_cast<long long>(B) * G * ((S + Q - 1) / Q);
  const long long fit = tc::kWave / groups;
  return static_cast<int>(fit < 1 ? 1 : fit < H / G ? fit : H / G);
}

// floats of scratch the call needs: the chunk states s_c / h_c and u_c /
// dh_c (B, H, nc, P, N) each, cl (B, H, nc), then fp32: per-head dB, dC
// (B, S, H, N) each; bf16: each head slice's dB, dC (B, G, slices, S, N)
long long scratch_floats(int B, int H, int G, int S, int P, int N, int Q,
                         int dtype) {
  const long long nc = (S + Q - 1) / Q;
  const long long base = 2LL * B * H * nc * P * N + 1LL * B * H * nc;
  if (dtype == kFloat32) return base + 2LL * B * S * H * N;
  return base + 2LL * B * G * head_slices(B, H, G, S, Q) * S * N;
}

}  // namespace

extern "C" long long repro_ssd_scan_bwd_scratch(int B, int H, int G, int S,
                                                int P, int N, int Q,
                                                int dtype) {
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || S < 1 || P < 1 || N < 1 ||
      Q < 1)
    return -1;
  return scratch_floats(B, H, G, S, P, N, Q, dtype);
}

// x: (B, S, H, P) by element strides over (b, h, s) with p contiguous; bm,
// cm: (B, S, G, N) by strides over (b, g, s) with n contiguous; dt, a: fp32
// by strides over (b, h, s); h0 (may be null: zeros): contiguous (B, H, P,
// N) fp32; dy: contiguous (B, S, H, P) fp32; dhf: contiguous (B, H, P, N)
// fp32 or null (no gradient).  Outputs, all contiguous: dx (B, S, H, P) and
// dbm, dcm (B, S, G, N) in x's type; ddt, da (B, S, H) fp32; dh0 (B, H, P,
// N) fp32 or null (not wanted).  scratch: fp32, as many floats as
// repro_ssd_scan_bwd_scratch says.  Returns the cudaError_t of the
// launches (0 on success).
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
  const size_t per = dtype == kFloat32
                         ? static_cast<size_t>(B) * S * H * N
                         : static_cast<size_t>(B) * G *
                               head_slices(B, H, G, S, Q) * S * N;
  p.st = static_cast<float*>(scratch);
  p.ut = p.st + states;
  p.cl = p.ut + states;
  p.dbp = p.cl + static_cast<size_t>(B) * H * nc;
  p.dcp = p.dbp + per;
  p.H = H; p.G = G; p.S = S; p.P = P; p.N = N; p.Q = Q; p.nc = nc;
  p.nsl = head_slices(B, H, G, S, Q);
  p.tma = aligned16(x, Strides{x_sb, x_sh, x_ss}, 2) &&
          aligned16(bm, Strides{b_sb, b_sg, b_ss}, 2) &&
          aligned16(cm, Strides{c_sb, c_sg, c_ss}, 2);
  p.tma_dy = P % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  p.bulk = N == 128;                           // the states' rows, as staged
  p.xs = Strides{x_sb, x_sh, x_ss};
  p.bs = Strides{b_sb, b_sg, b_ss};
  p.cs = Strides{c_sb, c_sg, c_ss};
  p.dts = Strides{dt_sb, dt_sh, dt_ss};
  p.as = Strides{a_sb, a_sh, a_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(p, B, s);
  if (dtype == kBFloat16) return tc::launch(p, B, s);
  return cudaErrorInvalidValue;
}
