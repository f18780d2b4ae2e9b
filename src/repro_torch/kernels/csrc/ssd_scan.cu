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
// bf16: three kernels a call, the chunked form of the official Mamba2
// kernels (the algebra of src/repro/models/mamba2.py:_ssd_chunked), all on
// one warpgroup a block and wgmma m64n64k16 with fp32 accumulators:
//   (a) ssd_state_kernel, parallel over (b, h, chunk, 64 columns of N, 64
//       rows of P): the chunk's own state s_c = sum_j w_j (x) B_j with
//       w_j = exp(cum_last - cum_j) dt_j x_j, from h = 0;
//   (b) ssd_pass_kernel, elementwise over (b, h, P, N) and serial over the
//       chunks: h_c = exp(cum_last^c) h_{c-1} + s_c from h0; it overwrites
//       s_c with h_c (the state entering chunk c + 1) and writes h_final.
//       A pass of its own, not a prologue of (c): nc <= 4 at the path's
//       shapes, and the pass reads each s_c once where rebuilding h_{c-1}
//       in every block of chunk c would read s_0 .. s_{c-1} again;
//   (c) ssd_out_kernel, parallel over (b, h, chunk, 64-row half of Q, 64
//       columns of P): y = S x + exp(cum_i) C h_{c-1}^T, where S = select(j
//       <= i, (C B^T)_ij exp(cum_i - cum_j) dt_j, 0).  C B^T is computed
//       again in each head's block on the tensor cores (bf16 x bf16 summed
//       in fp32: exact up to order): ~0.3 GFLOP, ~0.3 us of tensor time a
//       call at the served shape, where storing it once per group would
//       take a fourth kernel and a round trip through memory (the two
//       were not timed against each other).
// Each product has a bf16 factor (B, C or x, exact) and an fp32 one (w, S
// or h), which goes in as hi = bf16(v) plus lo = bf16(v - hi): two wgmmas
// into one fp32 accumulator, about 16 significant bits, as the fp32
// specification needs (one rounding to bf16 misses the check; tests/
// test_torch_kernels.py emulates both).  cum is summed in row order, by one
// warp from registers: |cum| reaches thousands at strong decay, and the
// plain version sums in row order.  Loads: TMA over 4-D tensor maps of the
// strided views, boxes of 64 rows x 64 columns (128 bytes, 128-byte
// swizzle), rows past S and columns past P or N zero-filled, so any P, N
// <= 128 and Q pad to wgmma's 64 rows, 16-deep slices and 64-column tiles
// in shared memory.  Where a row stride or a base is not a 16-byte
// multiple, every thread loads the same swizzled tiles itself instead.
// The wrapper allocates the scratch: the chunk states (B, H, nc, P, N) and
// cum_last (B, H, nc), fp32.
//
// Bound on an H100: bytes at the path's shapes.  The served prefill chunk
// (B=1, S=256, H=48, G=1, P=64, N=128, Q=128) moves about 8 MB (0.0024 ms
// at 3.35 TB/s); its products, each per-head one counted twice (hi + lo)
// and C.B^T once per group, are about 1 GFLOP (0.001 ms at 989 TFLOP/s).
//
// fp32: the FMA body (ssd_scan_kernel<float>), the first version.  A block
// owns (b, h, a tile of PT = 16 rows of h over P) and walks the chunks in a
// loop, h's tile in shared memory; every P tile recomputes the chunk's
// C.B^T scores from shared memory with fp32 FMAs.  Rows are padded one
// word so column walks miss no bank; the state update gives a thread 8
// rows of h at one column, so one B load feeds 8 FMAs.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr int PT = 16;        // rows of h (columns of y) per block
constexpr int RT = 32;        // score rows per tile
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
static_assert(PT % 8 == 0, "the state update gives a thread 8 rows of h");

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


// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWG = 128;          // one warpgroup a block
constexpr int kCols = 64;         // columns of a tile: 128 bytes of bf16
constexpr int kBox = 64;          // rows of a TMA box
constexpr int kBlock64 = kBox * 128;     // bytes of 64 rows x 64 columns
constexpr int kTile = kMaxQ * 128;       // bytes of a chunk's rows x 64 cols
constexpr int kSbo = 8 * 128;     // bytes between 8-row groups

struct ScanArgs {
  const bf16 *x, *bm, *cm;
  const float *dt, *a, *h0;
  float *y, *hout;
  float *st;                      // (B, H, nc, P, N) chunk states
  float *cl;                      // (B, H, nc) cum of each chunk's last row
  int H, G, S, P, N, Q, nc, tma;
  Strides xs, bs, cs, dts, as, ys;
};

__device__ __forceinline__ int group_of(int h, int H, int G) {
  return h / (H / G);
}

// Warp 0: the chunk's a and dt for rows lane + 32k (0 past its q rows) and
// cum, their inclusive sum in row order; returns cum of the last row.
// Each step adds row j's a, broadcast from its lane, to the running sum,
// so the sum runs in the plain version's order.
__device__ __forceinline__ float chunk_cum(const float* ab, long long as,
                                           const float* db, long long ds,
                                           int q, float (&cv)[4],
                                           float (&dv)[4]) {
  const int lane = threadIdx.x % 32;
  float av[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = lane + 32 * k;
    const bool ok = j < q;
    av[k] = ok ? ab[j * as] : 0.f;
    dv[k] = ok ? db[j * ds] : 0.f;
  }
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      run += __shfl_sync(0xffffffffu, av[k], l);
      if (lane == l) cv[k] = run;
    }
  return run;
}

// (a) s_c = sum_j w_j (x) B_j over the chunk for 64 rows of P (the M of
// the product) x 64 columns of N.  Both operands are MN-major in shared
// memory (rows j): A = w as hi and lo, B = the chunk's B.
__global__ void __launch_bounds__(kWG)
ssd_state_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const ScanArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  unsigned char* bt = align1024(smem_tc);  // chunk rows x 64 columns of B
  unsigned char* xt = bt + kTile;           // chunk rows x 64 columns of x
  unsigned char* whi = xt + kTile;
  unsigned char* wlo = whi + kTile;
  float* fac = reinterpret_cast<float*>(wlo + kTile);  // exp(.) dt_j
  const uint32_t bar = smem_addr(fac + kMaxQ);

  const int tid = threadIdx.x;
  const int z = blockIdx.x, c = z % p.nc, bh = z / p.nc;
  const int h = bh % p.H, b = bh / p.H, g = group_of(h, p.H, p.G);
  const int n0 = blockIdx.y * kCols, p0 = blockIdx.z * kCols;
  const int s0 = c * p.Q, q = min(p.Q, p.S - s0);
  init_bar(bar);
  if (p.tma) {
    if (tid == 0) {
      mbar_expect_tx(bar, 2 * kTile);
      for (int k = 0; k < kMaxQ / kBox; ++k) {
        tma_load(smem_addr(bt) + k * kBlock64, &b_map, n0, s0 + k * kBox, g,
                 b, bar);
        tma_load(smem_addr(xt) + k * kBlock64, &x_map, p0, s0 + k * kBox, h,
                 b, bar);
      }
    }
  } else {
    load_block(bt, p.bm + b * p.bs.b + g * p.bs.h, p.bs.s, s0, p.S, n0, p.N,
               kMaxQ);
    load_block(xt, p.x + b * p.xs.b + h * p.xs.h, p.xs.s, s0, p.S, p0, p.P,
               kMaxQ);
  }
  if (tid < 32) {
    float cv[4], dv[4];
    const float last = chunk_cum(
        p.a + b * p.as.b + h * p.as.h + s0 * p.as.s, p.as.s,
        p.dt + b * p.dts.b + h * p.dts.h + s0 * p.dts.s, p.dts.s, q, cv, dv);
#pragma unroll
    for (int k = 0; k < 4; ++k) fac[tid + 32 * k] = expf(last - cv[k]) * dv[k];
    if (tid == 0 && blockIdx.y == 0 && blockIdx.z == 0) p.cl[z] = last;
  }
  __syncthreads();
  if (p.tma) mbar_wait(bar, 0);

  // w = fac_j x_j as hi + lo.  A swizzle moves 16-byte pieces within their
  // row, so piece t of the tile holds row t / 8 wherever it lies.
  for (int t = tid; t < kMaxQ * 8; t += kWG) {
    const float f = fac[t / 8];
    const uint4 xv = reinterpret_cast<const uint4*>(xt)[t];
    const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
    uint4 hi, lo;
    uint32_t* hw = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* lw = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xw[e]));
      split2(v.x * f, v.y * f, hw[e], lw[e]);
    }
    reinterpret_cast<uint4*>(whi)[t] = hi;
    reinterpret_cast<uint4*>(wlo)[t] = lo;
  }
  fence_async_shared();
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint64_t bd = make_desc(smem_addr(bt), kTile, kSbo, 1);
  uint64_t hd = make_desc(smem_addr(whi), kTile, kSbo, 1);
  uint64_t ld = make_desc(smem_addr(wlo), kTile, kSbo, 1);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kMaxQ / 16; ++kk) {     // 16 rows j a slice
    const uint64_t off = (2 * kSbo * kk) >> 4;
    wgmma_ss<64, 1, 1>(acc, hd + off, bd + off, 1);
    wgmma_ss<64, 1, 1>(acc, ld + off, bd + off, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4j + 2r + e]: row p0 + 16 warp + lane / 4 + 8r, column
  // n0 + 8j + 2 (lane % 4) + e
  // in column pairs (8-byte stores) where N is even
  const int warp = tid / 32, lane = tid % 32;
  float* sb = p.st + static_cast<size_t>(z) * p.P * p.N;
  const bool pairs = p.N % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = p0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= p.P) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4), k = 4 * j + 2 * r;
      if (pairs) {
        if (n < p.N)
          *reinterpret_cast<float2*>(sb + row * p.N + n) =
              make_float2(acc[k], acc[k + 1]);
      } else {
        if (n < p.N) sb[row * p.N + n] = acc[k];
        if (n + 1 < p.N) sb[row * p.N + n + 1] = acc[k + 1];
      }
    }
  }
}

// (b) h_c = exp(cum_last^c) h_{c-1} + s_c from h0, element by element of
// (P, N); slot c of the scratch becomes h_c, the state chunk c + 1 starts
// from, and the last is h_final.
__global__ void __launch_bounds__(256) ssd_pass_kernel(const ScanArgs p) {
  const int bh = blockIdx.x;
  const int pn = p.P * p.N;
  const int idx = blockIdx.y * 256 + threadIdx.x;
  if (idx >= pn) return;
  float h = p.h0 != nullptr ? p.h0[static_cast<size_t>(bh) * pn + idx] : 0.f;
  for (int c = 0; c < p.nc; ++c) {
    const size_t at = (static_cast<size_t>(bh) * p.nc + c) * pn + idx;
    const float s = p.st[at];
    h = expf(p.cl[bh * p.nc + c]) * h + s;
    if (c + 1 < p.nc) p.st[at] = h;
  }
  p.hout[static_cast<size_t>(bh) * pn + idx] = h;
}

// (c) y for 64 rows i (half rh of the chunk) x 64 columns of P.  For each
// 64-column block jb <= rh of keys j: CB = C B_jb^T (K-major, over N), the
// scores S in registers, y += S_hi x_jb + S_lo x_jb (x MN-major); then
// y += exp(cum_i) C (h_hi + h_lo)^T (K-major, over N).  NB: 64-column
// blocks of N.
template <int NB>
__global__ void __launch_bounds__(kWG)
ssd_out_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap b_map,
               const __grid_constant__ CUtensorMap c_map, const ScanArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  unsigned char* ct = align1024(smem_tc);  // 64 rows i, NB blocks of N
  unsigned char* bt = ct + NB * kBlock64;   // chunk rows j, NB blocks of N
  unsigned char* xt = bt + NB * kTile;      // chunk rows j x 64 columns of x
  unsigned char* hhi = xt + kTile;          // 64 rows of h_{c-1}, NB blocks
  unsigned char* hlo = hhi + NB * kBlock64;
  float* cum = reinterpret_cast<float*>(hlo + NB * kBlock64);
  float* dtv = cum + kMaxQ;
  const uint32_t bar = smem_addr(dtv + kMaxQ);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int z = blockIdx.x, c = z % p.nc, bh = z / p.nc;
  const int h = bh % p.H, b = bh / p.H, g = group_of(h, p.H, p.G);
  const int rh = blockIdx.y, p0 = blockIdx.z * kCols;
  const int s0 = c * p.Q, q = min(p.Q, p.S - s0);
  init_bar(bar);
  if (p.tma) {
    if (tid == 0) {
      mbar_expect_tx(bar, (NB + (NB + 1) * (rh + 1)) * kBlock64);
      for (int kb = 0; kb < NB; ++kb) {
        tma_load(smem_addr(ct) + kb * kBlock64, &c_map, kb * kCols,
                 s0 + rh * kBox, g, b, bar);
        for (int jb = 0; jb <= rh; ++jb)
          tma_load(smem_addr(bt) + kb * kTile + jb * kBlock64, &b_map,
                   kb * kCols, s0 + jb * kBox, g, b, bar);
      }
      for (int jb = 0; jb <= rh; ++jb)
        tma_load(smem_addr(xt) + jb * kBlock64, &x_map, p0, s0 + jb * kBox,
                 h, b, bar);
    }
  } else {
    const bf16* cb = p.cm + b * p.cs.b + g * p.cs.h;
    const bf16* bb = p.bm + b * p.bs.b + g * p.bs.h;
    for (int kb = 0; kb < NB; ++kb) {
      load_block(ct + kb * kBlock64, cb, p.cs.s, s0 + rh * kBox, p.S,
                 kb * kCols, p.N, kBox);
      load_block(bt + kb * kTile, bb, p.bs.s, s0, p.S, kb * kCols, p.N,
                 (rh + 1) * kBox);
    }
    load_block(xt, p.x + b * p.xs.b + h * p.xs.h, p.xs.s, s0, p.S, p0, p.P,
               (rh + 1) * kBox);
  }
  // h_{c-1} rows p0 .. p0 + 63 as hi + lo, K-major (rows p, columns n)
  {
    const size_t pn = static_cast<size_t>(p.P) * p.N;
    const float* hin =
        c > 0 ? p.st + (static_cast<size_t>(z) - 1) * pn
        : p.h0 != nullptr ? p.h0 + bh * pn : nullptr;
    const bool vec = hin != nullptr && p.N % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(hin) % 16 == 0;
    constexpr int kIt = NB * kBox * 8 / kWG;      // 16-byte pieces a thread
    float v[kIt][8];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {            // every load, then stores
      const int t = tid + it * kWG;
      const int kb = t / (kBox * 8), r = t / 8 % kBox, cc = t % 8;
      const int row = p0 + r, n = kb * kCols + cc * 8;
      if (vec && row < p.P && n + 8 <= p.N) {
        const float4* src =
            reinterpret_cast<const float4*>(hin + row * p.N + n);
        const float4 u0 = src[0], u1 = src[1];
        v[it][0] = u0.x; v[it][1] = u0.y; v[it][2] = u0.z; v[it][3] = u0.w;
        v[it][4] = u1.x; v[it][5] = u1.y; v[it][6] = u1.z; v[it][7] = u1.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[it][e] = (hin != nullptr && row < p.P && n + e < p.N)
                         ? hin[row * p.N + n + e] : 0.f;
      }
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int t = tid + it * kWG;
      const int kb = t / (kBox * 8), r = t / 8 % kBox, cc = t % 8;
      uint4 hi, lo;
      split2(v[it][0], v[it][1], hi.x, lo.x);
      split2(v[it][2], v[it][3], hi.y, lo.y);
      split2(v[it][4], v[it][5], hi.z, lo.z);
      split2(v[it][6], v[it][7], hi.w, lo.w);
      const int at = kb * kBlock64 + sw128(r, cc);
      *reinterpret_cast<uint4*>(hhi + at) = hi;
      *reinterpret_cast<uint4*>(hlo + at) = lo;
    }
  }
  if (tid < 32) {
    float cv[4], dv[4];
    chunk_cum(p.a + b * p.as.b + h * p.as.h + s0 * p.as.s, p.as.s,
              p.dt + b * p.dts.b + h * p.dts.h + s0 * p.dts.s, p.dts.s, q,
              cv, dv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cum[tid + 32 * k] = cv[k];
      dtv[tid + 32 * k] = dv[k];
    }
  }
  fence_async_shared();
  __syncthreads();
  if (p.tma) mbar_wait(bar, 0);

  // this thread's rows of the chunk: rows[r], r = 0, 1
  const int rows[2] = {rh * 64 + 16 * warp + lane / 4,
                       rh * 64 + 16 * warp + lane / 4 + 8};
  const float ci[2] = {cum[rows[0]], cum[rows[1]]};
  const int col0 = 2 * (lane % 4);
  const uint64_t cd = make_desc(smem_addr(ct), 16, kSbo, 1);
  const uint64_t bd = make_desc(smem_addr(bt), 16, kSbo, 1);
  const uint64_t xd = make_desc(smem_addr(xt), kTile, kSbo, 1);
  const uint64_t hd = make_desc(smem_addr(hhi), 16, kSbo, 1);
  const uint64_t ld = make_desc(smem_addr(hlo), 16, kSbo, 1);

  float yi[32], ye[32], cb[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yi[i] = ye[i] = 0.f;
  uint32_t s_hi[4][4], s_lo[4][4];
  for (int jb = 0; jb <= rh; ++jb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) cb[i] = 0.f;
    fence_regs(cb);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < NB; ++kb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t off = (kb * kBlock64 + 32 * kk) >> 4;
        const uint64_t boff = (kb * kTile + jb * kBlock64 + 32 * kk) >> 4;
        wgmma_ss<64>(cb, cd + off, bd + boff, 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cb);
    // cb[4j + 2r + e]: row rows[r], key 64 jb + 8j + col0 + e
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 64 * jb + 8 * j + col0 + e;
          const bool keep = key <= rows[r];
          float& v = cb[4 * j + 2 * r + e];
          v = keep ? v * expf(ci[r] - cum[key]) * dtv[key] : 0.f;
        }
    // register a[r] of k16 slice kk holds cb[8kk + 2r], cb[8kk + 2r + 1]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split2(cb[8 * kk + 2 * r], cb[8 * kk + 2 * r + 1], s_hi[kk][r],
               s_lo[kk][r]);
    fence_regs(yi);
    fence_regs(s_hi);
    fence_regs(s_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {          // 16 keys a slice
      const uint64_t off = (jb * kBlock64 + 2 * kSbo * kk) >> 4;
      wgmma_rs<1>(yi, s_hi[kk], xd + off);
      wgmma_rs<1>(yi, s_lo[kk], xd + off);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yi);
    fence_regs(s_hi);
    fence_regs(s_lo);
  }
  fence_regs(ye);
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < NB; ++kb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {          // 16 columns n a slice
      const uint64_t off = (kb * kBlock64 + 32 * kk) >> 4;
      wgmma_ss<64>(ye, cd + off, hd + off, 1);
      wgmma_ss<64>(ye, cd + off, ld + off, 1);
    }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(ye);

  // y in column pairs (8-byte stores) where P and y's strides are even
  float* yb = p.y + b * p.ys.b + h * p.ys.h;
  const bool pairs = p.P % 2 == 0 && p.ys.b % 2 == 0 && p.ys.h % 2 == 0 &&
                     p.ys.s % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(p.y) % 8 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= q) continue;
    const float ec = expf(ci[r]);
    float* yrow = yb + (s0 + rows[r]) * p.ys.s;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = p0 + 8 * j + col0, k = 4 * j + 2 * r;
      const float v0 = yi[k] + ec * ye[k], v1 = yi[k + 1] + ec * ye[k + 1];
      if (pairs) {
        if (col < p.P)
          *reinterpret_cast<float2*>(yrow + col) = make_float2(v0, v1);
      } else {
        if (col < p.P) yrow[col] = v0;
        if (col + 1 < p.P) yrow[col + 1] = v1;
      }
    }
  }
}

constexpr size_t kStateSmem = 1024 + 4 * kTile + sizeof(float) * kMaxQ + 8;
template <int NB>
constexpr size_t out_smem() {
  return 1024 + NB * kBlock64 + NB * kTile + kTile + 2 * NB * kBlock64 +
         2 * sizeof(float) * kMaxQ + 8;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t launch_tc(ScanArgs p, int B, cudaStream_t stream) {
  static bool configured = false;   // one attribute call per kernel
  if (!configured) {
    cudaError_t e = set_smem(reinterpret_cast<const void*>(ssd_state_kernel),
                             kStateSmem);
    if (e == cudaSuccess)
      e = set_smem(reinterpret_cast<const void*>(ssd_out_kernel<1>),
                   out_smem<1>());
    if (e == cudaSuccess)
      e = set_smem(reinterpret_cast<const void*>(ssd_out_kernel<2>),
                   out_smem<2>());
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap x_map{}, b_map{}, c_map{};
  if (p.tma) {
    cudaError_t e =
        make_map(&x_map, p.x, B, p.H, p.S, p.P, p.xs, kBox, kCols);
    if (e == cudaSuccess)
      e = make_map(&b_map, p.bm, B, p.G, p.S, p.N, p.bs, kBox, kCols);
    if (e == cudaSuccess)
      e = make_map(&c_map, p.cm, B, p.G, p.S, p.N, p.cs, kBox, kCols);
    if (e != cudaSuccess) return e;
  }
  const int nb = (p.N + kCols - 1) / kCols, np = (p.P + kCols - 1) / kCols;
  const int nh = (p.Q + 63) / 64;
  const int chunks = B * p.H * p.nc;
  ssd_state_kernel<<<dim3(chunks, nb, np), kWG, kStateSmem, stream>>>(
      x_map, b_map, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_pass_kernel<<<dim3(B * p.H, (p.P * p.N + 255) / 256), 256, 0,
                    stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (nb == 1)
    ssd_out_kernel<1><<<dim3(chunks, nh, np), kWG, out_smem<1>(), stream>>>(
        x_map, b_map, c_map, p);
  else
    ssd_out_kernel<2><<<dim3(chunks, nh, np), kWG, out_smem<2>(), stream>>>(
        x_map, b_map, c_map, p);
  return cudaGetLastError();
}

}  // namespace

// x: (B, S, H, P) and y: (B, S, H, P) fp32, each given by element strides
// over (b, h, s) with p contiguous; bm, cm: (B, S, G, N) by strides over
// (b, g, s) with n contiguous; dt, a: fp32 by strides over (b, h, s); h0
// (may be null: zeros) and hout: contiguous (B, H, P, N) fp32.  x, bm, cm
// share one dtype.  scratch: for bf16, B * H * nc * (P * N + 1) fp32 with
// nc = ceil(S / Q) (unused for fp32, may be null).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_ssd_scan(
    const void* x, const void* bm, const void* cm, const void* dt,
    const void* a, const void* h0, void* y, void* hout, void* scratch, int B,
    int H, int G, int S, int P, int N, int Q, long long x_sb, long long x_sh,
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
  if (dtype != repro::kBFloat16 || scratch == nullptr)
    return cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  if (static_cast<long long>(B) * H * nc > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  ScanArgs p;
  p.x = static_cast<const bf16*>(x);
  p.bm = static_cast<const bf16*>(bm);
  p.cm = static_cast<const bf16*>(cm);
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.h0 = static_cast<const float*>(h0);
  p.y = static_cast<float*>(y);
  p.hout = static_cast<float*>(hout);
  p.st = static_cast<float*>(scratch);
  p.cl = p.st + static_cast<size_t>(B) * H * nc * P * N;
  p.H = H; p.G = G; p.S = S; p.P = P; p.N = N; p.Q = Q; p.nc = nc;
  p.tma = aligned16(x, xs, 2) && aligned16(bm, bs, 2) &&
          aligned16(cm, cs, 2);
  p.xs = xs; p.bs = bs; p.cs = cs; p.dts = dts; p.as = as; p.ys = ys;
  return launch_tc(p, B, s);
}
