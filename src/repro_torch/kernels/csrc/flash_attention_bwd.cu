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
//     sum over its group of q heads, taken in a fixed order, so the result
//     is the same on every run (no atomics).
// P is recomputed from the forward's logsumexp, P = exp(scale * q.k - lse),
// so nothing of size S x T is stored between the passes.  dQ has a kernel
// of its own that recomputes S and dP (five products where four would do):
// the price of summing dQ without atomics.
// Bound on an H100: operations, 10 * B * H * D * (unmasked pairs) flops
// (S and dP recomputed, dV, dK, dQ) at 989 TFLOP/s bf16, three times
// that at 495 TFLOP/s TF32 for the split-TF32 body, 67 fp32 for the FMA
// body; at short sequences (ViT-B's 65) the bytes.
//
// bf16 at D <= 160: the tensor-core body, three kernels a call.
//   1. flash_bwd_prep_kernel: Di = rowsum(dO * O) and lse2 = log2(e) * lse
//      into (B, H, Sp) arrays of the scratch (Sp = S rounded up to 128;
//      the padding rows get Di = 0 and lse2 = 1e30, so P = 0 there), D / 8
//      lanes a row (16 at D = 160), 16-byte loads.  A pre-pass, not folded
//      into a prologue, because both later kernels read it.
//   2. flash_bwd_dkdv_wgmma_kernel: a cluster of two blocks owns 64 keys
//      of one (b, kv head); K and V stay resident in swizzled shared
//      memory.  The work is the group's (q head, q tile) items that see
//      those keys; block rank r takes items r, r + 2, ... and each of its
//      two consumer warpgroups every other one of those, so four
//      warpgroups split the items round robin.  A producer thread streams
//      each item's Q and dO tiles (TMA, 4-D tensor maps) and its rows'
//      lse2 and Di (bulk copies) through a four-stage mbarrier ring.  Per
//      item: S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 from shared
//      memory (both K-major); P^T = exp2(scale log2(e) S^T - lse2), zeroed
//      above the diagonal only on the tile that crosses it; dS^T = P^T
//      (dP^T - Di); then dV += P^T dO and dK += dS^T Q as wgmma with P^T
//      and dS^T from registers (the m64n64 accumulator layout is the
//      register-A layout of its k16 slices, as in the forward's PV) and dO
//      and Q read MN-major from the same tiles, as the forward reads V.
//      The four warpgroups' sums meet in a fixed order, (rank 0 wg 0 +
//      rank 0 wg 1) + (rank 1 wg 0 + rank 1 wg 1): warpgroup 1 hands its
//      sums to warpgroup 0 through the (then idle) ring, and rank 0 reads
//      rank 1's through distributed shared memory.
//      At D = 160 dK and dV as m64n160 would take 80 + 80 fp32 registers a
//      thread, with S^T, dP^T and the fragments over the 240 a consumer
//      has.  So the two warpgroups of a block take every item of the block
//      together, split by product: warpgroup 0 forms S^T and P^T, writes
//      P^T (fp32, 16 KB) into shared memory and sums dV += P^T dO;
//      warpgroup 1 forms dP^T, waits for P^T (named barrier 2; it frees
//      the buffer on barrier 3), forms dS^T and sums dK += dS^T Q.  Each
//      does two of the item's four products, none twice (the other split
//      the design weighed, dV and dK in separate warpgroups that each form
//      S^T, does five); each holds 80 accumulators.  The wgmma calls stay
//      on straight-line code: which operands a warpgroup reads is a select
//      on its index, not a branch.  The blocks' sums meet as rank 0 + rank
//      1.  Shared memory: K, V and four (Q, dO) stages of 40 KB, the lse2
//      and Di rows, the P^T buffer: 219 KB of 227.
//   3. flash_bwd_dq_wgmma_kernel: mirrors the forward: 128 q rows of one
//      (b, q head) as two consumer warpgroups of 64 rows, Q and dO
//      resident, a four-stage TMA ring of (K, V) tiles (three at D = 160:
//      80 KB of Q and dO, 120 KB of ring); S = Q K^T and dP = dO V^T as
//      wgmma from shared memory, dS in registers, dQ += dS K with K read
//      MN-major (n128 + n32 at D = 160).  Q tiles launch last first
//      (heaviest first).
//   Tiles at D = 160 are cut in 64-byte swizzle blocks of 32 columns, as
//   the forward's (flash_attention.cu).
//   Grid balance: the causal work of a key tile falls with its index (at
//   B=2 S=T=512 Hkv=8, key tile t has 4 (8 - t) items), so the dK/dV grid
//   splits each key tile over four warpgroups and launches key tile 0
//   first: 256 blocks whose longest warpgroup walks 8 items against a mean
//   of 4.5 (1.78), which heaviest-first scheduling on 132 SMs turns into
//   a makespan of 9 item steps against the ideal 8.73 (1.03).  A block
//   that owned a whole key tile for all four heads would walk 16 (the
//   previous design's grid: 32 q tiles for the first block, 4 for the
//   last).  zamba2-2.7b's shared block (D = 160, MHA: H = Hkv = 32, B=2
//   S=T=1024) gives key tile t 16 - t items, one head; its 2,048 blocks
//   walk at most 8 items against a mean of 4.25 (1.88), and heaviest-first
//   scheduling on 132 SMs gives a makespan of 66 item steps against the
//   ideal 65.94 (1.00).
//   Precision: P^T and dS^T enter the tensor cores rounded once to bf16,
//   as FlashAttention does, with fp32 sums; S, dP, dK, dV and dQ are fp32
//   until the final store (P^T crosses between warpgroups in fp32).  The
//   CPU emulation (tests/test_torch_kernels.py) shows one rounding stays
//   inside the bf16 backward tolerance at qwen3-8b's and zamba2-2.7b's
//   head layouts, so no hi + lo split.
//   Registers: the consumers take 240 (setmaxnreg; the producer keeps 24):
//   dK and dV take 128 fp32 a thread at D = 128, S^T and dP^T 64 more; at
//   D = 160 a warpgroup holds 80 accumulators, one 32-register score tile
//   and its fragments; the dQ kernel 80, S and dP.
//   ptxas reports 168 for both kernels (a 384-thread block's launch
//   share), no spills, and no warning that it serialised a wgmma: the
//   wgmma calls sit on straight-line code, never under a branch.
// fp32 at D <= 128: the split-TF32 tensor-core body.  Every product is
// mma.sync m16n8k8 with TF32 operands and fp32 accumulators, each fp32
// operand x split into big = x with its low 13 mantissa bits cleared and
// small = x - big (split_tf32, hopper.cuh; the tensor cores read small's
// top 19 bits), the product taken as small.big + big.small + big.big,
// term by term over a group of accumulators (mma3_n) so that no product
// waits on the one before it: about 20 significant bits, within the fp32
// check where one TF32 pass misses it (tests/test_torch_kernels.py
// emulates both).  Tiles follow the sequence: 16 keys a warp, q rows in
// steps of 72 (32 at D = 128) taken in passes of three (two) 8-row
// slices, a pass past S or wholly above the warp's keys skipped (ViT-B's
// S = T = 65 computes 80 keys x 72 rows a head, not 128 x 128).  Inside a
// pass the loops have no branch (rows past S are zero and masked).  Loads
// are 16-byte cp.async into rows padded to D + 4 floats (no bank
// conflicts in the fragment reads).  P^T and dS^T stay in the
// accumulators of S^T and dP^T and enter dV and dK as A operands with the
// k order of each 8-row slice permuted (k = t <-> row 2t, k = t + 4 <->
// row 2t + 1), dO and Q read in the same order.
//   1. T <= kWholeKeys (208 at D <= 64, 64 at D = 128): one launch,
//      flash_bwd_kv_tf32_kernel<D, true, W>.  One block owns a (b, kv
//      head): K and V of all its keys resident, one warp each 16 keys, dK
//      and dV in registers.  It walks the q steps of each q head of the
//      group in order; a step brings Q, dO and O by cp.async, forms Di =
//      rowsum(dO * O) and lse2 (rows_lse_di), S^T, dP^T, P^T, dS^T once,
//      sums dV += P^T dO and dK += dS^T Q, writes dS into shared memory
//      over O and finishes the step's dQ = dS K in place (each 16-row x
//      32-column item summed by one warp over the keys in order): five
//      products.  Up to six warps (96 keys; ViT-B's 65: five warps, 109
//      KB) two blocks an SM; past that one block of up to 13 warps
//      (ViT-B/16's 197 keys: K and V 113 KB, 215 KB in all), registers
//      held to 152 a thread (launch bounds) so that 13 warps fit an SM.
//   2. Past that (qwen3-8b's 512 keys): the same kernel with kWhole =
//      false over key tiles of up to 96 keys (64 at D = 128; sized evenly),
//      then flash_bwd_dq_tf32_kernel: 16 q rows a warp, four warps a
//      block, Q and dO resident, K and V tiles of 32 keys
//      double-buffered, S and dP formed again, dQ += dS K: seven products.
//      Each kernel forms the Di and lse2 of its rows itself, so no
//      pre-pass runs (O is read once more a key tile, mostly from L2).
//   Bound at ViT-B's shape (B=256 S=T=65 H=12 D=64): the bytes, q, k, v,
//   o, dO in and dq, dk, dv out once each (409 MB, 0.122 ms); the five
//   products as three TF32 products each at 495 TFLOP/s take 0.050 ms.
// fp32 at D = 160 and 256, and bf16 at D = 256, keep the FMA body (no
// path runs them; bf16 D = 256's dK and dV, 128 + 128 accumulators a
// thread, fit neither tensor-core split):
//   1. flash_bwd_dot_kernel: Di for every (b, h, row), one warp a row;
//   2. flash_bwd_dkdv_kernel: a block owns BK keys of one (b, kv head) and
//      walks the q tiles of each q head of its group: S^T = K Q^T and
//      dP^T = V dO^T, P and dS = P * (dP - Di) into shared memory, then
//      dV += P^T dO and dK += dS^T Q in registers;
//   3. flash_bwd_dq_kernel: a block owns BQ rows of one (b, q head) and
//      walks the kv tiles: S, dP and dS as above, dQ += dS K in registers.
//   Tiles: BQ = BK = 64 at D <= 160, 32 at D = 256 (shared memory: four
//   tiles of rows x (D + 1) fp32 plus P and dS, 198 KB at D = 160, 140 KB
//   at D = 256).  256 threads as 16 x 16: a thread owns a (rows/16) x
//   (cols/16) block of each score tile and (rows/16) rows x D/16 columns
//   of each output tile; rows padded to D + 1 floats keep column reads
//   free of bank conflicts.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;             // FMA body

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


// ---------------------------------------------------------------------------
// fp32 split-TF32 tensor-core body (D <= 128)
// ---------------------------------------------------------------------------

template <int D>
struct Tf32Bwd {
  // q rows a dK/dV step (ViT-B's 65 rows are one step at D <= 64), taken
  // in passes of kNP 8-row slices
  static constexpr int kBQ = D <= 64 ? 72 : 32;
  static constexpr int kNP = D <= 64 ? 3 : 2;
  static constexpr int kBK = 32;                   // keys a dQ-kernel tile
  static constexpr int kLD = D + 4;                // padded row, floats
  // a (b, kv head)'s keys up to this many stay in one block, which then
  // finishes dQ in place: ViT-B/16's 197 keys are one block of 13 warps
  // (K and V 113 KB, 215 KB in all, at most 152 registers a thread), up
  // to 96 keys (ViT-B's 65: five warps, 109 KB) two blocks an SM
  static constexpr int kWholeKeys = D <= 64 ? 208 : 64;
  static constexpr int kNarrowWarps = 6;
  // warps (16 keys each) of a key tile past that: two blocks an SM
  static constexpr int kSplitWarps = D <= 64 ? 6 : 4;
  // the dQ kernel's warps, 16 q rows each: three blocks an SM
  static constexpr int kDqWarps = 4;
  // the dK/dV kernel's shared memory for W warps: K and V of its 16 W keys,
  // Q and dO of a q step, O of the step (for Di), then, with dQ in place,
  // its dS (kBQ rows of 16 W + 8) over the same floats, lse2 and Di
  static constexpr size_t kv_smem(int W, bool whole) {
    return sizeof(float) *
           (2 * 16 * W * kLD + 2 * kBQ * kLD +
            (whole && 16 * W + 8 > kLD ? kBQ * (16 * W + 8) : kBQ * kLD) +
            2 * kBQ);
  }
  // the dQ kernel's: two (K, V) stages, Q and dO of 16 W rows, lse2, Di
  static constexpr size_t dq_smem(int W) {
    return sizeof(float) * (2 * 2 * kBK * kLD + 2 * 16 * W * kLD + 2 * 16 * W);
  }
};
constexpr float kLog2eF = 1.4426950408889634f;

// A split product is three TF32 products, smallest first: term 0 is
// small.big, term 1 big.small, term 2 big.big (mma_term); one TF32 pass
// would be term 2 alone
constexpr int kFirstTerm = 0;

// lse2 = log2(e) lse and Di = rowsum(dO * O) of R rows (n of them live,
// zeros past), from O and dO tiles in shared or device memory (rows ld
// floats apart, 16-byte aligned): D / 4 lanes a row, a float4 each
template <int D>
__device__ __forceinline__ void rows_lse_di(float* lse_s, float* di_s,
                                            const float* ot, long long o_ld,
                                            const float* dt, long long d_ld,
                                            const float* lt, int R, int n) {
  constexpr int L = D / 4;                  // lanes a row
  constexpr int RPW = 32 / L;               // rows a warp at once
  const int lane = threadIdx.x % 32, sub = lane / L, c = lane % L * 4;
  const int step = blockDim.x / 32 * RPW;
  for (int rw = threadIdx.x / 32 * RPW; rw < R; rw += step) {
    const int r = rw + sub;
    const bool in = r < n;
    float acc = 0.f;
    if (in) {
      const float4 x = *reinterpret_cast<const float4*>(ot + r * o_ld + c);
      const float4 y = *reinterpret_cast<const float4*>(dt + r * d_ld + c);
      acc = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane % L == 0 && r < R) {
      lse_s[r] = in ? lt[r] * kLog2eF : 0.f;
      di_s[r] = in ? acc : 0.f;
    }
  }
}

// dK and dV of one (b, kv head)'s keys k0 .. k0 + 16 W - 1: warp w owns 16
// of them and holds their dK and dV in registers while the block walks the
// q steps (kBQ rows) of each q head of the group, in order.  A step: Q, dO
// and O by cp.async, lse2 and Di (rows_lse_di); then each warp, in passes
// of kNP 8-row slices, forms S^T = K_w Q^T and dP^T = V_w dO^T, P^T =
// exp2(scale log2(e) S^T - lse2) and dS^T = P^T (dP^T - Di) in its
// accumulators, and sums dV += P^T dO and dK += dS^T Q from them.  kWhole
// (the block holds every key): the warps also write dS into shared memory
// (over O) and the block finishes the step's dQ = dS K in place; five
// products, one launch.
template <int D, bool kWhole, int kMaxW>
__global__ void __launch_bounds__(32 * kMaxW)
flash_bwd_kv_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ dq,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Hkv, int S, int Tk, Strides qs, Strides ks,
                         Strides vs, Strides os, Strides dos, Strides dqs,
                         Strides dks, Strides dvs, float scale, int causal) {
  using C = Tf32Bwd<D>;
  constexpr int BQ = C::kBQ, NP = C::kNP, LD = C::kLD, DK = D / 8;
  constexpr int NJ = BQ / 8;
  constexpr int NC = DK < 4 ? DK : 4;       // output slices a product group
  extern __shared__ __align__(16) float smem_f[];
  const int W = blockDim.x / 32, KT = 16 * W, LDS = KT + 8;
  float* Ks = smem_f;                       // KT x LD
  float* Vs = Ks + KT * LD;
  float* Qs = Vs + KT * LD;                 // BQ x LD
  float* dOs = Qs + BQ * LD;
  float* Xs = dOs + BQ * LD;                // O (BQ x LD), then dS (BQ x LDS)
  float* lse_s = Xs + (kWhole && LDS > LD ? BQ * LDS : BQ * LD);
  float* di_s = lse_s + BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * KT, hk = blockIdx.y, b = blockIdx.z;
  const int kw = k0 + 16 * warp;            // this warp's keys kw .. kw + 15
  const bool live = kw < Tk;
  const int group = H / Hkv;
  const float scale2 = scale * kLog2eF;
  cp_rows<D>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, Tk, KT);
  cp_rows<D>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, Tk, KT);
  cp_async_commit();

  float dka[DK][4], dva[DK][4];
#pragma unroll
  for (int i = 0; i < DK; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  // the first q step with a row at or below the block's first key
  const int qt0 = causal ? k0 / BQ * BQ : 0;
  for (int j = 0; j < group; ++j) {
    const int h = hk * group + j;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* db = dout + b * dos.b + h * dos.h;
    for (int q0 = qt0; q0 < S; q0 += BQ) {
      const int n = min(BQ, S - q0);        // live rows of the step
      __syncthreads();                      // the last step's readers done
      cp_rows<D>(Qs, qb, qs.s, q0, S, BQ);
      cp_rows<D>(dOs, db, dos.s, q0, S, BQ);
      cp_rows<D>(Xs, o + b * os.b + h * os.h, os.s, q0, S, BQ);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      rows_lse_di<D>(lse_s, di_s, Xs, LD, dOs, LD,
                     lse + (static_cast<long long>(b) * H + h) * S + q0, BQ,
                     n);
      __syncthreads();                      // Di in; O no longer read
      for (int p0 = 0; live && p0 < NJ && 8 * p0 < n; p0 += NP) {
        // a pass wholly above this warp's keys adds nothing (dS = 0)
        const bool run = !(causal && q0 + 8 * (p0 + NP) - 1 < kw);
        float st[NP][4], dpt[NP][4];
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
        if (run) {
          // S^T = K_w Q^T, dP^T = V_w dO^T over this pass's rows
#pragma unroll
          for (int kk = 0; kk < DK; ++kk) {
            uint32_t kb_[4], ks_[4], vb_[4], vs_[4];
            a_frag(Ks, LD, 16 * warp, 8 * kk, kb_, ks_);
            a_frag(Vs, LD, 16 * warp, 8 * kk, vb_, vs_);
            uint32_t qb2[NP][2], qs2[NP][2], db2[NP][2], ds2[NP][2];
#pragma unroll
            for (int i = 0; i < NP; ++i) {
              bt_frag(Qs, LD, 8 * (p0 + i), 8 * kk, qb2[i], qs2[i]);
              bt_frag(dOs, LD, 8 * (p0 + i), 8 * kk, db2[i], ds2[i]);
            }
#pragma unroll
            for (int term = kFirstTerm; term < 3; ++term)
#pragma unroll
              for (int i = 0; i < NP; ++i) {
                mma_term(term, st[i], kb_, ks_, qb2[i], qs2[i]);
                mma_term(term, dpt[i], vb_, vs_, db2[i], ds2[i]);
              }
          }
          // P^T and dS^T in place: st[i][e] is key kw + g + 8 (e / 2),
          // row q0 + 8 (p0 + i) + 2t + e % 2
#pragma unroll
          for (int i = 0; i < NP; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kw + g + 8 * (e >> 1);
              const int r = 8 * (p0 + i) + 2 * t + (e & 1), row = q0 + r;
              const bool keep = row < S && key < Tk && (!causal || key <= row);
              const float p =
                  keep ? exp2f(st[i][e] * scale2 - lse_s[r]) : 0.f;
              st[i][e] = p;
              dpt[i][e] = p * (dpt[i][e] - di_s[r]);
            }
          // dV += P^T dO, dK += dS^T Q: the pass's rows, permuted order
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            uint32_t pb[4], ps[4], sb[4], ss[4];
            acc_as_a(st[i], pb, ps);
            acc_as_a(dpt[i], sb, ss);
#pragma unroll
            for (int c0 = 0; c0 < DK; c0 += NC) {
              uint32_t ob2[NC][2], os2[NC][2], qb2[NC][2], qs2[NC][2];
#pragma unroll
              for (int c = 0; c < NC; ++c) {
                bp_frag(dOs, LD, 8 * (p0 + i), 8 * (c0 + c), ob2[c], os2[c]);
                bp_frag(Qs, LD, 8 * (p0 + i), 8 * (c0 + c), qb2[c], qs2[c]);
              }
#pragma unroll
              for (int term = kFirstTerm; term < 3; ++term)
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                  mma_term(term, dva[c0 + c], pb, ps, ob2[c], os2[c]);
                  mma_term(term, dka[c0 + c], sb, ss, qb2[c], qs2[c]);
                }
            }
          }
        }
        if constexpr (kWhole) {
          // dS[row][key] for dQ (zeros where P is masked or the pass idle)
#pragma unroll
          for (int i = 0; i < NP; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              Xs[(8 * (p0 + i) + 2 * t + (e & 1)) * LDS + 16 * warp + g +
                 8 * (e >> 1)] = dpt[i][e];
        }
      }
      if constexpr (kWhole) {
        __syncthreads();
        // dQ = dS K over the block's keys: items of 16 rows x NC 8-column
        // slices, dealt to the warps; one warp sums each item's keys in
        // order, so every call gives the same bits
        constexpr int NCH = DK / NC;
        const int nk8 = (min(KT, Tk - k0) + 7) / 8;
        const int items = (n + 15) / 16 * NCH;
        for (int it = warp; it < items; it += W) {
          const int m0 = it / NCH * 16, n0 = it % NCH * NC * 8;
          const bool hi = m0 + 8 < BQ;      // rows m0 + 8 .. inside the step
          float c[NC][4];
#pragma unroll
          for (int x = 0; x < NC; ++x)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[x][e] = 0.f;
          for (int k8 = 0; k8 < nk8; ++k8) {
            const float2 x0 = *reinterpret_cast<const float2*>(
                Xs + (m0 + g) * LDS + 8 * k8 + 2 * t);
            const float2 x1 = hi ? *reinterpret_cast<const float2*>(
                                       Xs + (m0 + g + 8) * LDS + 8 * k8 +
                                       2 * t)
                                 : make_float2(0.f, 0.f);
            const float f[4] = {x0.x, x1.x, x0.y, x1.y};
            uint32_t ab[4], as[4];
            split_n(f, ab, as);
            uint32_t bb[NC][2], bs[NC][2];
#pragma unroll
            for (int x = 0; x < NC; ++x)
              bp_frag(Ks, LD, 8 * k8, n0 + 8 * x, bb[x], bs[x]);
            mma3_n<NC, kFirstTerm>(c, ab, as, bb, bs);
          }
          float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rr = m0 + g + 8 * r;
            if (rr >= n) continue;
            const int row = q0 + rr;
#pragma unroll
            for (int x = 0; x < NC; ++x)
              *reinterpret_cast<float2*>(dqb + row * dqs.s + n0 + 8 * x +
                                         2 * t) =
                  make_float2(c[x][2 * r] * scale, c[x][2 * r + 1] * scale);
          }
        }
      }
    }
  }

  // keys no query sees (past S when causal) get zeros, never garbage
  if (!live) return;
  float* dkb = dk + b * dks.b + hk * dks.h;
  float* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < DK; ++c) {
      *reinterpret_cast<float2*>(dkb + key * dks.s + 8 * c + 2 * t) =
          make_float2(dka[c][2 * r] * scale, dka[c][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dvb + key * dvs.s + 8 * c + 2 * t) =
          make_float2(dva[c][2 * r], dva[c][2 * r + 1]);
    }
  }
}

// dQ where the keys span more than one dK/dV block: a block owns 16 W q
// rows of one (b, q head), warp w 16 of them, Q and dO resident; K and V
// tiles of kBK keys come by cp.async, double-buffered.  Per tile: S = Q
// K^T and dP = dO V^T, P and dS = P (dP - Di) in the accumulators, dQ +=
// dS K with dS as the A operand in the permuted k order.  Keys past T are
// zero rows and masked, so the loops run over every slice of a tile.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ dq,
                         int group, int S, int Tk, Strides qs, Strides ks,
                         Strides vs, Strides os, Strides dos, Strides dqs,
                         float scale, int causal) {
  using C = Tf32Bwd<D>;
  constexpr int BK = C::kBK, LD = C::kLD, DK = D / 8, NJ = BK / 8;
  constexpr int NC = DK < 4 ? DK : 4;       // output slices a product group
  extern __shared__ __align__(16) float smem_f[];
  const int W = blockDim.x / 32, R = 16 * W;
  float* Qs = smem_f + 2 * 2 * BK * LD;     // after the two (K, V) stages
  float* dOs = Qs + R * LD;
  float* lse_s = dOs + R * LD;
  float* di_s = lse_s + R;
  auto stage = [&](int i) { return smem_f + (i & 1) * 2 * BK * LD; };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int kvh_ = h / group;
  const int blk0 = (gridDim.x - 1 - blockIdx.x) * R;   // last rows first
  const int r0 = blk0 + 16 * warp;
  const bool live = r0 < S;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* db = dout + b * dos.b + h * dos.h;
  const float* kb = k + b * ks.b + kvh_ * ks.h;
  const float* vb = v + b * vs.b + kvh_ * vs.h;
  const float scale2 = scale * kLog2eF;

  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (min(S, blk0 + R) - 1) / BK + 1);
  cp_rows<D>(Qs, qb, qs.s, blk0, S, R);
  cp_rows<D>(dOs, db, dos.s, blk0, S, R);
  cp_rows<D>(stage(0), kb, ks.s, 0, Tk, BK);
  cp_rows<D>(stage(0) + BK * LD, vb, vs.s, 0, Tk, BK);
  cp_async_commit();
  rows_lse_di<D>(lse_s, di_s, o + b * os.b + h * os.h + blk0 * os.s, os.s,
                 db + blk0 * dos.s, dos.s,
                 lse + (static_cast<long long>(b) * H + h) * S + blk0, R,
                 min(R, S - blk0));
  // this thread's rows r0 + g and r0 + g + 8 (read after the first sync)
  float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};

  float acc[DK][4];
#pragma unroll
  for (int i = 0; i < DK; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {
      cp_rows<D>(stage(it + 1), kb, ks.s, (it + 1) * BK, Tk, BK);
      cp_rows<D>(stage(it + 1) + BK * LD, vb, vs.s, (it + 1) * BK, Tk, BK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lr[r] = lse_s[16 * warp + g + 8 * r];
        dr[r] = di_s[16 * warp + g + 8 * r];
      }
    }
    const float* Ks = stage(it);
    const float* Vs = Ks + BK * LD;
    const int k0 = it * BK;
    if (live && !(causal && k0 > r0 + 15)) {
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t qb_[4], qs_[4], db_[4], ds_[4];
        a_frag(Qs, LD, 16 * warp, 8 * kk, qb_, qs_);
        a_frag(dOs, LD, 16 * warp, 8 * kk, db_, ds_);
        uint32_t kb2[NJ][2], ks2[NJ][2], vb2[NJ][2], vs2[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          bt_frag(Ks, LD, 8 * j, 8 * kk, kb2[j], ks2[j]);
          bt_frag(Vs, LD, 8 * j, 8 * kk, vb2[j], vs2[j]);
        }
#pragma unroll
        for (int term = kFirstTerm; term < 3; ++term)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            mma_term(term, s[j], qb_, qs_, kb2[j], ks2[j]);
            mma_term(term, dp[j], db_, ds_, vb2[j], vs2[j]);
          }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          const bool in = row < S && key < Tk && (!causal || key <= row);
          const float p = in ? exp2f(s[j][e] * scale2 - lr[e >> 1]) : 0.f;
          s[j][e] = p * (dp[j][e] - dr[e >> 1]);
        }
        uint32_t ab[4], as[4];
        acc_as_a(s[j], ab, as);
#pragma unroll
        for (int c0 = 0; c0 < DK; c0 += NC) {
          uint32_t bb[NC][2], bs[NC][2];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            bp_frag(Ks, LD, 8 * j, 8 * (c0 + c), bb[c], bs[c]);
          mma3_n<NC, kFirstTerm>(acc + c0, ab, as, bb, bs);
        }
      }
    }
    __syncthreads();                        // this stage is free again
  }

  if (!live) return;
  float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DK; ++c)
      *reinterpret_cast<float2*>(dqb + row * dqs.s + 8 * c + 2 * t) =
          make_float2(acc[c][2 * r] * scale, acc[c][2 * r + 1] * scale);
  }
}

// one launch of flash_bwd_kv_tf32_kernel<D, kWhole, kMaxW> with W <=
// kMaxW warps over `blocks` key tiles
template <int D, bool kWhole, int kMaxW>
cudaError_t launch_kv(int W, int blocks, const float* q, const float* k,
                      const float* v, const float* o, const float* dout,
                      const float* lse, float* dq, float* dk, float* dv,
                      int B, int H, int Hkv, int S, int Tk, Strides qs,
                      Strides ks, Strides vs, Strides os, Strides dos,
                      Strides dqs, Strides dks, Strides dvs, float scale,
                      int causal, cudaStream_t stream) {
  static bool configured = false;   // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_kv_tf32_kernel<D, kWhole, kMaxW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tf32Bwd<D>::kv_smem(kMaxW, kWhole)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  flash_bwd_kv_tf32_kernel<D, kWhole, kMaxW>
      <<<dim3(blocks, Hkv, B), 32 * W, Tf32Bwd<D>::kv_smem(W, kWhole),
         stream>>>(q, k, v, o, dout, lse, dq, dk, dv, H, Hkv, S, Tk, qs, ks,
                   vs, os, dos, dqs, dks, dvs, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, int B, int H, int Hkv,
                        int S, int Tk, Strides qs, Strides ks, Strides vs,
                        Strides os, Strides dos, Strides dqs, Strides dks,
                        Strides dvs, float scale, int causal,
                        cudaStream_t stream) {
  using C = Tf32Bwd<D>;
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k);
  const auto* vt = static_cast<const float*>(v);
  const auto* ot = static_cast<const float*>(o);
  const auto* dot = static_cast<const float*>(dout);
  auto* dqt = static_cast<float*>(dq);
  auto* dkt = static_cast<float*>(dk);
  auto* dvt = static_cast<float*>(dv);
  const int kslices = (Tk + 15) / 16;
  // one block a (b, kv head): dK, dV and dQ in one launch
  if (kslices <= C::kNarrowWarps && Tk <= C::kWholeKeys)
    return launch_kv<D, true, C::kNarrowWarps>(
        kslices, 1, qt, kt, vt, ot, dot, lse, dqt, dkt, dvt, B, H, Hkv, S,
        Tk, qs, ks, vs, os, dos, dqs, dks, dvs, scale, causal, stream);
  if constexpr (C::kWholeKeys > 16 * C::kNarrowWarps) {
    if (Tk <= C::kWholeKeys)
      return launch_kv<D, true, C::kWholeKeys / 16>(
          kslices, 1, qt, kt, vt, ot, dot, lse, dqt, dkt, dvt, B, H, Hkv, S,
          Tk, qs, ks, vs, os, dos, dqs, dks, dvs, scale, causal, stream);
  }
  // key tiles of 16 W keys, as few and as even as kSplitWarps warps
  // allow; then dQ by q rows
  const int kblocks = (kslices + C::kSplitWarps - 1) / C::kSplitWarps;
  const int kwarps = (kslices + kblocks - 1) / kblocks;
  cudaError_t e = launch_kv<D, false, C::kSplitWarps>(
      kwarps, kblocks, qt, kt, vt, ot, dot, lse, dqt, dkt, dvt, B, H, Hkv, S,
      Tk, qs, ks, vs, os, dos, dqs, dks, dvs, scale, causal, stream);
  if (e != cudaSuccess) return e;
  static bool configured = false;   // one attribute call per instantiation
  if (!configured) {
    e = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::dq_smem(C::kDqWarps)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int qslices = (S + 15) / 16;
  const int qblocks = (qslices + C::kDqWarps - 1) / C::kDqWarps;
  const int qwarps = (qslices + qblocks - 1) / qblocks;
  flash_bwd_dq_tf32_kernel<D>
      <<<dim3(qblocks, H, B), 32 * qwarps, C::dq_smem(qwarps), stream>>>(
          qt, kt, vt, ot, dot, lse, dqt, H / Hkv, S, Tk, qs, ks, vs, os, dos,
          dqs, scale, causal);
  return cudaGetLastError();
}

// the head dims of the split-TF32 body, kernels/flash_attention.py:
// TF32_DIMS
cudaError_t dispatch_tf32(int D, const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          void* dq, void* dk, void* dv, int B, int H, int Hkv,
                          int S, int Tk, Strides qs, Strides ks, Strides vs,
                          Strides os, Strides dos, Strides dqs, Strides dks,
                          Strides dvs, float scale, int causal,
                          cudaStream_t st) {
#define REPRO_BWD_TF32_CASE(DIM)                                              \
  case DIM:                                                                   \
    return launch_tf32<DIM>(q, k, v, o, dout, lse, dq, dk, dv, B, H, Hkv, S,  \
                            Tk, qs, ks, vs, os, dos, dqs, dks, dvs, scale,    \
                            causal, st);
  switch (D) {
    REPRO_BWD_TF32_CASE(16)
    REPRO_BWD_TF32_CASE(32)
    REPRO_BWD_TF32_CASE(64)
    REPRO_BWD_TF32_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_TF32_CASE
}


// ---------------------------------------------------------------------------
// bf16 tensor-core body (D <= 160)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int TB = 64;                    // rows of every tile (q or kv)
constexpr int kConsumers = 256;           // 2 consumer warpgroups
constexpr int kThreadsTC = kConsumers + 128;  // + 1 producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 4;                // the dK/dV kernel's ring
// the dQ kernel's ring: three stages at D = 160, where Q and dO of 128
// rows take 80 KB and four stages of K and V would take 160 KB more
template <int D>
constexpr int kDqStages = D > 128 ? 3 : 4;
constexpr int kSplit = 2;                 // blocks a cluster (dK/dV kernel)
constexpr int kRowAlign = 128;            // rows of the padded lse2 and Di
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadLse = 1e30f;          // lse2 of a row past S: P = 0
// dO and Q (dK/dV kernel) and K (dQ kernel) are read by the second
// product as MN-major (transposed) B operands, as the forward reads V
constexpr int kTransB = 1;

// A tile of R rows x D bf16 in shared memory, as flash_attention.cu lays
// it out: D*2/kRow column blocks of R rows of kRow bytes (kRow the largest
// of 128, 64 and 32 that divides a row: 64 at D = 160, five blocks),
// swizzled as TMA writes them.
template <int D>
struct Layout {
  static constexpr int kRow = D * 2 % 128 == 0 ? 128
                              : D * 2 % 64 == 0 ? 64 : 32;   // bytes
  static constexpr int kBlocks = D * 2 / kRow;
  static constexpr int kSlices = kRow / 32;     // k16 slices a block row
  static constexpr uint64_t kSwizzle = kRow == 128 ? 1 : kRow == 64 ? 2 : 3;
  static constexpr int kSbo = 8 * kRow;         // bytes between 8-row groups
  static constexpr int kTile = TB * D * 2;      // bytes of a 64-row tile
  static constexpr int kBlockBytes = TB * kRow; // one column block of it
  // column 128 of a tile read MN-major (the second product at D = 160),
  // 16-byte units
  static constexpr uint32_t kRest = (256 / kRow) * kBlockBytes >> 4;
};

// the 64-row tile at row0 of one head's matrix, every column block
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int row0, int h, int b,
                                         uint32_t bar) {
  using L = Layout<D>;
#pragma unroll
  for (int blk = 0; blk < L::kBlocks; ++blk)
    tma_load(dst + blk * L::kBlockBytes, map, blk * L::kRow / 2, row0, h, b,
             bar);
}

// K-major descriptor of a 64-row tile, advanced to k16 slice kk of D
template <int D>
__device__ __forceinline__ uint64_t kslice(uint64_t desc, int kk) {
  using L = Layout<D>;
  const int blk = kk / L::kSlices, off = (kk % L::kSlices) * 32;
  return desc + ((blk * L::kBlockBytes + off) >> 4);
}
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile) {
  return make_desc(tile, 16, Layout<D>::kSbo, Layout<D>::kSwizzle);
}
// MN-major descriptor of a 64-row tile read as a (rows x D) B operand;
// k16 slice kk is rows 16kk .. 16kk + 15
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile) {
  return make_desc(tile, Layout<D>::kBlockBytes, Layout<D>::kSbo,
                   Layout<D>::kSwizzle);
}
template <int D>
__device__ __forceinline__ uint64_t mnslice(uint64_t desc, int kk) {
  return desc + ((2 * Layout<D>::kSbo * kk) >> 4);
}

// 2^x in one MUFU instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a 64 x 64 fp32 accumulator as the four bf16 A fragments of its k16
// slices: register a[kk][r] holds x[8kk + 2r], x[8kk + 2r + 1]
__device__ __forceinline__ void to_a_frags(const float (&x)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// bar.sync on a named barrier of the two consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
// the dK/dV kernel's hand-over of P^T from warpgroup 0 to warpgroup 1 (D =
// 160): named barriers 2 (P^T written) and 3 (P^T read, the buffer free)
constexpr int kXchFull = 2, kXchFree = 3;
template <int kId>
__device__ __forceinline__ void consumers_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(kId), "n"(kConsumers) : "memory");
}
template <int kId>
__device__ __forceinline__ void consumers_wait() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kId), "n"(kConsumers) : "memory");
}

// P^T = exp2(scale log2(e) S^T - lse2) in place, zeroed above the diagonal
// (only the tile that crosses it, diag, has such entries).  st[4jj + 2r +
// e]: key kr[r], q row q0 + 8jj + col0 + e; lrow: the q tile's lse2.
__device__ __forceinline__ void p_transposed(float (&st)[32],
                                             const float* lrow,
                                             const int (&kr)[2], int q0,
                                             int col0, bool diag,
                                             float scale2) {
#pragma unroll
  for (int jj = 0; jj < TB / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * jj + col0 + e;
      const float l2 = lrow[c];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int x = 4 * jj + 2 * r + e;
        float p = fast_exp2(fmaf(st[x], scale2, -l2));
        if (diag && kr[r] > q0 + c) p = 0.f;
        st[x] = p;
      }
    }
}

// lanes a row of the pre-pass, a power of two: D / 8 (one 16-byte load of
// o and of dO each), 16 at D = 160 (lanes 0 - 3 take a second one)
template <int D>
constexpr int kPrepLanes = D > 128 ? 16 : D / 8;

// Pre-pass: Di = rowsum(dO * O) and lse2 = log2(e) * lse for every (b, h,
// row) of a (B, H, Sp) layout whose rows S .. Sp - 1 are padding (Di = 0,
// lse2 = kPadLse, so that P = 0 there).  kPrepLanes lanes a row.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ di, int H, int S, int Sp, Strides os,
                      Strides dos, long long rows) {
  constexpr int G = kPrepLanes<D>;
  const long long row = static_cast<long long>(blockIdx.x) * (256 / G) +
                        threadIdx.x / G;
  const bool live = row < rows;
  const int s = live ? static_cast<int>(row % Sp) : 0;
  const long long bh = live ? row / Sp : 0;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const bool in = live && s < S;
  float acc = 0.f;
  if (in) {
    for (int c = (threadIdx.x % G) * 8; c < D; c += 8 * G) {
      const uint4 ov = *reinterpret_cast<const uint4*>(
          o + b * os.b + h * os.h + s * os.s + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(
          dout + b * dos.b + h * dos.h + s * dos.s + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(o2[i]);
        const float2 g = __bfloat1622float2(d2[i]);
        acc += a.x * g.x + a.y * g.y;
      }
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && threadIdx.x % G == 0) {
    di[row] = in ? acc : 0.f;
    lse2[row] = in ? lse[bh * S + s] * kLog2e : kPadLse;
  }
}

// dK and dV.  A cluster of kSplit blocks owns the 64 keys of kv tile
// blockIdx.z of one (b, kv head); its work is the group's (q head, q tile)
// items that see those keys, item j = head-major.  Block rank r of the
// cluster takes items r, r + kSplit, ...
//   D <= 128: consumer warpgroup w takes every other one of those, so four
//   warpgroups split the items round robin.  Each sums its items in order
//   into fp32 dK and dV in registers; the sums meet in a fixed order: (rank
//   0 wg 0 + rank 0 wg 1) + (rank 1 wg 0 + rank 1 wg 1), the second pair
//   read from the peer block's shared memory.
//   D = 160 (kPair): dK and dV together would take 160 fp32 registers a
//   thread, so the block's two warpgroups take every item of the block
//   together, one product each a step: warpgroup 0 forms S^T = K Q^T and
//   P^T, hands P^T (fp32) to warpgroup 1 through shared memory and sums dV
//   += P^T dO; warpgroup 1 forms dP^T = V dO^T, dS^T = P^T (dP^T - Di) and
//   sums dK += dS^T Q.  The blocks' sums meet as rank 0 + rank 1.
template <int D>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreadsTC, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse2,
                            const float* __restrict__ di,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int H, int Hkv, int S, int Sp, int Tk,
                            Strides dks, Strides dvs, float scale,
                            int causal) {
  using L = Layout<D>;
  constexpr bool kPair = D > 128;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  // K, V; the ring of (Q, dO) stages; each stage's lse2 and Di rows; the
  // P^T buffer (kPair); the barriers.  The ring doubles as the buffer of
  // the final reduction.
  const uint32_t sk = (smem_addr(smem_tc) + 1023) & ~1023u;
  const uint32_t sv = sk + L::kTile;
  const uint32_t ring = sv + L::kTile;
  const uint32_t rows_s = ring + kStages * 2 * L::kTile;
  const uint32_t xch_s = rows_s + kStages * 2 * TB * 4;
  const uint32_t bars = xch_s + (kPair ? TB * TB * 4 : 0);
  auto stage = [&](int s) { return ring + s * 2 * L::kTile; };  // Q, dO
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t kv_full = bars + 16 * kStages;
  unsigned char* base = smem_tc + (sk - smem_addr(smem_tc));
  const float* lse_s = reinterpret_cast<const float*>(base + (rows_s - sk));

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int t = blockIdx.z, k0 = t * TB;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int group = H / Hkv;
  const int nq = (S + TB - 1) / TB;
  // q tiles at or below the diagonal: q tile t is the first with a row at
  // or below this tile's first key
  const int qt0 = causal ? min(t, nq) : 0;
  const int per_head = nq - qt0;
  const int items = group * per_head;
  const int mine = (items - rank + kSplit - 1) / kSplit;   // this block's

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1);
      // the consuming warps: one warpgroup's, both with kPair
      mbar_init(empty(i), kPair ? 8 : 4);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else, never joined again (each side has its own register
  // budget); both sides end in the same two cluster barriers.
  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(kv_full, 2 * L::kTile);
      tma_tile<D>(sk, &k_map, k0, hk, b, kv_full);
      tma_tile<D>(sv, &v_map, k0, hk, b, kv_full);
      for (int i = 0; i < mine; ++i) {
        const int j = rank + kSplit * i;
        const int h = hk * group + j / per_head;
        const int q0 = (qt0 + j % per_head) * TB;
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTile + 2 * TB * 4);
        tma_tile<D>(stage(s), &q_map, q0, h, b, full(s));
        tma_tile<D>(stage(s) + L::kTile, &do_map, q0, h, b, full(s));
        const long long r0 = (static_cast<long long>(b) * H + h) * Sp + q0;
        bulk_load(rows_s + s * 2 * TB * 4, lse2 + r0, TB * 4, full(s));
        bulk_load(rows_s + s * 2 * TB * 4 + TB * 4, di + r0, TB * 4, full(s));
      }
    }
    __syncwarp();                         // the warp meets again first
    cluster.sync();
    cluster.sync();
  } else if constexpr (!kPair) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int wg = tid / 128, wt = tid % 128;
    const int warp = wt / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);
    // this thread's accumulator rows are keys kr[0], kr[1]; its columns
    // 8j + col0 + e
    const int kr[2] = {k0 + 16 * warp + lane / 4, k0 + 16 * warp + lane / 4 + 8};
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float st[32], dpt[32];
    uint32_t pa[4][4], dsa[4][4];
    const uint64_t kd = kmajor<D>(sk), vd = kmajor<D>(sv);

    mbar_wait(kv_full, 0);
    for (int i = wg; i < mine; i += 2) {
      const int s = i % kStages;
      const int j = rank + kSplit * i;
      const int q0 = (qt0 + j % per_head) * TB;
      mbar_wait(full(s), (i / kStages) & 1);
      const uint32_t sq = stage(s), sdo = stage(s) + L::kTile;
      // S^T = K Q^T and dP^T = V dO^T over D
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<TB>(st, kslice<D>(kd, kk), kslice<D>(kmajor<D>(sq), kk),
                     kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<TB>(dpt, kslice<D>(vd, kk), kslice<D>(kmajor<D>(sdo), kk),
                     kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T, then dS^T = P^T (dP^T - Di)
      const float* lrow = lse_s + s * 2 * TB;
      const float* drow = lrow + TB;
      p_transposed(st, lrow, kr, q0, col0, causal && k0 + TB - 1 > q0,
                   scale * kLog2e);
#pragma unroll
      for (int x = 0; x < 32; ++x)
        dpt[x] = st[x] * (dpt[x] - drow[8 * (x / 4) + col0 + x % 2]);
      to_a_frags(st, pa);
      to_a_frags(dpt, dsa);

      // dV += P^T dO and dK += dS^T Q over the tile's 64 q rows
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(dsa);
      wgmma_fence();
      const uint64_t dom = mnmajor<D>(sdo), qm = mnmajor<D>(sq);
#pragma unroll
      for (int kk = 0; kk < TB / 16; ++kk)
        wgmma_rs<kTransB>(dv_acc, pa[kk], mnslice<D>(dom, kk));
#pragma unroll
      for (int kk = 0; kk < TB / 16; ++kk)
        wgmma_rs<kTransB>(dk_acc, dsa[kk], mnslice<D>(qm, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      if (lane == 0) mbar_arrive(empty(s));   // this warp is done with s
    }

    // Every item has landed and been read: the ring is free.  Warpgroup 1
    // hands its sums to warpgroup 0 through it (one float a thread a slot,
    // so consecutive threads touch consecutive words), which adds them;
    // rank 1's warpgroup 0 leaves its block's sums there for rank 0.
    float* red = reinterpret_cast<float*>(base + (ring - sk));
    consumers_sync();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        red[i * 128 + wt] = dv_acc[i];
        red[(D / 2 + i) * 128 + wt] = dk_acc[i];
      }
    }
    consumers_sync();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dv_acc[i] += red[i * 128 + wt];
        dk_acc[i] += red[(D / 2 + i) * 128 + wt];
      }
      if (rank == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          red[i * 128 + wt] = dv_acc[i];
          red[(D / 2 + i) * 128 + wt] = dk_acc[i];
        }
      }
    }
    cluster.sync();
    if (wg == 0 && rank == 0) {
      const float* peer = cluster.map_shared_rank(red, 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dv_acc[i] += peer[i * 128 + wt];
        dk_acc[i] += peer[(D / 2 + i) * 128 + wt];
      }
      // dk_acc[4jj + 2r + e]: key kr[r], column 8jj + col0 + e; keys past
      // T are not stored, keys no query sees get zeros
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (kr[r] >= Tk) continue;
        bf16* dkr = dk + b * dks.b + hk * dks.h + kr[r] * dks.s;
        bf16* dvr = dv + b * dvs.b + hk * dvs.h + kr[r] * dvs.s;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<uint32_t*>(dkr + 8 * jj + col0) =
              pack_bf16(dk_acc[4 * jj + 2 * r] * scale,
                        dk_acc[4 * jj + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvr + 8 * jj + col0) =
              pack_bf16(dv_acc[4 * jj + 2 * r], dv_acc[4 * jj + 2 * r + 1]);
        }
      }
    }
    cluster.sync();                       // rank 1's buffer stays till read
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    // warpgroup 0 sums dV, warpgroup 1 dK, each over every item of the
    // block; acc[4jj + 2r + e]: key kr[r], column 8jj + col0 + e
    const int wg = tid / 128, wt = tid % 128;
    const int warp = wt / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);
    const int kr[2] = {k0 + 16 * warp + lane / 4, k0 + 16 * warp + lane / 4 + 8};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[32];                 // S^T (wg 0) or dP^T (wg 1), then P^T or dS^T
    uint32_t frag[4][4];
    // P^T, one float a thread a slot: thread wt of warpgroup 1 holds the
    // same (key, q row) places in dP^T as thread wt of warpgroup 0 in S^T
    float* xch = reinterpret_cast<float*>(base + (xch_s - sk));
    // the first product's A (K or V, resident) and which tile of a stage
    // is its B (Q or dO) and the second product's (dO or Q)
    const uint64_t ad = kmajor<D>(wg == 0 ? sk : sv);
    const int first = wg, second = 1 - wg;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < mine; ++i) {
      const int s = i % kStages;
      const int j = rank + kSplit * i;
      const int q0 = (qt0 + j % per_head) * TB;
      mbar_wait(full(s), (i / kStages) & 1);
      fence_regs(sc);
      wgmma_fence();
      const uint64_t bd = kmajor<D>(stage(s) + first * L::kTile);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<TB>(sc, kslice<D>(ad, kk), kslice<D>(bd, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const float* lrow = lse_s + s * 2 * TB;
      const float* drow = lrow + TB;
      if (wg == 0) {
        p_transposed(sc, lrow, kr, q0, col0, causal && k0 + TB - 1 > q0,
                     scale * kLog2e);
        if (i > 0) consumers_wait<kXchFree>();   // the last P^T was read
#pragma unroll
        for (int x = 0; x < 32; ++x) xch[x * 128 + wt] = sc[x];
        consumers_arrive<kXchFull>();
      } else {
        consumers_wait<kXchFull>();
#pragma unroll
        for (int x = 0; x < 32; ++x)
          sc[x] = xch[x * 128 + wt] *
                  (sc[x] - drow[8 * (x / 4) + col0 + x % 2]);
        if (i + 1 < mine) consumers_arrive<kXchFree>();
      }
      to_a_frags(sc, frag);

      // dV += P^T dO (wg 0) or dK += dS^T Q (wg 1) over the tile's q rows
      fence_regs(acc);
      fence_regs(frag);
      wgmma_fence();
      const uint64_t bm = mnmajor<D>(stage(s) + second * L::kTile);
#pragma unroll
      for (int kk = 0; kk < TB / 16; ++kk)
        wgmma_rs_wide<kTransB>(acc, frag[kk], mnslice<D>(bm, kk), L::kRest);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty(s));   // this warp is done with s
    }

    // Both warpgroups are done with the ring: rank 1 leaves its sums there
    // (warpgroup w's at [w D / 2, (w + 1) D / 2) slots) for rank 0, which
    // adds them to its own and stores.
    float* red = reinterpret_cast<float*>(base + (ring - sk));
    consumers_sync();
    if (rank == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) red[(wg * D / 2 + i) * 128 + wt] = acc[i];
    }
    cluster.sync();
    if (rank == 0) {
      const float* peer = cluster.map_shared_rank(red, 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += peer[(wg * D / 2 + i) * 128 + wt];
      const float f = wg == 0 ? 1.f : scale;
      bf16* out = wg == 0 ? dv : dk;
      const Strides os = wg == 0 ? dvs : dks;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (kr[r] >= Tk) continue;
        bf16* orow = out + b * os.b + hk * os.h + kr[r] * os.s;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<uint32_t*>(orow + 8 * jj + col0) =
              pack_bf16(acc[4 * jj + 2 * r] * f, acc[4 * jj + 2 * r + 1] * f);
      }
    }
    cluster.sync();                       // rank 1's buffer stays till read
  }
}

// dQ.  A block owns 128 q rows of one (b, q head) as two consumer
// warpgroups of 64 rows, Q and dO resident, and walks the kv tiles at or
// left of its diagonal through a TMA ring of (K, V) stages, as the forward
// does: S = Q K^T, dP = dO V^T, dS = P (dP - Di), dQ += dS K.  Q tiles
// are launched last first, so the causal blocks with the most tiles start
// first.
template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse2,
                          const float* __restrict__ di,
                          bf16* __restrict__ dq, int group, int S, int Sp,
                          int Tk, Strides dqs, float scale, int causal) {
  using L = Layout<D>;
  constexpr int kSt = kDqStages<D>;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  // Q and dO of each warpgroup, the (K, V) ring, the barriers
  const uint32_t sq = (smem_addr(smem_tc) + 1023) & ~1023u;  // Q0 Q1 dO0 dO1
  const uint32_t ring = sq + 4 * L::kTile;
  const uint32_t bars = ring + kSt * 2 * L::kTile;
  auto stage = [&](int s) { return ring + s * 2 * L::kTile; };  // K, V
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kSt + s); };
  const uint32_t q_full = bars + 16 * kSt;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = gridDim.x;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * 2 * TB;  // last first
  const int kvh = h / group;
  int nk = (Tk + TB - 1) / TB;
  if (causal) nk = min(nk, (q_start + 2 * TB - 1) / TB + 1);  // k0 <= q_end

  if (tid == 0) {
    for (int i = 0; i < kSt; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kConsumers / 32);   // one arrival a warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, 4 * L::kTile);
      tma_tile<D>(sq, &q_map, q_start, h, b, q_full);
      tma_tile<D>(sq + L::kTile, &q_map, q_start + TB, h, b, q_full);
      tma_tile<D>(sq + 2 * L::kTile, &do_map, q_start, h, b, q_full);
      tma_tile<D>(sq + 3 * L::kTile, &do_map, q_start + TB, h, b, q_full);
      for (int t = 0; t < nk; ++t) {
        const int s = t % kSt;
        mbar_wait(empty(s), ((t / kSt) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTile);
        tma_tile<D>(stage(s), &k_map, t * TB, kvh, b, full(s));
        tma_tile<D>(stage(s) + L::kTile, &v_map, t * TB, kvh, b, full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int wg_start = q_start + TB * wg;
    const int row0 = wg_start + 16 * warp + lane / 4;
    const int rows[2] = {row0, row0 + 8};
    const int col0 = 2 * (lane % 4);
    const float scale2 = scale * kLog2e;
    // rows < Sp always: Sp is a multiple of the block's 128 rows
    const long long rb = (static_cast<long long>(b) * H + h) * Sp;
    const float l2[2] = {lse2[rb + rows[0]], lse2[rb + rows[1]]};
    const float dd[2] = {di[rb + rows[0]], di[rb + rows[1]]};
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    float sc[32], dp[32];
    uint32_t dsa[4][4];
    const uint64_t qd = kmajor<D>(sq + wg * L::kTile);
    const uint64_t dod = kmajor<D>(sq + (2 + wg) * L::kTile);

    mbar_wait(q_full, 0);
    for (int t = 0; t < nk; ++t) {
      const int s = t % kSt, k_start = t * TB;
      mbar_wait(full(s), (t / kSt) & 1);
      const uint32_t sk = stage(s), sv = stage(s) + L::kTile;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<TB>(sc, kslice<D>(qd, kk), kslice<D>(kmajor<D>(sk), kk),
                     kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<TB>(dp, kslice<D>(dod, kk), kslice<D>(kmajor<D>(sv), kk),
                     kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // sc[4jj + 2r + e]: row rows[r], key k_start + 8jj + col0 + e
      const bool edge = k_start + TB > Tk ||
                        (causal && k_start + TB - 1 > wg_start);
#pragma unroll
      for (int jj = 0; jj < TB / 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * jj + 2 * r + e;
            const int key = k_start + 8 * jj + col0 + e;
            float p = fast_exp2(fmaf(sc[x], scale2, -l2[r]));
            if (edge && (key >= Tk || (causal && key > rows[r]))) p = 0.f;
            dp[x] = p * (dp[x] - dd[r]);
          }
      to_a_frags(dp, dsa);

      fence_regs(dq_acc);
      fence_regs(dsa);
      wgmma_fence();
      const uint64_t km = mnmajor<D>(sk);
#pragma unroll
      for (int kk = 0; kk < TB / 16; ++kk)
        wgmma_rs_wide<kTransB>(dq_acc, dsa[kk], mnslice<D>(km, kk),
                                L::kRest);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      if (lane == 0) mbar_arrive(empty(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= S) continue;
      bf16* dqr = dq + b * dqs.b + h * dqs.h + rows[r] * dqs.s;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dqr + 8 * jj + col0) =
            pack_bf16(dq_acc[4 * jj + 2 * r] * scale,
                      dq_acc[4 * jj + 2 * r + 1] * scale);
    }
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return 1024 + static_cast<size_t>(2 + 2 * kStages) * Layout<D>::kTile +
         kStages * 2 * TB * 4 + (D > 128 ? TB * TB * 4 : 0) +
         (2 * kStages + 1) * 8;
}
template <int D>
constexpr size_t dq_smem() {
  return 1024 +
         static_cast<size_t>(4 + 2 * kDqStages<D>) * Layout<D>::kTile +
         (2 * kDqStages<D> + 1) * 8;
}
static_assert(dkdv_smem<160>() <= 232448 && dq_smem<160>() <= 232448,
              "a block's shared memory is 227 KB");

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* scratch, void* dq, void* dk, void* dv, int B,
                      int H, int Hkv, int S, int Tk, Strides qs, Strides ks,
                      Strides vs, Strides os, Strides dos, Strides dqs,
                      Strides dks, Strides dvs, float scale, int causal,
                      cudaStream_t stream) {
  static bool configured = false;   // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkdv_smem<D>()));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem<D>()));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  constexpr int kBox = Layout<D>::kRow / 2;    // columns a swizzle block
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t e = make_map(&q_map, q, B, H, S, D, qs, TB, kBox);
  if (e == cudaSuccess) e = make_map(&k_map, k, B, Hkv, Tk, D, ks, TB, kBox);
  if (e == cudaSuccess) e = make_map(&v_map, v, B, Hkv, Tk, D, vs, TB, kBox);
  if (e == cudaSuccess)
    e = make_map(&do_map, dout, B, H, S, D, dos, TB, kBox);
  if (e != cudaSuccess) return e;
  const int Sp = (S + kRowAlign - 1) / kRowAlign * kRowAlign;
  const long long rows = static_cast<long long>(B) * H * Sp;
  float* lse2 = scratch;
  float* di = scratch + rows;
  constexpr int kPrepRows = 256 / kPrepLanes<D>;    // rows a block
  const long long prep_blocks = (rows + kPrepRows - 1) / kPrepRows;
  if (prep_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_prep_kernel<D><<<static_cast<unsigned>(prep_blocks), 256, 0,
                             stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lse2,
      di, H, S, Sp, os, dos, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_wgmma_kernel<D>
      <<<dim3(kSplit, B * Hkv, (Tk + TB - 1) / TB), kThreadsTC,
         dkdv_smem<D>(), stream>>>(q_map, k_map, v_map, do_map, lse2, di,
                                   static_cast<bf16*>(dk),
                                   static_cast<bf16*>(dv), H, Hkv, S, Sp, Tk,
                                   dks, dvs, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_wgmma_kernel<D>
      <<<dim3(H, B, (S + 2 * TB - 1) / (2 * TB)), kThreadsTC, dq_smem<D>(),
         stream>>>(q_map, k_map, v_map, do_map, lse2, di,
                   static_cast<bf16*>(dq), H / Hkv, S, Sp, Tk, dqs, scale,
                   causal);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* scratch, void* dq, void* dk, void* dv, int B,
                        int H, int Hkv, int S, int Tk, Strides qs, Strides ks,
                        Strides vs, Strides os, Strides dos, Strides dqs,
                        Strides dks, Strides dvs, float scale, int causal,
                        cudaStream_t st) {
#define REPRO_BWD_TC_CASE(DIM)                                                \
  case DIM:                                                                   \
    return launch_tc<DIM>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H,   \
                          Hkv, S, Tk, qs, ks, vs, os, dos, dqs, dks, dvs,     \
                          scale, causal, st);
  switch (D) {
    REPRO_BWD_TC_CASE(16)
    REPRO_BWD_TC_CASE(32)
    REPRO_BWD_TC_CASE(64)
    REPRO_BWD_TC_CASE(128)
    REPRO_BWD_TC_CASE(160)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_TC_CASE
}

}  // namespace

// The gradients of repro_flash_attention's o.  q, o, dout, dq: (B, H, S, D)
// views; k, v, dk, dv: (B, Hkv, T, D) views; each given by its element
// strides over (b, h, s) with the last axis contiguous, all of one dtype.
// lse: the forward's contiguous fp32 (B, H, S) logsumexp; scratch: a
// contiguous fp32 buffer of 2 * B * H * Sp floats, Sp = S rounded up to a
// multiple of 128 (the FMA body keeps Di in its first B * H * S; the bf16
// tensor-core body keeps lse2 and Di there, each (B, H, Sp); the
// split-TF32 body needs none).  bf16 runs the tensor-core body at D <= 160
// and the FMA body at D = 256; fp32 the split-TF32 body at D <= 128 and the
// FMA body above.  The tensor-core bodies need every row start 16-byte
// aligned.  Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
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
  auto* dl = static_cast<float*>(scratch);
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  if (dtype == kFloat32) {
    if (D > 128)
      return dispatch_d<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, H,
                               Hkv, S, Tk, st[0], st[1], st[2], st[3], st[4],
                               st[5], st[6], st[7], scale, causal, s);
    for (int i = 0; i < 8; ++i)
      if (!aligned16(ptrs[i], st[i], 4)) return cudaErrorInvalidValue;
    return dispatch_tf32(D, q, k, v, o, dout, l, dq, dk, dv, B, H, Hkv, S,
                         Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                         st[7], scale, causal, s);
  }
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  if (D == 256)
    return launch<bf16, 256>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Hkv,
                             S, Tk, st[0], st[1], st[2], st[3], st[4], st[5],
                             st[6], st[7], scale, causal, s);
  for (int i = 0; i < 8; ++i)
    if (!aligned16(ptrs[i], st[i], 2)) return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * Hkv > 65535 || (Tk + TB - 1) / TB > 65535 ||
      (S + 2 * TB - 1) / (2 * TB) > 65535)
    return cudaErrorInvalidValue;
  return dispatch_tc(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Hkv, S,
                     Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                     st[7], scale, causal, s);
}
