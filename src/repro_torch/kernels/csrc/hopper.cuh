// Hopper (sm_90a) primitives shared by the port's tensor-core kernels:
// shared-memory addresses, wgmma matrix descriptors, mbarriers, TMA loads
// and the tensor maps they read, and the wgmma instructions themselves;
// for the fp32 bodies, the big + small TF32 split, the m16n8k8 TF32
// mma.sync and 16-byte cp.async copies.
//
// Tiles lie in shared memory as TMA's 128-, 64- or 32-byte swizzle writes
// them (and wgmma reads them): column blocks of kRow-byte rows, each block
// 1024-byte aligned.  A K-major operand advances 32 bytes a k16 slice
// inside a block; an MN-major (transposed) one 16 rows a slice, with the
// column blocks as its leading byte offset.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {

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

// one contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory at dst, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// order this thread's shared-memory writes before later reads of the same
// bytes by wgmma or TMA (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// D (+)= A B for one m64nNk16 slice, A and B from shared memory; TransA /
// TransB = 1 read A / B MN-major (transposed).  Only N = 64 is built.
template <int N, int TransA = 0, int TransB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64, "wgmma_ss: only m64n64k16");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// D += A B for one m64nNk16 slice: A from registers, B from shared memory,
// MN-major when TransB = 1.  The accumulator's size picks N.
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
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
        "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
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
        "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
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
        "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
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
        "n"(TransB));
}

// D += A B for one m64k16 slice over N = 2 R columns (N <= 256), A from
// registers, B from shared memory (MN-major when TransB = 1).  N above 128
// is two products into the two parts of the same accumulator: columns 0 ..
// 127 from db, the rest from db + rest (16-byte units: the byte offset of
// column 128 in B's layout, >> 4).
template <int TransB, int R>
__device__ __forceinline__ void wgmma_rs_wide(float (&d)[R],
                                              const uint32_t (&a)[4],
                                              uint64_t db, uint32_t rest) {
  if constexpr (R <= 64) {
    wgmma_rs<TransB>(d, a, db);
  } else {
    static_assert(R == 80 || R == 128, "wgmma_rs_wide: N = 160 or 256");
    wgmma_rs<TransB>(*reinterpret_cast<float(*)[64]>(&d[0]), a, db);
    wgmma_rs<TransB>(*reinterpret_cast<float(*)[R - 64]>(&d[64]), a,
                     db + rest);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte offset of 16-byte piece cc of row r in a 1024-byte aligned column
// block of 128-byte rows, swizzled as TMA's 128-byte mode writes it
__device__ __forceinline__ int sw128(int r, int cc) {
  return r * 128 + ((cc ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - smem_addr(p) % 1024) % 1024);
}

// rows [row0, row0 + R) x columns [col0, col0 + 64) of a bf16 matrix of
// `rows` x `cols` with row stride ld, into one swizzled column block at
// dst, by every thread of the block; what lies past either edge is zero,
// as TMA fills it
__device__ __forceinline__ void load_block(unsigned char* dst,
                                           const __nv_bfloat16* src,
                                           long long ld, int row0, int rows,
                                           int col0, int cols, int R) {
  for (int q = threadIdx.x; q < R * 8; q += blockDim.x) {
    const int r = q >> 3, cc = q & 7, row = row0 + r;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = col0 + cc * 8 + e;
      v[e] = (row < rows && col < cols) ? src[row * ld + col]
                                        : __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(dst + sw128(r, cc)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// v as bf16 hi + lo, two values a register
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h2);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// one block-wide mbarrier for a single arrival (the thread that arms it)
__device__ __forceinline__ void init_bar(uint32_t bar) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A 4-D tensor map over a (B, H, rows, cols) bf16 view with element
// strides st (b, h, row), read in boxes of box_rows rows x box_cols columns
// (one swizzle block: box_cols * 2 bytes of 32, 64 or 128, the swizzle);
// with fp32, a view of floats read in row-major boxes, not swizzled.
// Boxes reaching past rows or cols arrive zero-filled.
// cuTensorMapEncodeTiled is looked up at run time with
// cudaGetDriverEntryPoint, so the library needs no link against libcuda.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int H,
                            int rows, int cols, Strides st, int box_rows,
                            int box_cols, bool fp32 = false) {
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
  const int esize = fp32 ? 4 : 2;
  const int row_bytes = box_cols * esize;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * esize,
                                 static_cast<cuuint64_t>(st.h) * esize,
                                 static_cast<cuuint64_t>(st.b) * esize};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      fp32 ? CU_TENSOR_MAP_SWIZZLE_NONE
      : row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map,
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// every row start 16-byte aligned, for elements of esize bytes: TMA and
// cp.async read rows in 16-byte pieces
inline bool aligned16(const void* p, Strides s, int esize) {
  const int n = 16 / esize;                 // elements a 16-byte piece
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % n == 0 &&
         s.h % n == 0 && s.s % n == 0;
}

// x as big + small for a split TF32 product: big = x with its low 13
// mantissa bits cleared (a TF32 value, x rounded toward zero), small = x -
// big (exact in fp32, below 2^-10 |x|).  The tensor cores read a .tf32
// operand's top 19 bits, so small enters a product rounded toward zero as
// well: big + small keeps x to about 20 significant bits, two operations
// a value (tests/test_torch_kernels.py emulates the rounding).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
// d += a b for one m16n8k8 slice: TF32 operands, fp32 accumulators.
// Lane l (g = l / 4, t = l % 4) holds a = A[g][t], A[g + 8][t], A[g][t +
// 4], A[g + 8][t + 4]; b = B[t][g], B[t + 4][g]; d = D[g][2t], D[g][2t +
// 1], D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// term `term` of the split product a b: a split TF32 product is three
// TF32 products, smallest first: term 0 is small.big, term 1 big.small,
// term 2 big.big
__device__ __forceinline__ void mma_term(int term, float (&d)[4],
                                         const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4],
                                         const uint32_t (&bb)[2],
                                         const uint32_t (&bs)[2]) {
  mma_tf32(d, term == 0 ? as : ab, term == 1 ? bs : bb);
}
// d[n] += a b[n] for n < N, terms kFirst .. 2, term by term: the N
// independent products of a term stand between two products on the same
// accumulator, which would otherwise wait out the mma.sync latency one
// after the other
template <int N, int kFirst>
__device__ __forceinline__ void mma3_n(float (*d)[4], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4],
                                       const uint32_t (*bb)[2],
                                       const uint32_t (*bs)[2]) {
#pragma unroll
  for (int term = kFirst; term < 3; ++term)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_term(term, d[n], ab, as, bb[n], bs[n]);
}

template <int N>
__device__ __forceinline__ void split_n(const float (&x)[N], uint32_t (&b)[N],
                                        uint32_t (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], b[i], s[i]);
}

// an A fragment of rows m0 .. m0 + 15, columns c0 .. c0 + 7 of a row-major
// fp32 tile with row stride ld, split
__device__ __forceinline__ void a_frag(const float* x, int ld, int m0,
                                       int c0, uint32_t (&b)[4],
                                       uint32_t (&s)[4]) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* r = x + (m0 + g) * ld + c0 + t;
  const float f[4] = {r[0], r[8 * ld], r[4], r[8 * ld + 4]};
  split_n(f, b, s);
}
// a B fragment read as B[k][n] = x[n0 + n][c0 + k] (x row-major: the
// transpose of a tile, as K in Q K^T), split
__device__ __forceinline__ void bt_frag(const float* x, int ld, int n0,
                                        int c0, uint32_t (&b)[2],
                                        uint32_t (&s)[2]) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* r = x + (n0 + g) * ld + c0 + t;
  const float f[2] = {r[0], r[4]};
  split_n(f, b, s);
}
// a B fragment read as B[k][n] = x[k0 + pi(k)][n0 + n], in the permuted k
// order of an accumulator used as A (k = t <-> row 2t, k = t + 4 <-> row
// 2t + 1), split
__device__ __forceinline__ void bp_frag(const float* x, int ld, int k0,
                                        int n0, uint32_t (&b)[2],
                                        uint32_t (&s)[2]) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* r = x + (k0 + 2 * t) * ld + n0 + g;
  const float f[2] = {r[0], r[ld]};
  split_n(f, b, s);
}
// an m16n8 accumulator as the A fragment of a k8 slice in that permuted
// order, split
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&b)[4],
                                         uint32_t (&s)[4]) {
  const float f[4] = {c[0], c[2], c[1], c[3]};
  split_n(f, b, s);
}

// 16 bytes from device memory into shared memory, asynchronously; zeros
// when !ok (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + R) of a (rows, D) fp32 matrix with row stride ld into
// shared memory at dst, rows D + 4 floats apart (so that the mma.sync
// fragment reads are free of bank conflicts); rows past n arrive as zeros.
// 16-byte cp.async pieces, by the block's threads; the caller commits.
template <int D>
__device__ __forceinline__ void cp_rows(float* dst, const float* src,
                                        long long ld, int row0, int n,
                                        int R) {
  constexpr int kPieces = D / 4;           // a power of two: shifts
  for (int c = threadIdx.x; c < R * kPieces; c += blockDim.x) {
    const int r = c / kPieces, col = (c % kPieces) * 4, row = row0 + r;
    const bool ok = row < n;
    cp_async16(dst + r * (D + 4) + col, ok ? src + row * ld + col : src, ok);
  }
}

}  // namespace repro
