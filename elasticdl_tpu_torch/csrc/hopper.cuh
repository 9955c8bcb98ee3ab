// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): TMA tile loads into
// shared memory that complete on mbarriers, wgmma.mma_async products with
// 128-byte-swizzled shared-memory descriptors or register A operands, the
// epilogue that stages a 64-row accumulator through shared memory into
// 16-byte stores, and the host side of TMA (tensor maps encoded through the
// driver entry point cudart hands out, so no library links libcuda).
//
// Each kernel source is its own shared library and includes this header
// once, so everything here sits in an anonymous namespace.
//
// Conventions: one warpgroup (kThreads = 128) owns a 64-row block
// (kBlockM, wgmma's M); a tile of `rows` rows of a head dim padded to DP
// (64 or 128) is stored as DP/64 halves of rows x 128 bytes, in the
// 128-byte swizzle that TMA writes and wgmma reads, each half 1024-byte
// aligned.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 64;   // rows a warpgroup owns (wgmma's M)
constexpr int kThreads = 128; // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------- Hopper primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive once and expect `bytes` more to land on the barrier's phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with parity `parity` has completed.  A
// phase that never completes (a copy that never lands) traps after some
// 2^24 polls, far past any real wait, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == (1u << 24)) __trap();
  } while (!done);
}

// One TMA box (64 columns x 1 head x rows) of a [rows, H, D] tensor map to
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int head,
                                         int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, 16-byte aligned) to shared
// memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at `addr`: 8-row groups
// 1024 bytes apart (SBO); `lbo`: for an MN-major operand wider than 64
// elements, the distance between its 64-element halves (unused K-major).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of the kk-th 16-column slice of a swizzled tile of `rows`
// rows (stored as 64-column halves of rows x 128 bytes): the K-major
// operand of a product that contracts over the head dim.
__device__ __forceinline__ uint32_t kslice(int kk, int rows) {
  return (kk >> 2) * rows * 128 + (kk & 3) * 32;
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

// Keeps the compiler from moving reads or writes of accumulator registers
// across the wgmma issue and wait statements.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulate.  The accumulator of a
// thread of warp w, lane 4g + t, holds d[4j + e] = element (16w + g + 8*(e >=
// 2), 8j + 2t + (e & 1)): the m16n8 layout of mma.sync, warp by warp.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // D[64x32] (+)= A[64x16] B[16x32], A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  // D[64x64] (+)= A[64x16] B[16x64], A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }

  // D[64x64] += A[64x16] B[16x64], A from registers (the accumulator layout
  // re-packed as bf16 pairs), B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // D[64x128] += A[64x16] B[16x128], A from registers (the accumulator layout
  // re-packed as bf16 pairs), B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// A f32 accumulator of 64 x N (N/2 values a thread) as N/16 bf16 A
// operands of m64nNk16: slice kt packs columns 16kt..16kt+15.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt) {
    a[kt][0] = pack_bf16(x[8 * kt], x[8 * kt + 1]);
    a[kt][1] = pack_bf16(x[8 * kt + 2], x[8 * kt + 3]);
    a[kt][2] = pack_bf16(x[8 * kt + 4], x[8 * kt + 5]);
    a[kt][3] = pack_bf16(x[8 * kt + 6], x[8 * kt + 7]);
  }
}

// `rows` rows (a multiple of BN) of one head of a [*, H, D] tensor map,
// starting at `row`, into a swizzled tile at `dst`: DP/64 halves of rows x
// 128 bytes, boxes of BN rows.
template <int DP, int BN>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, int head, int row,
                                          int rows, uint32_t bar) {
#pragma unroll
  for (int half = 0; half < DP / 64; ++half)
    for (int r = 0; r < rows; r += BN)
      tma_load(dst + (half * rows + r) * 128, map, half * 64, head, row + r, bar);
}

// Rows r0 and r0 + 8 (local) of a 64 x DP accumulator times `mul`, as bf16,
// into a row-major staging tile of pitch DP + 8 (4-byte stores; the pad
// keeps the 32 lanes on 32 banks).
template <int DP>
__device__ __forceinline__ void stage_acc(bf16* st, int r0, int t, const float (&acc)[DP / 2],
                                          float mul) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(&st[r0 * (DP + 8) + c]) =
        pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    *reinterpret_cast<uint32_t*>(&st[(r0 + 8) * (DP + 8) + c]) =
        pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// The staging tile's 64 rows, columns < D, to out[row0 + r] (row stride
// grs) with 16-byte stores.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, long base, long grs, int row0,
                                           int D, const bf16* st, int tid) {
  const int chunks = D / 8;
  for (int idx = tid; idx < kBlockM * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = (idx % chunks) * 8;
    *reinterpret_cast<uint4*>(out + base + (long)(row0 + r) * grs + c) =
        *reinterpret_cast<const uint4*>(st + r * (DP + 8) + c);
  }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ------------------------------------------------------------- host side

// cuTensorMapEncodeTiled, fetched once through cudart's driver entry
// point, so the library needs no libcuda at link time.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A [rows, H, D] bf16 tensor map (row stride rs elements, head stride D) in
// boxes of 64 columns x 1 head x box_rows rows, 128-byte swizzle, columns
// past D filled with zeros.
bool encode_rows(CUtensorMap* map, const void* base, int D, int H, long rows, long rs,
                 int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rs * 2};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)box_rows};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What the bf16 kernels' TMA loads and 16-byte stores need: D % 8 == 0, row
// strides a multiple of 8 elements, 16-byte-aligned pointers.
bool tma_ok(int D, long rs, long grs, const void* const* ptrs, int n) {
  uintptr_t bits = 0;
  for (int i = 0; i < n; ++i) bits |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return D % 8 == 0 && rs % 8 == 0 && grs % 8 == 0 && bits % 16 == 0;
}

// Registers, static and dynamic shared memory, local (spill) bytes and
// resident blocks per SM of one bf16 kernel instantiation.
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = smem;
  out[3] = (int)attr.localSizeBytes;
  out[4] = blocks;
  return cudaSuccess;
}

}  // namespace
