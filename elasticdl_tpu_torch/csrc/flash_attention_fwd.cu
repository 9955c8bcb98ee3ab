// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (elasticdl_tpu_torch/ops/kernels.py).
//
// Replaces: the Pallas TPU kernel elasticdl_tpu/ops/flash_attention.py
// `_fwd_kernel` (l.72; driven by `_fwd_impl`, pallas_call at l.225).  It
// computes
//     O   = softmax(Q K^T * D^-1/2 [+ causal mask]) V
//     lse = m + log(sum p)
// with scores and softmax statistics in f32, p rounded to the input type
// before the PV product (the TPU kernel's rounding), the all-masked-row
// guard (-inf max -> 0) and the max(l, 1e-30) clamps.
//
// What bounds it on the card: it must read q, k and v and write o once
// (plus the f32 lse).  At the serving shape (B=4, L=1024, H=12, D=64, bf16,
// causal) that is 25.4 MB, 7.6 us at 3.35 TB/s, against 4*D flops per
// (query, key) pair on or below the diagonal (6.4 GFLOP, 6.5 us at 989
// TFLOP/s); at the training shape (B=16) 101 MB, 30 us.  Both sit at the
// ridge, so what the kernel can reach is set by how well the tile loads,
// the two products and the exponentials overlap.  The TPU kernel keeps all
// of K and V in VMEM; at L=1024, D=64 in bf16 that alone is 256 KB, over
// the 227 KB of shared memory a Hopper block may use.  So K/V tiles stream
// through shared memory with an online softmax (running max m, running sum
// l, rescaled accumulator: the math of elasticdl_tpu/ops/ring_attention.py
// `accumulate`).  Scores never leave registers, so no O(L^2) tensor touches
// device memory.  Under causal masking a query tile stops at the diagonal
// tile (half the FLOPs).
//
// Design (bf16), the backward's (flash_attention_bwd.cu), from hopper.cuh:
// - One warpgroup (128 threads) per (batch*head, 64-row query tile): 64 is
//   wgmma's M.  Blocks run longest-first under causal masking.
// - The Q tile is resident in shared memory; K and V tiles of BN keys arrive
//   by TMA into a two-stage ring, each stage with an mbarrier that counts
//   the bytes in: thread 0 loads tile j+1 while the warpgroup works on tile
//   j, and refills a stage only after the __syncthreads that follows the
//   last wgmma wait that read it.  The tensor maps read q, k and v in place
//   with their row stride (views into the fused qkv projection).
// - Each tile is kept once, in the 128-byte-swizzled layout TMA writes: S =
//   Q K^T reads Q and K K-major; O += P V reads V MN-major from the same
//   kind of tile (no transposed copy of V, no fragment loads).  At D=128 a
//   tile is two 64-column halves.
// - Every product is wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate).
//   P never touches shared memory: the accumulator layout of S is, warp by
//   warp, the A layout of the register form, so p is re-packed in place as
//   bf16 pairs (rounded where the TPU rounds) for O += P V.
// - Softmax in registers: a row's scores sit on the four threads of a quad
//   (max and sum by two shuffles); exp2 on the special-function unit
//   (ex2.approx.ftz) with log2(e) folded into the scale, m kept in log2
//   units and lse written in natural-log units (m ln 2 + log l: the
//   backward reads exp(S - lse)); the causal mask only on tiles that cross
//   the diagonal; the row sum in f32 from the unrounded p.  The O
//   accumulator is rescaled between two wgmma groups, with the register
//   fences the backward's ordering notes require.
// - O / l is staged through shared memory (the ring, once free) and written
//   with 16-byte stores.
// - What sets its speed is how many blocks share an SM: each runs S,
//   softmax, PV in series, and the other blocks fill the gaps.  D=64 runs
//   64-key tiles (41 KB of shared memory, 92 registers: five blocks an SM);
//   D=128 runs 32-key tiles (49 KB, four blocks).  A deeper ring, 128-key
//   tiles, or issuing the next tile's S before this tile's softmax each
//   cost more in blocks an SM than they saved (PERF.md §6).  TMA needs
//   16-byte rows (D % 8 == 0, row strides a multiple of 8 elements,
//   16-byte-aligned pointers); the Python wrapper runs other bf16 inputs
//   over copies padded to such a head dim.
// f32 (the parity type) runs a plain FMA kernel, one thread per query row,
// because the tensor cores would round its operands to TF32.
//
// Layout: q, k and v are [B, L, H, D] read with one row stride `rs` (views
// into the fused [B, L, 3*H*D] qkv projection, or contiguous); o is written
// contiguous [B, L, H, D]; lse is f32 [B*H, L].

#include <math.h>

#include "hopper.cuh"  // TMA, mbarrier, wgmma and epilogue helpers

namespace {

constexpr int kRing = 2;  // TMA ring depth: the next K/V tile loads under this one
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kF32BlockM = 64; // query rows per block (f32 kernel, one per thread)
constexpr int kF32BlockN = 32; // keys per shared-memory tile (f32 kernel)

template <int DP, int BN>
constexpr int fwd_smem_bytes() {
  // alignment slack + the resident Q tile + the ring (a K and a V tile a stage)
  return 1024 + kBlockM * DP * 2 + kRing * 2 * BN * DP * 2;
}

// Blocks an SM can hold by shared memory (228 KB an SM, 1 KB of it kept per
// block, and the static barriers): the register allocator is held to it.
template <int DP, int BN>
constexpr int fwd_blocks_per_sm() {
  return 233472 / (fwd_smem_bytes<DP, BN>() + 1024 + 64);
}

// 2^x on the special-function unit; results below 2^-126 flush to zero
// (they add nothing to a row sum that holds the row's maximum term, 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- bf16
// DP: the head dim padded to 64 or 128 (TMA fills the columns past D with
// zeros); BN: keys a tile.

template <int DP, int BN>
__global__ void __launch_bounds__(kThreads, fwd_blocks_per_sm<DP, BN>())
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                 float* __restrict__ lse, int L, int H, int D, float scale, int causal) {
  static_assert(kBlockM % BN == 0, "a causal block ends on a tile boundary");
  constexpr int kRes = kBlockM * DP * 2;  // bytes of the resident Q tile
  constexpr int kTile = BN * DP * 2;      // bytes of a streamed K or V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kRing + 1];  // ring stages, then Q's load
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t qs = smem_u32(smem);  // Q, resident (A of Q K^T)
  const uint32_t ring = qs + kRes;     // stage s: K tile, then V tile
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t bar_q = bar0 + 8 * kRing;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // Longest causal tiles first: the last query tiles do the most work.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_b = b * L;  // row of (b, 0) in the [B*L, H, D] tensor maps
  const int n_tiles = (causal ? q0 + kBlockM : L) / BN;

  if (tid == 0) {
    for (int s = 0; s <= kRing; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  // Tile j's K and V rows into stage j % kRing (issued by thread 0).
  auto load_tile = [&](int j) {
    const int s = j % kRing;
    const uint32_t st = ring + s * 2 * kTile;
    mbar_expect_tx(bar0 + 8 * s, 2 * kTile);
    load_rows<DP, BN>(st, &tm_k, h, row_b + j * BN, BN, bar0 + 8 * s);
    load_rows<DP, BN>(st + kTile, &tm_v, h, row_b + j * BN, BN, bar0 + 8 * s);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, kRes);
    load_rows<DP, kBlockM>(qs, &tm_q, h, row_b + q0, kBlockM, bar_q);
    for (int j = 0; j < kRing - 1 && j < n_tiles; ++j) load_tile(j);
  }

  const int r0 = warp * 16 + g;  // this thread's rows q0 + r0 and q0 + r0 + 8
  const float scale_log2 = scale * kLog2e;
  float acc[DP / 2], sc[BN / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.0f;
  // Running max (log2 units, of scores times scale * log2 e) and this
  // thread's share of the running sum, for rows r0 and r0 + 8.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    // Refill the stage the previous tile used (every thread is past it).
    if (tid == 0 && j + kRing - 1 < n_tiles) load_tile(j + kRing - 1);
    const int s = j % kRing;
    const uint32_t ks = ring + s * 2 * kTile;
    const uint32_t vs = ks + kTile;
    mbar_wait(bar0 + 8 * s, (j / kRing) & 1);

    // S = Q K^T.
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BN>::ss(sc, sw128_desc(qs + kslice(kk, kBlockM), 16),
                    sw128_desc(ks + kslice(kk, BN), 16), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Keys past the query masked (only tiles that cross the diagonal), then
    // the tile's row maxima over the four threads of the quad.
    const int n0 = j * BN;
    if (causal && n0 + BN - 1 > q0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int row = q0 + r0 + ((i & 2) ? 8 : 0);
        const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (col > row) sc[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    // All-masked-row guard: a row with no key yet keeps m = -inf.
    const float sm0 = mn0 == -INFINITY ? 0.0f : mn0;
    const float sm1 = mn1 == -INFINITY ? 0.0f : mn1;
    const float corr0 = m0 == -INFINITY ? 0.0f : ex2(m0 - sm0);
    const float corr1 = m1 == -INFINITY ? 0.0f : ex2(m1 - sm1);
    m0 = mn0;
    m1 = mn1;

    // p = exp(s - m) in f32, summed unrounded; masked scores give 0.
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 4) {
      sc[i] = ex2(fmaf(sc[i], scale_log2, -sm0));
      sc[i + 1] = ex2(fmaf(sc[i + 1], scale_log2, -sm0));
      sc[i + 2] = ex2(fmaf(sc[i + 2], scale_log2, -sm1));
      sc[i + 3] = ex2(fmaf(sc[i + 3], scale_log2, -sm1));
      ps0 += sc[i] + sc[i + 1];
      ps1 += sc[i + 2] + sc[i + 3];
    }
    l0 = fmaf(l0, corr0, ps0);
    l1 = fmaf(l1, corr1, ps1);
    // p rounded to bf16 as the A operand of O += P V.
    uint32_t a[BN / 16][4];
    pack_a<BN>(a, sc);

    // The previous group that wrote acc was waited out; rescale it, then
    // O += P V with V's tile read MN-major (keys are the contraction).
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? corr1 : corr0;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt)
      Wgmma<DP>::rs(acc, a[kt], sw128_desc(vs + kt * 16 * 128, BN * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every thread is done with stage s
  }

  // Row sums across the quad; O / l through shared memory (the ring is
  // free) to 16-byte stores; lse = m ln 2 + log l.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  const float inv0 = __frcp_rn(d0), inv1 = __frcp_rn(d1);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? inv1 : inv0;
  bf16* st = reinterpret_cast<bf16*>(smem + kRes);
  stage_acc<DP>(st, r0, t, acc, 1.0f);
  if (t == 0) {
    const float sm0 = m0 == -INFINITY ? 0.0f : m0;
    const float sm1 = m1 == -INFINITY ? 0.0f : m1;
    lse[(long)bh * L + q0 + r0] = fmaf(sm0, kLn2, logf(d0));
    lse[(long)bh * L + q0 + r0 + 8] = fmaf(sm1, kLn2, logf(d1));
  }
  __syncthreads();
  const long ors = (long)H * D;  // o's row stride
  store_rows<DP>(o, (long)b * L * ors + (long)h * D, ors, q0, D, st, tid);
}

// ----------------------------------------------------------------- f32
// One thread per query row, q and the accumulator in registers, K/V tiles
// broadcast from shared memory.
template <int DP>
__global__ void __launch_bounds__(kF32BlockM)
fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int L, int H, int D, long rs,
               float scale, int causal) {
  __shared__ float ks[kF32BlockN][DP];
  __shared__ float vs[kF32BlockN][DP];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BlockM;
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const long base = (long)b * L * rs + (long)h * D;
  const long ors = (long)H * D;
  const long obase = (long)b * L * ors + (long)h * D;

  float qr[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = d < D ? q[base + row * rs + d] : 0.0f;
    acc[d] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  const int n_end = causal ? min(L, q0 + kF32BlockM) : L;
  for (int n0 = 0; n0 < n_end; n0 += kF32BlockN) {
    __syncthreads();
    for (int idx = tid; idx < kF32BlockN * DP; idx += kF32BlockM) {
      const int r = idx / DP;
      const int c = idx % DP;
      const long off = base + (long)(n0 + r) * rs + c;
      ks[r][c] = c < D ? k[off] : 0.0f;
      vs[r][c] = c < D ? v[off] : 0.0f;
    }
    __syncthreads();

    float s[kF32BlockN];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kF32BlockN; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < DP; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      float x = dot * scale;
      if (causal && n0 + j > row) x = -INFINITY;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float mn = fmaxf(m, mx);
    const float sm = mn == -INFINITY ? 0.0f : mn;
    const float corr = m == -INFINITY ? 0.0f : expf(m - sm);
    m = mn;
    l *= corr;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kF32BlockN; ++j) {
      const float p = expf(s[j] - sm);
      l += p;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
  }

  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < DP; ++d)
    if (d < D) o[obase + row * ors + d] = acc[d] / den;
  lse[(long)bh * L + row] = (m == -INFINITY ? 0.0f : m) + logf(den);
}

template <int DP, int BN>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, bf16* o, float* lse, int B,
                       int L, int H, int D, long rs, float scale, int causal, cudaStream_t st) {
  const long rows = (long)B * L;
  CUtensorMap m[3];  // Q in boxes of the block's 64 rows, K and V of BN
  if (!encode_rows(&m[0], q, D, H, rows, rs, kBlockM) ||
      !encode_rows(&m[1], k, D, H, rows, rs, BN) || !encode_rows(&m[2], v, D, H, rows, rs, BN))
    return cudaErrorInvalidValue;
  auto kernel = fwd_wgmma_kernel<DP, BN>;
  constexpr int smem = fwd_smem_bytes<DP, BN>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, L / kBlockM), kThreads, smem, st>>>(m[0], m[1], m[2], o, lse, L, H, D,
                                                          scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k and v are [B, L, H, D] with
// element (b, l, h, d) at b*L*row_stride + l*row_stride + h*D + d (row_stride
// >= H*D: H*D when contiguous, 3*H*D for views into a fused qkv); o is
// contiguous [B, L, H, D]; lse is f32 [B*H, L] (row b*H + h).  The caller
// guarantees L % 64 == 0 and D <= 128 (the Python wrapper checks the
// reference's contract, L % 128 == 0); for bfloat16 also D % 8 == 0, a row
// stride that is a multiple of 8 and 16-byte-aligned q, k, v and o (the
// wrapper pads the head dim otherwise).  Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for arguments outside the contract).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int L, int H, int D,
                                   long row_stride, float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128 || L % kBlockM != 0 || row_stride < (long)H * D)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const void* ptrs[4] = {q, k, v, o};
    if (!tma_ok(D, row_stride, (long)H * D, ptrs, 4)) return (int)cudaErrorInvalidValue;
    auto* ob = static_cast<bf16*>(o);
    auto* ls = static_cast<float*>(lse);
    if (D <= 64)
      return (int)launch_fwd<64, 64>(q, k, v, ob, ls, B, L, H, D, row_stride, scale, causal, st);
    return (int)launch_fwd<128, 32>(q, k, v, ob, ls, B, L, H, D, row_stride, scale, causal, st);
  } else if (dtype == 0) {
    const dim3 grid(B * H, L / kF32BlockM);
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(o);
    if (D <= 64)
      fwd_f32_kernel<64><<<grid, kF32BlockM, 0, st>>>(qf, kf, vf, of, static_cast<float*>(lse),
                                                    L, H, D, row_stride, scale, causal);
    else
      fwd_f32_kernel<128><<<grid, kF32BlockM, 0, st>>>(qf, kf, vf, of, static_cast<float*>(lse),
                                                     L, H, D, row_stride, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Occupancy report of the bf16 kernel for head dim D: out[5] = registers,
// static shared bytes, dynamic shared bytes, local (spill) bytes, resident
// blocks per SM.
extern "C" int flash_attention_fwd_kernel_info(int D, int* out) {
  return (int)(D <= 64 ? kernel_info(fwd_wgmma_kernel<64, 64>, fwd_smem_bytes<64, 64>(), out)
                       : kernel_info(fwd_wgmma_kernel<128, 32>, fwd_smem_bytes<128, 32>(), out));
}
