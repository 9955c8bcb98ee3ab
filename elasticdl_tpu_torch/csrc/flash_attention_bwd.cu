// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dkv
// kernel, bound through a plain C interface and loaded with ctypes
// (elasticdl_tpu_torch/ops/kernels.py).
//
// Replaces: the Pallas TPU kernels of elasticdl_tpu/ops/flash_attention.py
//   `_dq_kernel`  (l.87; pallas_call in `_fa_bwd` l.272)
//   `_dkv_kernel` (l.108; pallas_call in `_fa_bwd` l.280)
// and the XLA precompute delta = rowsum(dO * O) of `_fa_bwd` (l.266-270),
// which moved into the dq kernel.  With S = Q K^T * D^-1/2 (causal: keys past
// the query masked), P = exp(S - lse) and delta in f32:
//   dq kernel:  dP = dO V^T;  dS = P (dP - delta);  dQ = (dS -> in type) K D^-1/2
//   dkv kernel: dV = (P^T -> in type) dO;  dK = ((P^T (V dO^T - delta)) -> in type) Q D^-1/2
// Scores, P, dP and dS stay f32; operands are rounded to the input type only
// where the TPU kernels round them (P for dV, dS for dQ and dK); dQ, dK and
// dV accumulate in f32 and are rounded once when written.
//
// One difference from the TPU dq kernel, on purpose: it recomputes each
// row's max and sum in a second look at the whole score row (it holds K
// whole in VMEM); here P = exp(S - lse) comes from the forward's lse, as the
// dkv kernel does on the TPU too.  That saves a pass over K and V per query
// tile; the two differ by the rounding of the forward's statistics, which
// tests/test_torch_flash_attention_bwd.py holds against the TPU kernels
// (run in interpret mode) at the reference's VJP tolerance.
//
// What bounds them on the card: at the training shape (B=16, L=1024, H=12,
// D=64, bf16, causal; 524,800 (query, key) pairs per head) the dq kernel
// reads q, k, v, o, dO (25 MB each) and lse, writes dq and delta: 153 MB, 46
// us at 3.35 TB/s, against 6*D flops per pair (39 us at 989 TFLOP/s): it is
// bound by bytes.  The dkv kernel reads q, k, v, dO, lse, delta and writes
// dk, dv (153 MB, 46 us) against 8*D flops per pair (52 us): bound by
// operations.  Neither O(L^2) tensor (P, dS) ever leaves registers.  Both
// kernels re-read the streamed tiles once per 64-row block (L2 serves most
// of that), so what they can reach is set by how well tile loads overlap the
// tensor-core work and how many blocks share an SM.
//
// Design (bf16).  K/V (or Q/dO) do not fit in shared memory whole at L up to
// 8192, so tiles of BN rows stream through shared memory:
// - dq: one block per (batch*head, 64-row query tile); Q and dO stay
//   resident in shared memory, K and V tiles stream.  delta for the block's
//   rows is computed in the prologue from dO and O and written out for the
//   dkv kernel (launched after it on the same stream).  Under causal masking
//   the loop stops at the diagonal tile.  Blocks run longest-first.
// - dkv: one block per (batch*head, 64-key tile); K and V resident, Q and dO
//   tiles stream with their lse and delta.  Under causal masking the loop
//   starts at the diagonal tile (q tiles wholly above it contribute nothing).
// - One warpgroup (128 threads) per block.  Every product is a
//   wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate): the block's 64
//   resident rows are exactly wgmma's M.  S = Q K^T and dP = dO V^T (S^T =
//   K Q^T and dP^T = V dO^T in dkv) read A and B from shared memory,
//   K-major.  dQ += dS K, dV += P^T dO and dK += dS^T Q take A from
//   registers: the f32 accumulator of dS (P^T, dS^T) re-packed as bf16
//   pairs, since the accumulator layout of wgmma is, warp by warp, the A
//   layout, so P and dS never touch shared memory.  Their B (K, dO, Q) is
//   read MN-major from the same tile copy that fed the first products.
// - Each tile is kept once, in the 128-byte-swizzled layout that TMA writes
//   and wgmma reads, K-major or MN-major by its descriptor: no transposed
//   copy, no bank conflicts, no fragment loads by the threads.  A row of 64
//   bf16 is one 128-byte swizzle row; at D=128 a tile is two 64-column
//   halves (the 128-byte swizzle box is at most 128 bytes wide).
// - Tiles arrive by TMA into a ring of kStages stages, each with an
//   mbarrier that counts the bytes in.  Thread 0 keeps kStages - 1 tiles in
//   flight ahead of the warpgroup; a stage is refilled only after every
//   thread has waited out the wgmma groups that read it (one __syncthreads
//   per tile).  dkv's lse and delta come along by a 1-D bulk copy on the same
//   barrier.
// - Scalar work: exp2 with log2(e) folded into the scale and lse; the causal
//   mask only on tiles that cross the diagonal; dQ, dK, dV staged through
//   shared memory and written with 16-byte stores.
// - The tensor maps are encoded on the host at every launch (pointers change
//   each step) through the driver entry point that cudart hands out, so the
//   library links no libcuda, and passed as __grid_constant__ parameters.
// - D=64 runs 64-row tiles, three stages (64 KB of shared memory a block,
//   three blocks an SM); D=128 runs 32-row tiles (two blocks an SM).  TMA
//   needs 16-byte rows: D % 8 == 0, row strides a multiple of 8 elements,
//   16-byte-aligned pointers; the Python wrapper copies other inputs into a
//   head dim padded to a multiple of 8 (columns past D read as zeros; TMA
//   fills the rest of a 64-column box with zeros).
// f32 (the parity type) runs plain FMA kernels, one thread per row, because
// the tensor cores would round f32 operands to TF32.
//
// Layout: q, k and v are [B, L, H, D] read with one row stride `rs` (views
// into the fused [B, L, 3*H*D] qkv projection, or contiguous); o and dO are
// contiguous [B, L, H, D]; dq, dk and dv are written with one row stride
// `grs`, so autograd can hand over the fused qkv gradient whole instead of
// concatenating three copies; lse and delta are f32 [B*H, L].

#include <math.h>

#include "hopper.cuh"  // TMA, mbarrier, wgmma and epilogue helpers

namespace {

constexpr int kStages = 3;  // TMA ring depth

template <int DP, int BN>
constexpr int bf16_smem_bytes() {
  // alignment slack + two resident 64-row tiles + the ring (two tiles a stage)
  return 1024 + 2 * kBlockM * DP * 2 + kStages * 2 * BN * DP * 2;
}

// ---------------------------------------------------------------- bf16 dq
// Both bf16 kernels ask the register allocator for three blocks an SM at
// D=64 (about 64 KB of shared memory each; at most 168 registers a thread).

template <int DP, int BN>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 3 : 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
                int L, int H, int D, long grs, float scale, int causal) {
  constexpr int kRes = kBlockM * DP * 2;  // bytes of a resident tile
  constexpr int kTile = BN * DP * 2;      // bytes of a streamed tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // ring stages, then the resident load
  __shared__ float dl_s[kBlockM];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t qs = smem_u32(smem);  // Q, resident (A of Q K^T)
  const uint32_t dos = qs + kRes;      // dO, resident (A of dO V^T)
  const uint32_t ring = dos + kRes;    // stage s: K tile, then V tile
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t bar_res = bar0 + 8 * kStages;

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
    for (int s = 0; s <= kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  // Tile j's K and V rows into stage j % kStages (issued by thread 0).
  auto load_tile = [&](int j) {
    const int s = j % kStages;
    const uint32_t st = ring + s * 2 * kTile;
    mbar_expect_tx(bar0 + 8 * s, 2 * kTile);
    load_rows<DP, BN>(st, &tm_k, h, row_b + j * BN, BN, bar0 + 8 * s);
    load_rows<DP, BN>(st + kTile, &tm_v, h, row_b + j * BN, BN, bar0 + 8 * s);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_res, 2 * kRes);
    load_rows<DP, BN>(qs, &tm_q, h, row_b + q0, kBlockM, bar_res);
    load_rows<DP, BN>(dos, &tm_do, h, row_b + q0, kBlockM, bar_res);
    for (int j = 0; j < kStages - 1 && j < n_tiles; ++j) load_tile(j);
  }

  // delta = rowsum(dO * O) in f32 while the tiles load: two threads a row,
  // 16-byte loads, alternate 8-column chunks.
  {
    const int r = tid >> 1;
    const long off = ((long)(row_b + q0 + r) * H + h) * D;
    float sum = 0.0f;
    for (int c = (tid & 1) * 8; c < D; c += 16) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + off + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(dout + off + c);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 of = __bfloat1622float2(op[i]);
        const float2 gf = __bfloat1622float2(gp[i]);
        sum = fmaf(gf.x, of.x, sum);
        sum = fmaf(gf.y, of.y, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((tid & 1) == 0) {
      dl_s[r] = sum;
      delta[(long)bh * L + q0 + r] = sum;
    }
  }
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 (local)
  const float dl0 = dl_s[r0], dl1 = dl_s[r0 + 8];
  const float ls0 = lse[(long)bh * L + q0 + r0] * kLog2e;
  const float ls1 = lse[(long)bh * L + q0 + r0 + 8] * kLog2e;
  const float scale_log2 = scale * kLog2e;

  float acc[DP / 2], sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.0f;
  mbar_wait(bar_res, 0);

  for (int j = 0; j < n_tiles; ++j) {
    // Refill the stage the previous tile used (every thread is past it).
    if (tid == 0 && j + kStages - 1 < n_tiles) load_tile(j + kStages - 1);
    const int s = j % kStages;
    const uint32_t ks = ring + s * 2 * kTile;
    const uint32_t vs = ks + kTile;
    mbar_wait(bar0 + 8 * s, (j / kStages) & 1);

    // S = Q K^T, then dP = dO V^T: two groups, so the exponentials of S run
    // while dP is in the tensor cores.
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BN>::ss(sc, sw128_desc(qs + kslice(kk, kBlockM), 16),
                    sw128_desc(ks + kslice(kk, BN), 16), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BN>::ss(dp, sw128_desc(dos + kslice(kk, kBlockM), 16),
                    sw128_desc(vs + kslice(kk, BN), 16), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P = exp(S - lse), zero past the diagonal (only tiles that cross it).
    const int n0 = j * BN;
    if (causal && n0 + BN - 1 > q0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int row = q0 + r0 + ((i & 2) ? 8 : 0);
        const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const float p = exp2f(fmaf(sc[i], scale_log2, -((i & 2) ? ls1 : ls0)));
        sc[i] = col > row ? 0.0f : p;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -((i & 2) ? ls1 : ls0)));
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P (dP - delta), f32, rounded to bf16 as dQ's A operand.
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] *= dp[i] - ((i & 2) ? dl1 : dl0);
    uint32_t a[BN / 16][4];
    pack_a<BN>(a, sc);

    // dQ += dS K: K's tile read MN-major (keys are the contraction).
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt)
      Wgmma<DP>::rs(acc, a[kt], sw128_desc(ks + kt * 16 * 128, BN * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every thread is done with stage s
  }

  // dQ * D^-1/2 through shared memory (the ring is free) to 16-byte stores.
  bf16* st = reinterpret_cast<bf16*>(smem + 2 * kRes);
  stage_acc<DP>(st, r0, t, acc, scale);
  __syncthreads();
  store_rows<DP>(dq, (long)b * L * grs + (long)h * D, grs, q0, D, st, tid);
}

// --------------------------------------------------------------- bf16 dkv

template <int DP, int BN>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 3 : 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int L, int H, int D, long grs, float scale, int causal) {
  constexpr int kRes = kBlockM * DP * 2;
  constexpr int kTile = BN * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];
  __shared__ __align__(16) float ls_s[kStages][BN];  // lse of the stage's queries
  __shared__ __align__(16) float dl_s[kStages][BN];  // delta of the stage's queries
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t ks = smem_u32(smem);  // K, resident (A of K Q^T)
  const uint32_t vs = ks + kRes;       // V, resident (A of V dO^T)
  const uint32_t ring = vs + kRes;     // stage s: Q tile, then dO tile
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t bar_res = bar0 + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // Key tile 0 first: under causal masking the first key tiles see the
  // most queries.
  const int k0 = blockIdx.y * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_b = b * L;
  const int m_begin = causal ? k0 : 0;
  const int n_tiles = (L - m_begin) / BN;

  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  // Tile j's Q and dO rows, lse and delta into stage j % kStages (issued
  // by thread 0).
  auto load_tile = [&](int j) {
    const int s = j % kStages;
    const int m0 = m_begin + j * BN;
    const uint32_t st = ring + s * 2 * kTile;
    const uint32_t bar = bar0 + 8 * s;
    mbar_expect_tx(bar, 2 * kTile + 2 * BN * 4);
    load_rows<DP, BN>(st, &tm_q, h, row_b + m0, BN, bar);
    load_rows<DP, BN>(st + kTile, &tm_do, h, row_b + m0, BN, bar);
    bulk_load(smem_u32(ls_s[s]), lse + (long)bh * L + m0, BN * 4, bar);
    bulk_load(smem_u32(dl_s[s]), delta + (long)bh * L + m0, BN * 4, bar);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_res, 2 * kRes);
    load_rows<DP, BN>(ks, &tm_k, h, row_b + k0, kBlockM, bar_res);
    load_rows<DP, BN>(vs, &tm_v, h, row_b + k0, kBlockM, bar_res);
    for (int j = 0; j < kStages - 1 && j < n_tiles; ++j) load_tile(j);
  }

  const int r0 = warp * 16 + g;  // this thread's keys k0 + r0 and k0 + r0 + 8
  const int key0 = k0 + r0;
  const float scale_log2 = scale * kLog2e;
  float dka[DP / 2], dva[DP / 2], sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.0f;
  mbar_wait(bar_res, 0);

  for (int j = 0; j < n_tiles; ++j) {
    if (tid == 0 && j + kStages - 1 < n_tiles) load_tile(j + kStages - 1);
    const int s = j % kStages;
    const uint32_t qs = ring + s * 2 * kTile;
    const uint32_t dos = qs + kTile;
    mbar_wait(bar0 + 8 * s, (j / kStages) & 1);

    // S^T = K Q^T, then dP^T = V dO^T.
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BN>::ss(sc, sw128_desc(ks + kslice(kk, kBlockM), 16),
                    sw128_desc(qs + kslice(kk, BN), 16), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BN>::ss(dp, sw128_desc(vs + kslice(kk, kBlockM), 16),
                    sw128_desc(dos + kslice(kk, BN), 16), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P^T = exp(S^T - lse[query]), zero where the query precedes the key
    // (only tiles that cross the diagonal).
    const int m0 = m_begin + j * BN;
    const bool diag = causal && m0 < k0 + kBlockM - 1;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float2 ls = *reinterpret_cast<const float2*>(&ls_s[s][8 * nt + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * nt + e;
        const float p = exp2f(fmaf(sc[i], scale_log2, -((e & 1) ? ls.y : ls.x) * kLog2e));
        const int query = m0 + 8 * nt + 2 * t + (e & 1);
        sc[i] = (diag && query < key0 + ((e & 2) ? 8 : 0)) ? 0.0f : p;
      }
    }
    uint32_t ap[BN / 16][4];
    pack_a<BN>(ap, sc);
    wgmma_wait<0>();
    fence_regs(dp);
    // dS^T = P^T (dP^T - delta[query]) in f32.
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float2 dl = *reinterpret_cast<const float2*>(&dl_s[s][8 * nt + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * nt + e;
        dp[i] = sc[i] * (dp[i] - ((e & 1) ? dl.y : dl.x));
      }
    }
    uint32_t ad[BN / 16][4];
    pack_a<BN>(ad, dp);

    // dV += P^T dO and dK += dS^T Q: dO's and Q's tiles read MN-major.
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt)
      Wgmma<DP>::rs(dva, ap[kt], sw128_desc(dos + kt * 16 * 128, BN * 128));
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt)
      Wgmma<DP>::rs(dka, ad[kt], sw128_desc(qs + kt * 16 * 128, BN * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    __syncthreads();
  }

  bf16* st_k = reinterpret_cast<bf16*>(smem + 2 * kRes);
  bf16* st_v = st_k + kBlockM * (DP + 8);
  stage_acc<DP>(st_k, r0, t, dka, scale);
  stage_acc<DP>(st_v, r0, t, dva, 1.0f);
  __syncthreads();
  const long gbase = (long)b * L * grs + (long)h * D;
  store_rows<DP>(dk, gbase, grs, k0, D, st_k, tid);
  store_rows<DP>(dv, gbase, grs, k0, D, st_v, tid);
}

// ----------------------------------------------------------------- f32 dq
// One thread per query row.  The block's q and dO rows live transposed in
// shared memory (thread i reads column i: no bank conflicts), the dq row in
// registers; K/V tiles of BN keys are broadcast from shared memory.

template <int DP, int ROWS, int BN>
__global__ void __launch_bounds__(ROWS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, float* __restrict__ dq, int L, int H, int D,
              long rs, long grs, float scale, int causal) {
  __shared__ float qT[DP][ROWS];
  __shared__ float dT[DP][ROWS];
  __shared__ float ks[BN][DP];
  __shared__ float vs[BN][DP];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const long base = (long)b * L * rs + (long)h * D;
  const long ors = (long)H * D;
  const long obase = (long)b * L * ors + (long)h * D;
  const long gbase = (long)b * L * grs + (long)h * D;

  float dl = 0.0f;
  for (int d = 0; d < DP; ++d) {
    const bool in = d < D;
    const float gd = in ? dout[obase + (long)row * ors + d] : 0.0f;
    qT[d][tid] = in ? q[base + (long)row * rs + d] : 0.0f;
    dT[d][tid] = gd;
    if (in) dl = fmaf(gd, o[obase + (long)row * ors + d], dl);
  }
  delta[(long)bh * L + row] = dl;
  const float ls = lse[(long)bh * L + row];

  float acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] = 0.0f;

  const int n_end = causal ? min(L, q0 + ROWS) : L;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();
    for (int idx = tid; idx < BN * DP; idx += ROWS) {
      const int r = idx / DP;
      const int c = idx % DP;
      const long off = base + (long)(n0 + r) * rs + c;
      ks[r][c] = c < D ? k[off] : 0.0f;
      vs[r][c] = c < D ? v[off] : 0.0f;
    }
    __syncthreads();

    float s[BN], dp[BN];
#pragma unroll
    for (int j = 0; j < BN; ++j) s[j] = dp[j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float qd = qT[d][tid];
      const float gd = dT[d][tid];
#pragma unroll
      for (int j = 0; j < BN; ++j) {
        s[j] = fmaf(qd, ks[j][d], s[j]);
        dp[j] = fmaf(gd, vs[j][d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float p = expf(s[j] * scale - ls);
      if (causal && n0 + j > row) p = 0.0f;
      const float ds = p * (dp[j] - dl);
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < DP; ++d)
    if (d < D) dq[gbase + (long)row * grs + d] = acc[d] * scale;
}

// ---------------------------------------------------------------- f32 dkv
// One thread per key row: k and v rows transposed in shared memory, dk and
// dv rows in registers; Q/dO tiles of BN queries broadcast from shared
// memory.

template <int DP, int ROWS, int BN>
__global__ void __launch_bounds__(ROWS)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int L, int H, int D,
               long rs, long grs, float scale, int causal) {
  __shared__ float kT[DP][ROWS];
  __shared__ float vT[DP][ROWS];
  __shared__ float qs[BN][DP];
  __shared__ float dos[BN][DP];
  __shared__ float ls_s[BN], dl_s[BN];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int key = k0 + tid;
  const long base = (long)b * L * rs + (long)h * D;
  const long ors = (long)H * D;
  const long obase = (long)b * L * ors + (long)h * D;
  const long gbase = (long)b * L * grs + (long)h * D;

  for (int d = 0; d < DP; ++d) {
    const bool in = d < D;
    kT[d][tid] = in ? k[base + (long)key * rs + d] : 0.0f;
    vT[d][tid] = in ? v[base + (long)key * rs + d] : 0.0f;
  }
  float dka[DP], dva[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) dka[d] = dva[d] = 0.0f;

  const int m_begin = causal ? k0 : 0;
  for (int m0 = m_begin; m0 < L; m0 += BN) {
    __syncthreads();
    for (int idx = tid; idx < BN * DP; idx += ROWS) {
      const int r = idx / DP;
      const int c = idx % DP;
      qs[r][c] = c < D ? q[base + (long)(m0 + r) * rs + c] : 0.0f;
      dos[r][c] = c < D ? dout[obase + (long)(m0 + r) * ors + c] : 0.0f;
    }
    if (tid < BN) {
      ls_s[tid] = lse[(long)bh * L + m0 + tid];
      dl_s[tid] = delta[(long)bh * L + m0 + tid];
    }
    __syncthreads();

    float s[BN], dp[BN];
#pragma unroll
    for (int j = 0; j < BN; ++j) s[j] = dp[j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float kd = kT[d][tid];
      const float vd = vT[d][tid];
#pragma unroll
      for (int j = 0; j < BN; ++j) {
        s[j] = fmaf(kd, qs[j][d], s[j]);
        dp[j] = fmaf(vd, dos[j][d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float p = expf(s[j] * scale - ls_s[j]);
      if (causal && m0 + j < key) p = 0.0f;
      const float ds = p * (dp[j] - dl_s[j]);
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        dva[d] = fmaf(p, dos[j][d], dva[d]);
        dka[d] = fmaf(ds, qs[j][d], dka[d]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    if (d < D) {
      dk[gbase + (long)key * grs + d] = dka[d] * scale;
      dv[gbase + (long)key * grs + d] = dva[d];
    }
  }
}

int check_args(int L, int H, int D, long rs, long grs) {
  if (D < 1 || D > 128 || L % kBlockM != 0 || rs < (long)H * D || grs < (long)H * D)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The maps of q, k, v (row stride rs) and dO (contiguous) for tiles of BN
// rows; false if the driver refuses one.
bool encode_qkv_do(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                   const void* dout, int B, int L, int H, int D, long rs, int BN) {
  const long rows = (long)B * L;
  return encode_rows(&m[0], q, D, H, rows, rs, BN) && encode_rows(&m[1], k, D, H, rows, rs, BN) &&
         encode_rows(&m[2], v, D, H, rows, rs, BN) &&
         encode_rows(&m[3], dout, D, H, rows, (long)H * D, BN);
}

template <int DP, int BN>
cudaError_t launch_dq(const CUtensorMap (&m)[4], const bf16* o, const bf16* dout,
                      const float* lse, float* delta, bf16* dq, int B, int L, int H, int D,
                      long grs, float scale, int causal, cudaStream_t st) {
  auto kernel = dq_wgmma_kernel<DP, BN>;
  constexpr int smem = bf16_smem_bytes<DP, BN>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, L / kBlockM), kThreads, smem, st>>>(m[0], m[1], m[2], m[3], o, dout, lse,
                                                          delta, dq, L, H, D, grs, scale, causal);
  return cudaGetLastError();
}

template <int DP, int BN>
cudaError_t launch_dkv(const CUtensorMap (&m)[4], const float* lse, const float* delta, bf16* dk,
                       bf16* dv, int B, int L, int H, int D, long grs, float scale, int causal,
                       cudaStream_t st) {
  auto kernel = dkv_wgmma_kernel<DP, BN>;
  constexpr int smem = bf16_smem_bytes<DP, BN>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, L / kBlockM), kThreads, smem, st>>>(m[0], m[1], m[2], m[3], lse, delta, dk,
                                                          dv, L, H, D, grs, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k and v are [B, L, H, D] with element
// (b, l, h, d) at b*L*row_stride + l*row_stride + h*D + d; o and dout are
// contiguous [B, L, H, D]; dq, dk and dv are written with grad_row_stride in
// the same way; lse and delta are f32 [B*H, L] (row b*H + h).  The caller
// guarantees L % 64 == 0 and D <= 128 (the Python wrapper checks the
// reference's contract, L % 128 == 0); for bfloat16 also D % 8 == 0, both row
// strides a multiple of 8 and every pointer 16-byte aligned (the wrapper
// pads the head dim otherwise).  Each function launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for arguments outside the contract).

// dq and delta = rowsum(dout * o); the dkv kernel reads that delta, so it
// must be launched after this one on the same stream.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* delta, void* dq, int B, int L, int H, int D,
                                      long row_stride, long grad_row_stride, float scale,
                                      int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int bad = check_args(L, H, D, row_stride, grad_row_stride)) return bad;
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 1) {
    const void* ptrs[8] = {q, k, v, o, dout, lse, delta, dq};
    if (!tma_ok(D, row_stride, grad_row_stride, ptrs, 8)) return (int)cudaErrorInvalidValue;
    const int bn = D <= 64 ? 64 : 32;
    CUtensorMap maps[4];
    if (!encode_qkv_do(maps, q, k, v, dout, B, L, H, D, row_stride, bn))
      return (int)cudaErrorInvalidValue;
    const auto* ob = static_cast<const bf16*>(o);
    const auto* gb = static_cast<const bf16*>(dout);
    auto* dqb = static_cast<bf16*>(dq);
    if (D <= 64)
      return (int)launch_dq<64, 64>(maps, ob, gb, ls, dl, dqb, B, L, H, D, grad_row_stride, scale,
                                    causal, st);
    return (int)launch_dq<128, 32>(maps, ob, gb, ls, dl, dqb, B, L, H, D, grad_row_stride, scale,
                                   causal, st);
  } else if (dtype == 0) {
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    const auto* of = static_cast<const float*>(o);
    const auto* gf = static_cast<const float*>(dout);
    auto* dqf = static_cast<float*>(dq);
    if (D <= 64)
      dq_f32_kernel<64, 64, 16><<<dim3(B * H, L / 64), 64, 0, st>>>(
          qf, kf, vf, of, gf, ls, dl, dqf, L, H, D, row_stride, grad_row_stride, scale, causal);
    else
      dq_f32_kernel<128, 32, 8><<<dim3(B * H, L / 32), 32, 0, st>>>(
          qf, kf, vf, of, gf, ls, dl, dqf, L, H, D, row_stride, grad_row_stride, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dk and dv from the forward's lse and the dq kernel's delta.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int L, int H, int D,
                                       long row_stride, long grad_row_stride, float scale,
                                       int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int bad = check_args(L, H, D, row_stride, grad_row_stride)) return bad;
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1) {
    const void* ptrs[8] = {q, k, v, dout, lse, delta, dk, dv};
    if (!tma_ok(D, row_stride, grad_row_stride, ptrs, 8)) return (int)cudaErrorInvalidValue;
    const int bn = D <= 64 ? 64 : 32;
    CUtensorMap maps[4];
    if (!encode_qkv_do(maps, q, k, v, dout, B, L, H, D, row_stride, bn))
      return (int)cudaErrorInvalidValue;
    auto* dkb = static_cast<bf16*>(dk);
    auto* dvb = static_cast<bf16*>(dv);
    if (D <= 64)
      return (int)launch_dkv<64, 64>(maps, ls, dl, dkb, dvb, B, L, H, D, grad_row_stride, scale,
                                     causal, st);
    return (int)launch_dkv<128, 32>(maps, ls, dl, dkb, dvb, B, L, H, D, grad_row_stride, scale,
                                    causal, st);
  } else if (dtype == 0) {
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    const auto* gf = static_cast<const float*>(dout);
    auto* dkf = static_cast<float*>(dk);
    auto* dvf = static_cast<float*>(dv);
    if (D <= 64)
      dkv_f32_kernel<64, 64, 16><<<dim3(B * H, L / 64), 64, 0, st>>>(
          qf, kf, vf, gf, ls, dl, dkf, dvf, L, H, D, row_stride, grad_row_stride, scale, causal);
    else
      dkv_f32_kernel<128, 32, 8><<<dim3(B * H, L / 32), 32, 0, st>>>(
          qf, kf, vf, gf, ls, dl, dkf, dvf, L, H, D, row_stride, grad_row_stride, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Occupancy report of a bf16 kernel: kernel 0 = dq, 1 = dkv, for head dim D;
// out[5] = registers, static shared bytes, dynamic shared bytes, local
// (spill) bytes, resident blocks per SM.
extern "C" int flash_attention_bwd_kernel_info(int kernel, int D, int* out) {
  if (kernel == 0)
    return (int)(D <= 64 ? kernel_info(dq_wgmma_kernel<64, 64>, bf16_smem_bytes<64, 64>(), out)
                         : kernel_info(dq_wgmma_kernel<128, 32>, bf16_smem_bytes<128, 32>(), out));
  if (kernel == 1)
    return (int)(D <= 64 ? kernel_info(dkv_wgmma_kernel<64, 64>, bf16_smem_bytes<64, 64>(), out)
                         : kernel_info(dkv_wgmma_kernel<128, 32>, bf16_smem_bytes<128, 32>(), out));
  return (int)cudaErrorInvalidValue;
}
