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
// operations.  Neither O(L^2) tensor (P, dS) ever leaves registers.
//
// Design.  K/V (or Q/dO) do not fit in shared memory whole at L up to 8192,
// so, as the forward, the kernels stream tiles through shared memory:
// - dq: one block per (batch*head, 64-row query tile), four warps of 16
//   rows.  Q and dO stay in registers as mma A fragments; K and V tiles of
//   BN keys stream through.  delta for the block's rows is computed in the
//   prologue from dO and O and written out for the dkv kernel (launched
//   after it on the same stream).  Under causal masking the loop stops at
//   the diagonal tile.
// - dkv: one block per (batch*head, 64-key tile), four warps of 16 keys.  K
//   and V stay in registers as A fragments; Q, dO, lse and delta tiles of BN
//   queries stream through; dK and dV accumulate in f32 registers.  Under
//   causal masking the loop starts at the diagonal tile (q tiles wholly
//   above it contribute nothing) and masks elementwise on it.
// bf16 uses mma.sync m16n8k16 with f32 accumulation.  As in the forward,
// the accumulator fragments of two adjacent 8-column tiles of dS (or P^T,
// dS^T) are re-packed in registers as the A operand of the next product, so
// they never go through shared memory.  Where a product contracts over keys
// or queries (dS K, P^T dO, dS^T Q), its B operand is read from a transposed
// copy of the tile kept in shared memory beside the row-major one, so every
// B fragment is an aligned 32-bit pair.  f32 (the parity type) runs plain FMA
// kernels, one thread per row, because the tensor cores would round f32
// operands to TF32.
//
// Layout: q, k and v are [B, L, H, D] read with one row stride `rs` (views
// into the fused [B, L, 3*H*D] qkv projection, or contiguous); o and dO are
// contiguous [B, L, H, D]; dq, dk and dv are written with one row stride
// `grs`, so autograd can hand over the fused qkv gradient whole instead of
// concatenating three copies; lse and delta are f32 [B*H, L].
// Simple first: no TMA, no wgmma, no cp.async pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 64;  // resident rows per bf16 block: queries (dq) or keys (dkv)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D[16x8] += A[16x16] (row) * B[16x8] (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows r0 and r0 + 8 of x (element (row, c) at base + row * rs + c) as mma A
// fragments over every 16-wide slice of the padded head dim (zeros past D).
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&f)[DP / 16][4], const bf16* __restrict__ x,
                                       long base, long rs, int r0, int D, int t) {
  const bf16 zero = __float2bfloat16(0.0f);
  const long p0 = base + (long)r0 * rs;
  const long p1 = p0 + 8 * rs;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c0 = kk * 16 + t * 2;
    const int cols[4] = {c0, c0 + 1, c0 + 8, c0 + 9};
    bf16 e[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = cols[i] < D ? x[p0 + cols[i]] : zero;
      e[4 + i] = cols[i] < D ? x[p1 + cols[i]] : zero;
    }
    f[kk][0] = pack_raw(e[0], e[1]);
    f[kk][1] = pack_raw(e[4], e[5]);
    f[kk][2] = pack_raw(e[2], e[3]);
    f[kk][3] = pack_raw(e[6], e[7]);
  }
}

// Rows [n0, n0 + BN) of x into shared memory, row-major `rm` and/or
// transposed `tr` (either may be null), zeros past D.  `vec`: 16-byte loads
// (D % 8 == 0, 16-byte aligned rows).
template <int DP, int BN>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ x, long base, long rs,
                                          int n0, int D, int vec, int tid,
                                          bf16 (*rm)[DP + 8], bf16 (*tr)[BN + 8]) {
  if (vec) {
    for (int idx = tid; idx < BN * (DP / 8); idx += kThreads) {
      const int r = idx / (DP / 8);
      const int c = (idx % (DP / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (c < D) val = *reinterpret_cast<const uint4*>(x + base + (long)(n0 + r) * rs + c);
      if (rm) *reinterpret_cast<uint4*>(&rm[r][c]) = val;
      if (tr) {
        const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) tr[c + i][r] = e[i];
      }
    }
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int idx = tid; idx < BN * DP; idx += kThreads) {
      const int r = idx / DP;
      const int c = idx % DP;
      const bf16 val = c < D ? x[base + (long)(n0 + r) * rs + c] : zero;
      if (rm) rm[r][c] = val;
      if (tr) tr[c][r] = val;
    }
  }
}

// Write rows r0 and r0 + 8 of an f32 accumulator (mma C layout over the
// padded head dim) times `mul`, rounded to bf16, columns < D.
template <int DP>
__device__ __forceinline__ void store_acc(bf16* __restrict__ out, long base, long rs, int r0,
                                          int D, int t, const float (&acc)[DP / 8][4], float mul) {
  const long p0 = base + (long)r0 * rs;
  const long p1 = p0 + 8 * rs;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (c < D) {
      out[p0 + c] = __float2bfloat16(acc[dt][0] * mul);
      out[p1 + c] = __float2bfloat16(acc[dt][2] * mul);
    }
    if (c + 1 < D) {
      out[p0 + c + 1] = __float2bfloat16(acc[dt][1] * mul);
      out[p1 + c + 1] = __float2bfloat16(acc[dt][3] * mul);
    }
  }
}

// ---------------------------------------------------------------- bf16 dq

template <int DP, int BN>
__global__ void __launch_bounds__(kThreads)
dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ o,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ delta, bf16* __restrict__ dq, int L, int H, int D,
               long rs, long grs, float scale, int causal, int vec) {
  __shared__ __align__(16) bf16 ks[BN][DP + 8];   // K tile, row-major (B of Q K^T)
  __shared__ __align__(16) bf16 vs[BN][DP + 8];   // V tile, row-major (B of dO V^T)
  __shared__ __align__(16) bf16 kts[DP][BN + 8];  // K tile, transposed (B of dS K)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // Longest causal tiles first: the last query tiles do the most work.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const long base = (long)b * L * rs + (long)h * D;    // q/k/v element (b, 0, h, 0)
  const long ors = (long)H * D;                        // o/dO row stride
  const long obase = (long)b * L * ors + (long)h * D;
  const long gbase = (long)b * L * grs + (long)h * D;  // dq element (b, 0, h, 0)

  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qf[DP / 16][4], df[DP / 16][4];
  load_a<DP>(qf, q, base, rs, r0, D, t);
  load_a<DP>(df, dout, obase, ors, r0, D, t);

  // delta = rowsum(dO * O) in f32: each of the four threads of a row group
  // sums a quarter of the columns, then the group reduces.
  float dl0 = 0.0f, dl1 = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c0 = kk * 16 + t * 2;
    const int cols[4] = {c0, c0 + 1, c0 + 8, c0 + 9};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (cols[i] < D) {
        const long p0 = obase + (long)r0 * ors + cols[i];
        const long p1 = p0 + 8 * ors;
        dl0 += __bfloat162float(dout[p0]) * __bfloat162float(o[p0]);
        dl1 += __bfloat162float(dout[p1]) * __bfloat162float(o[p1]);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, off);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, off);
  }
  if (t == 0) {
    delta[(long)bh * L + r0] = dl0;
    delta[(long)bh * L + r1] = dl1;
  }
  const float ls0 = lse[(long)bh * L + r0];
  const float ls1 = lse[(long)bh * L + r1];

  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;

  const int n_end = causal ? min(L, q0 + kBlockM) : L;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<DP, BN>(k, base, rs, n0, D, vec, tid, ks, kts);
    load_tile<DP, BN>(v, base, rs, n0, D, vec, tid, vs, nullptr);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and the tile's keys.
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const bf16* kp = &ks[nt * 8 + g][kk * 16 + t * 2];
        const bf16* vp = &vs[nt * 8 + g][kk * 16 + t * 2];
        mma_bf16(s[nt], qf[kk], ld32(kp), ld32(kp + 8));
        mma_bf16(dp[nt], df[kk], ld32(vp), ld32(vp + 8));
      }
    }

    // P = exp(S - lse), zero past the diagonal; dS = P (dP - delta) in f32,
    // kept in s.
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const int row = lo ? r0 : r1;
        const int col = n0 + nt * 8 + t * 2 + (e & 1);
        float p = expf(s[nt][e] * scale - (lo ? ls0 : ls1));
        if (causal && col > row) p = 0.0f;
        s[nt][e] = p * (dp[nt][e] - (lo ? dl0 : dl1));
      }
    }

    // dQ += dS K: dS rounded to bf16 and re-packed as the A operand.
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      const uint32_t a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                             pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                             pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                             pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const bf16* kp = &kts[dt * 8 + g][kt * 16 + t * 2];
        mma_bf16(acc[dt], a, ld32(kp), ld32(kp + 8));
      }
    }
  }
  store_acc<DP>(dq, gbase, grs, r0, D, t, acc, scale);
}

// --------------------------------------------------------------- bf16 dkv

template <int DP, int BN>
__global__ void __launch_bounds__(kThreads)
dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H, int D,
                long rs, long grs, float scale, int causal, int vec) {
  __shared__ __align__(16) bf16 qs[BN][DP + 8];    // Q tile, row-major (B of K Q^T)
  __shared__ __align__(16) bf16 dos[BN][DP + 8];   // dO tile, row-major (B of V dO^T)
  __shared__ __align__(16) bf16 qts[DP][BN + 8];   // Q tile, transposed (B of dS^T Q)
  __shared__ __align__(16) bf16 dots[DP][BN + 8];  // dO tile, transposed (B of P^T dO)
  __shared__ float ls_s[BN], dl_s[BN];

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
  const long base = (long)b * L * rs + (long)h * D;
  const long ors = (long)H * D;
  const long obase = (long)b * L * ors + (long)h * D;
  const long gbase = (long)b * L * grs + (long)h * D;

  const int kr0 = k0 + warp * 16 + g;  // this thread's key rows kr0 and kr0 + 8
  const int kr1 = kr0 + 8;
  uint32_t kf[DP / 16][4], vf[DP / 16][4];
  load_a<DP>(kf, k, base, rs, kr0, D, t);
  load_a<DP>(vf, v, base, rs, kr0, D, t);

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.0f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.0f;
  }

  const int m_begin = causal ? k0 : 0;
  for (int m0 = m_begin; m0 < L; m0 += BN) {
    __syncthreads();
    load_tile<DP, BN>(q, base, rs, m0, D, vec, tid, qs, qts);
    load_tile<DP, BN>(dout, obase, ors, m0, D, vec, tid, dos, dots);
    if (tid < BN) {
      ls_s[tid] = lse[(long)bh * L + m0 + tid];
      dl_s[tid] = delta[(long)bh * L + m0 + tid];
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and the tile's
    // queries.
    float st[BN / 8][4], dpt[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.0f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const bf16* qp = &qs[nt * 8 + g][kk * 16 + t * 2];
        const bf16* dp = &dos[nt * 8 + g][kk * 16 + t * 2];
        mma_bf16(st[nt], kf[kk], ld32(qp), ld32(qp + 8));
        mma_bf16(dpt[nt], vf[kk], ld32(dp), ld32(dp + 8));
      }
    }

    // P^T = exp(S^T - lse[query]), zero where the query precedes the key;
    // dS^T = P^T (dP^T - delta[query]) in f32, kept in dpt.
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? kr0 : kr1;
        const int col = nt * 8 + t * 2 + (e & 1);
        float p = expf(st[nt][e] * scale - ls_s[col]);
        if (causal && m0 + col < key) p = 0.0f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dl_s[col]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 and
    // re-packed as A operands.
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      const uint32_t ap[4] = {pack_bf16(st[2 * kt][0], st[2 * kt][1]),
                              pack_bf16(st[2 * kt][2], st[2 * kt][3]),
                              pack_bf16(st[2 * kt + 1][0], st[2 * kt + 1][1]),
                              pack_bf16(st[2 * kt + 1][2], st[2 * kt + 1][3])};
      const uint32_t ad[4] = {pack_bf16(dpt[2 * kt][0], dpt[2 * kt][1]),
                              pack_bf16(dpt[2 * kt][2], dpt[2 * kt][3]),
                              pack_bf16(dpt[2 * kt + 1][0], dpt[2 * kt + 1][1]),
                              pack_bf16(dpt[2 * kt + 1][2], dpt[2 * kt + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const bf16* dp = &dots[dt * 8 + g][kt * 16 + t * 2];
        const bf16* qp = &qts[dt * 8 + g][kt * 16 + t * 2];
        mma_bf16(dva[dt], ap, ld32(dp), ld32(dp + 8));
        mma_bf16(dka[dt], ad, ld32(qp), ld32(qp + 8));
      }
    }
  }
  store_acc<DP>(dk, gbase, grs, kr0, D, t, dka, scale);
  store_acc<DP>(dv, gbase, grs, kr0, D, t, dva, 1.0f);
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

// 16-byte tile loads need D % 8 == 0 and every row start 16-byte aligned.
int vec_ok(int D, long rs, const void* a, const void* b, const void* c) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  return (D % 8 == 0) && (rs % 8 == 0) && (bits % 16 == 0);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k and v are [B, L, H, D] with element
// (b, l, h, d) at b*L*row_stride + l*row_stride + h*D + d; o and dout are
// contiguous [B, L, H, D]; dq, dk and dv are written with grad_row_stride in
// the same way; lse and delta are f32 [B*H, L] (row b*H + h).  The caller
// guarantees L % 64 == 0 and D <= 128 (the Python wrapper checks the
// reference's contract, L % 128 == 0).  Each function launches on `stream`
// without synchronising and returns cudaGetLastError() of the launch.

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
    const dim3 grid(B * H, L / kBlockM);
    const auto* qb = static_cast<const bf16*>(q);
    const auto* kb = static_cast<const bf16*>(k);
    const auto* vb = static_cast<const bf16*>(v);
    const auto* ob = static_cast<const bf16*>(o);
    const auto* gb = static_cast<const bf16*>(dout);
    auto* dqb = static_cast<bf16*>(dq);
    const int vec = vec_ok(D, row_stride, q, k, v);
    if (D <= 64)
      dq_bf16_kernel<64, 64><<<grid, kThreads, 0, st>>>(qb, kb, vb, ob, gb, ls, dl, dqb, L, H, D,
                                                       row_stride, grad_row_stride, scale,
                                                       causal, vec);
    else
      dq_bf16_kernel<128, 32><<<grid, kThreads, 0, st>>>(qb, kb, vb, ob, gb, ls, dl, dqb, L, H,
                                                        D, row_stride, grad_row_stride, scale,
                                                        causal, vec);
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
    const dim3 grid(B * H, L / kBlockM);
    const auto* qb = static_cast<const bf16*>(q);
    const auto* kb = static_cast<const bf16*>(k);
    const auto* vb = static_cast<const bf16*>(v);
    const auto* gb = static_cast<const bf16*>(dout);
    auto* dkb = static_cast<bf16*>(dk);
    auto* dvb = static_cast<bf16*>(dv);
    const int vec = vec_ok(D, row_stride, q, dout, dout);
    if (D <= 64)
      dkv_bf16_kernel<64, 64><<<grid, kThreads, 0, st>>>(qb, kb, vb, gb, ls, dl, dkb, dvb, L, H,
                                                        D, row_stride, grad_row_stride, scale,
                                                        causal, vec);
    else
      dkv_bf16_kernel<128, 32><<<grid, kThreads, 0, st>>>(qb, kb, vb, gb, ls, dl, dkb, dvb, L,
                                                         H, D, row_stride, grad_row_stride,
                                                         scale, causal, vec);
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
