// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (elasticdl_tpu_torch/ops/kernels.py).
//
// Replaces: the Pallas TPU kernel elasticdl_tpu/ops/flash_attention.py
// `_fwd_kernel` (driven by `_fwd_impl`, pallas_call at l.225).  It computes
//     O   = softmax(Q K^T * D^-1/2 [+ causal mask]) V
//     lse = m + log(sum p)
// with scores and softmax statistics in f32, p rounded to the input type
// before the PV product (the TPU kernel's rounding), the all-masked-row
// guard (-inf max -> 0) and the max(l, 1e-30) clamps.
//
// What bounds it on the card: at the serving shape (B=4, L=1024, H=12,
// D=64, bf16, causal) the kernel must read q, k, v and write o (25 MB, about
// 7.5 us at 3.35 TB/s) and do 6.4 GFLOP of tensor-core work (about 6.5 us
// at 989 TFLOP/s): it sits near the ridge, so neither bytes nor FLOPs may be
// wasted.  The TPU kernel keeps all of K and V in VMEM; at L=1024, D=64 in
// bf16 that alone is 256 KB, over the 227 KB of shared memory a Hopper
// block may use.  So this kernel streams K/V tiles of 64 keys through
// shared memory and keeps an online softmax (running max m, running sum l,
// rescaled accumulator: the math of elasticdl_tpu/ops/ring_attention.py
// `accumulate`).  Scores never leave registers, so no O(L^2) tensor touches
// device memory.  Under causal masking a query tile stops at the diagonal
// and skips every key tile past it (half the FLOPs).
//
// Design: one block per (batch*head, 64-row query tile); four warps, each
// owning 16 query rows.  bf16 uses mma.sync m16n8k16 (f32 accumulate): the
// score tile's accumulator fragments are re-packed in registers as the A
// operand of the PV product, so P never goes through shared memory.  V is
// stored transposed in shared memory so both products read their B
// operands as aligned 32-bit pairs without bank conflicts.  f32 (the
// parity type) runs a plain FMA kernel, one thread per query row, because
// the tensor cores would round its operands to TF32.  The public layout is
// [B, L, H, D] in and out, read with the head stride directly (no
// transposes, no head-dim padding in device memory); q, k and v may be
// views into one fused [B, L, 3*H*D] projection (row stride `rs`, head
// stride D, unit element stride), so the model hands over its qkv matmul's
// output without copying it apart; o is written contiguous; lse is f32
// [B*H, L].
// Simple first: no TMA, no wgmma, no cp.async pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;    // query rows per block (bf16 kernel)
constexpr int kBlockN = 64;    // keys per shared-memory tile (bf16 kernel)
constexpr int kWarps = 4;
constexpr int kF32BlockM = 64; // query rows per block (f32 kernel, one per thread)
constexpr int kF32BlockN = 32; // keys per shared-memory tile (f32 kernel)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
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

// DP: the head dim padded to a multiple of 16 in registers and shared
// memory (zeros past D), 64 or 128.
template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int L, int H, int D, long rs, float scale, int causal, int vec) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockN][DP + 8];
  __shared__ __align__(16) __nv_bfloat16 vts[DP][kBlockN + 8];

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
  const long base = (long)b * L * rs + (long)h * D;  // q/k/v element (b, 0, h, 0)
  const long ors = (long)H * D;                      // o's row stride
  const long obase = (long)b * L * ors + (long)h * D;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // This warp's 16 query rows as mma A fragments, for every 16-wide slice
  // of the head dim.
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c0 = kk * 16 + t * 2;
    const int c1 = c0 + 8;
    __nv_bfloat16 e[8];
    const int cols[4] = {c0, c0 + 1, c1, c1 + 1};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = cols[i] < D ? q[base + r0 * rs + cols[i]] : zero;
      e[4 + i] = cols[i] < D ? q[base + r1 * rs + cols[i]] : zero;
    }
    qf[kk][0] = pack_raw(e[0], e[1]);
    qf[kk][1] = pack_raw(e[4], e[5]);
    qf[kk][2] = pack_raw(e[2], e[3]);
    qf[kk][3] = pack_raw(e[6], e[7]);
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows r0 and r1
  float l0 = 0.0f, l1 = 0.0f;            // this thread's share of the row sums

  const int n_end = causal ? min(L, q0 + kBlockM) : L;
  for (int n0 = 0; n0 < n_end; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    if (vec) {
      // 16-byte loads: D % 8 == 0 and 16-byte aligned rows.
      for (int idx = tid; idx < kBlockN * (DP / 8); idx += kWarps * 32) {
        const int r = idx / (DP / 8);
        const int c = (idx % (DP / 8)) * 8;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (c < D) {
          const long off = base + (long)(n0 + r) * rs + c;
          kv = *reinterpret_cast<const uint4*>(k + off);
          vv = *reinterpret_cast<const uint4*>(v + off);
        }
        *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
        for (int i = 0; i < 8; ++i) vts[c + i][r] = ve[i];
      }
    } else {
      for (int idx = tid; idx < kBlockN * DP; idx += kWarps * 32) {
        const int r = idx / DP;
        const int c = idx % DP;
        const long off = base + (long)(n0 + r) * rs + c;
        ks[r][c] = c < D ? k[off] : zero;
        vts[c][r] = c < D ? v[off] : zero;
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const __nv_bfloat16* kp = &ks[nt * 8 + g][kk * 16 + t * 2];
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // Scale, mask on global positions, and this tile's row maxima.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = n0 + nt * 8 + t * 2 + (e & 1);
        float x = s[nt][e] * scale;
        if (causal && col > row) x = -INFINITY;
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    // All-masked-row guard: a row with no key yet keeps m = -inf.
    const float sm0 = mn0 == -INFINITY ? 0.0f : mn0;
    const float sm1 = mn1 == -INFINITY ? 0.0f : mn1;
    const float corr0 = m0 == -INFINITY ? 0.0f : expf(m0 - sm0);
    const float corr1 = m1 == -INFINITY ? 0.0f : expf(m1 - sm1);
    m0 = mn0;
    m1 = mn1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      acc[dt][0] *= corr0;
      acc[dt][1] *= corr0;
      acc[dt][2] *= corr1;
      acc[dt][3] *= corr1;
    }

    // p = exp(s - m) in f32 (summed unrounded), then rounded to bf16 as
    // the A operand of O += P V: the accumulator layout of two adjacent
    // 8-key score tiles is exactly the A layout of one 16-key slice.
#pragma unroll
    for (int kt = 0; kt < kBlockN / 16; ++kt) {
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[j][0] = expf(s[2 * kt + j][0] - sm0);
        p[j][1] = expf(s[2 * kt + j][1] - sm0);
        p[j][2] = expf(s[2 * kt + j][2] - sm1);
        p[j][3] = expf(s[2 * kt + j][3] - sm1);
        l0 += p[j][0] + p[j][1];
        l1 += p[j][2] + p[j][3];
      }
      const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                             pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const __nv_bfloat16* vp = &vts[dt * 8 + g][kt * 16 + t * 2];
        mma_bf16(acc[dt], a, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
  }

  // Row sums across the four threads that share a row.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (c < D) {
      o[obase + r0 * ors + c] = __float2bfloat16(acc[dt][0] / d0);
      o[obase + r1 * ors + c] = __float2bfloat16(acc[dt][2] / d1);
    }
    if (c + 1 < D) {
      o[obase + r0 * ors + c + 1] = __float2bfloat16(acc[dt][1] / d0);
      o[obase + r1 * ors + c + 1] = __float2bfloat16(acc[dt][3] / d1);
    }
  }
  if (t == 0) {
    const float sm0 = m0 == -INFINITY ? 0.0f : m0;
    const float sm1 = m1 == -INFINITY ? 0.0f : m1;
    lse[(long)bh * L + r0] = sm0 + logf(d0);
    lse[(long)bh * L + r1] = sm1 + logf(d1);
  }
}

// f32: one thread per query row, q and the accumulator in registers, K/V
// tiles broadcast from shared memory.
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k and v are [B, L, H, D] with
// element (b, l, h, d) at b*L*row_stride + l*row_stride + h*D + d (row_stride
// >= H*D: H*D when contiguous, 3*H*D for views into a fused qkv); o is
// contiguous [B, L, H, D].  The caller guarantees L % 64 == 0 and D <= 128
// (the Python wrapper checks the reference's contract, L % 128 == 0).
// Launches on `stream` without synchronising and returns cudaGetLastError()
// of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int L, int H, int D,
                                   long row_stride, float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 128 || L % kBlockM != 0 || row_stride < (long)H * D)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const dim3 grid(B * H, L / kBlockM);
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(o);
    // 16-byte K/V loads need every row start 16-byte aligned.
    const int vec = (D % 8 == 0) && (row_stride % 8 == 0) &&
                    ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0);
    if (D <= 64)
      fwd_bf16_kernel<64><<<grid, kWarps * 32, 0, st>>>(qb, kb, vb, ob, static_cast<float*>(lse),
                                                      L, H, D, row_stride, scale, causal, vec);
    else
      fwd_bf16_kernel<128><<<grid, kWarps * 32, 0, st>>>(qb, kb, vb, ob, static_cast<float*>(lse),
                                                       L, H, D, row_stride, scale, causal, vec);
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
