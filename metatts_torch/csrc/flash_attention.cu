// Flash self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of flash_attention (Pallas, ops/pallas/
// attention.py of the JAX package): _fwd_kernel / _fwd_call and
// _bwd_kernel / _bwd_call.  Semantics, per (b*h) slice of q, k, v (T, D):
//
//   s     = (q k^T) * scale + bias,  bias = (mask - 1) * 1e9 for keys < T
//   m     = rowmax(s),  l = rowsum(exp(s - m))
//   out   = (cd(exp(s - m)) @ v) / max(l, 1e-30)                 fp32
//   lse   = m + log(max(l, 1e-30))                               fp32
//   p     = exp(s - lse),  delta = rowsum(do * out)              fp32
//   dv    = cd(p)^T @ cd(do),  dp = cd(do) @ v^T
//   ds    = p * (dp - delta) * scale,  dq = cd(ds) @ k,  dk = cd(ds)^T @ q
//
// cd() rounds to the contraction dtype (the input dtype); every product
// accumulates in fp32; dq, dk, dv come back in the input dtype.  A key at
// or past T does not exist (probability 0); a key inside T with mask 0
// gets the -1e9 bias, so a row without a valid key averages v, with no NaN.
// T is any length: the kernels mask the ragged tile themselves.
//
// Bound: at BH=10, T=896, D=128 the forward does 4*BH*T^2*D = 4.1 GFLOP on
// 11.5 MB, the backward ~10 GFLOP, so both are bound by tensor-core
// operations; at T=128 the forward is bound by bytes.
//
// Design (bf16): mma.sync m16n8k16 with fp32 accumulators whose register
// layout is known, so the scores, P and dS never leave registers.  The
// forward takes two passes over the keys (row max and sum, then
// cd(exp(s - m)) @ v with the final row max), which rounds P exactly where
// the TPU kernel does; it costs one extra q k^T, 1.5x the forward's
// matrix FLOPs.  The TPU backward is one program per (b*h) looping over q
// blocks; here it is three kernels: delta (and a bf16 copy of do), dk/dv
// with one block per 64-key tile looping over q, and dq with one block per
// 64-query tile looping over keys, so 140 blocks fill the card at T=896
// and no accumulation crosses blocks.  fp32 inputs take a plain-FMA path
// (one warp per row), which is slow and exact to fp32 rounding.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int DP = 128;        // head width of the tiles: D <= DP, zero padded
constexpr int LD = DP + 8;     // shared row stride (bf16 elements)
constexpr int THREADS = 128;   // 4 warps x 16 rows
constexpr int ROWS = 64;       // rows a block owns
constexpr int STEP = 32;       // rows of the other operand per backward iteration

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A (16x16, row) * B (16x8, col) + D, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layouts (lane = 4 * g + t):
//   A 16x16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8:  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8:  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)

// A[r][k] = X[r0 + r][k0 + k]
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* X, int r0, int k0, int g, int t) {
  const bf16* p = X + (r0 + g) * LD + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

// B[k][n] = Y[n0 + n][k0 + k]: the product X Y^T, k contiguous in Y
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* Y, int n0, int k0, int g, int t) {
  const bf16* p = Y + (n0 + g) * LD + k0 + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B[k][n] = Z[k0 + k][n0 + n]: the product X Z, n contiguous in Z
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* Z, int k0, int n0, int g, int t) {
  const uint16_t* p = reinterpret_cast<const uint16_t*>(Z) + (k0 + 2 * t) * LD + n0 + g;
  b[0] = (uint32_t)p[0] | ((uint32_t)p[LD] << 16);
  b[1] = (uint32_t)p[8 * LD] | ((uint32_t)p[9 * LD] << 16);
}

// rows [r0, r0 + R) of a (T, D) bf16 matrix into a zero-padded (R, DP) tile
template <int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int T, int D) {
  for (int i = threadIdx.x; i < R * (DP / 8); i += THREADS) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const int row = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < T && c < D) val = *reinterpret_cast<const uint4*>(src + (size_t)row * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// key bias of keys [k0, k0 + R): 0 valid, -1e9 masked, -inf past T
template <int R>
__device__ __forceinline__ void load_bias(float* dst, const float* mask, int k0, int T) {
  for (int i = threadIdx.x; i < R; i += THREADS) {
    const int key = k0 + i;
    dst[i] = key < T ? (mask[key] - 1.0f) * 1e9f : -INFINITY;
  }
}

__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// s[nt] (16 rows x 8 keys each) = X rows [r0, r0+16) . Y rows [n0 + 8 nt, ...)
template <int NT>
__device__ __forceinline__ void qk(float (*s)[4], const bf16* X, int r0, const bf16* Y, int n0,
                                   int nk, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t a[4];
    load_a(a, X, r0, kk * 16, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b[2];
      load_b_nk(b, Y, n0 + nt * 8, kk * 16, g, t);
      mma(s[nt], a, b);
    }
  }
}

// acc[dt] (16 rows x 8 of DP) += P (16 x 16*KC, from C fragments) @ Z rows
template <int KC>
__device__ __forceinline__ void pv(float (*acc)[4], float (*p)[4], const bf16* Z, int nd,
                                   int g, int t) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    a[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    a[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    a[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      if (dt < nd) {
        uint32_t b[2];
        load_b_kn(b, Z, kc * 16, dt * 8, g, t);
        mma(acc[dt], a, b);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr int FWD_SMEM = 3 * ROWS * LD * 2 + ROWS * 4;

// grid (ceil(T / 64), BH); each warp owns 16 query rows
__global__ void __launch_bounds__(THREADS)
fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse,
         int T, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + ROWS * LD;
  bf16* Vs = Ks + ROWS * LD;
  float* bias = reinterpret_cast<float*>(Vs + ROWS * LD);
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * T * D;
  const float* mrow = mask + (size_t)bh * T;
  const int nk = (D + 15) / 16, nd = (D + 7) / 8, r0 = warp * 16;

  load_tile<ROWS>(Qs, q + base, q0, T, D);

  // pass 1: row max and sum over all keys (rows g and g + 8 of the warp)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kv0 = 0; kv0 < T; kv0 += ROWS) {
    __syncthreads();
    load_tile<ROWS>(Ks, k + base, kv0, T, D);
    load_bias<ROWS>(bias, mrow, kv0, T);
    __syncthreads();
    float s[8][4];
    qk<8>(s, Qs, r0, Ks, 0, nk, g, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = score(s[nt][2 * h + j], scale, bias[nt * 8 + 2 * t + j]);
          s[nt][2 * h + j] = x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[h], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) sum += expf(s[nt][2 * h + j] - m_new);
      l[h] = l[h] * expf(m[h] - m_new) + quad_sum(sum);
      m[h] = m_new;
    }
  }

  // pass 2: out = cd(exp(s - m)) @ v, divided by l at the end
  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int kv0 = 0; kv0 < T; kv0 += ROWS) {
    __syncthreads();
    load_tile<ROWS>(Ks, k + base, kv0, T, D);
    load_tile<ROWS>(Vs, v + base, kv0, T, D);
    load_bias<ROWS>(bias, mrow, kv0, T);
    __syncthreads();
    float s[8][4];
    qk<8>(s, Qs, r0, Ks, 0, nk, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b = bias[nt * 8 + 2 * t + (c & 1)];
        s[nt][c] = b == -INFINITY ? 0.f : expf(score(s[nt][c], scale, b) - m[c >> 1]);
      }
    pv<4>(acc, s, Vs, nd, g, t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= T) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    float* orow = out + base + (size_t)row * D;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < D) orow[col] = acc[dt][2 * h] / lc;
      if (col + 1 < D) orow[col + 1] = acc[dt][2 * h + 1] / lc;
    }
    if (t == 0) lse[(size_t)bh * T + row] = m[h] + logf(lc);
  }
}

// delta = rowsum(do * out) (fp32) and, for bf16, do rounded to bf16;
// one warp per row
__global__ void __launch_bounds__(THREADS)
bwd_delta(const float* __restrict__ dout, const float* __restrict__ out, float* __restrict__ delta,
          bf16* __restrict__ dout_b, int rows, int D) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* d = dout + (size_t)row * D;
  const float* o = out + (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) {
    s += d[c] * o[c];
    if (dout_b) dout_b[(size_t)row * D + c] = __float2bfloat16_rn(d[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

constexpr int BWD_SMEM = 2 * (ROWS + STEP) * LD * 2 + 2 * ROWS * 4;

// grid (ceil(T / 64), BH); each warp owns 16 keys and loops over all queries
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const float* __restrict__ mask, const float* __restrict__ lse,
              const float* __restrict__ delta, const bf16* __restrict__ dout_b,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + ROWS * LD;
  bf16* Qs = Vs + ROWS * LD;
  bf16* Ds = Qs + STEP * LD;
  float* kbias = reinterpret_cast<float*>(Ds + STEP * LD);
  float* lse_s = kbias + ROWS;
  float* del_s = lse_s + STEP;
  const int bh = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * T * D;
  const int nk = (D + 15) / 16, nd = (D + 7) / 8, r0 = warp * 16;

  load_tile<ROWS>(Ks, k + base, k0, T, D);
  load_tile<ROWS>(Vs, v + base, k0, T, D);
  load_bias<ROWS>(kbias, mask + (size_t)bh * T, k0, T);
  float bk[2];

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[dt][c] = dva[dt][c] = 0.f;

  for (int q0 = 0; q0 < T; q0 += STEP) {
    __syncthreads();
    load_tile<STEP>(Qs, q + base, q0, T, D);
    load_tile<STEP>(Ds, dout_b + base, q0, T, D);
    for (int i = threadIdx.x; i < STEP; i += THREADS) {
      const bool ok = q0 + i < T;
      lse_s[i] = ok ? lse[(size_t)bh * T + q0 + i] : 0.f;
      del_s[i] = ok ? delta[(size_t)bh * T + q0 + i] : 0.f;
    }
    __syncthreads();
    bk[0] = kbias[r0 + g];
    bk[1] = kbias[r0 + g + 8];
    // S^T (16 keys x 32 queries) and dP^T = V dO^T
    float st[4][4], dpt[4][4];
    qk<4>(st, Ks, r0, Qs, 0, nk, g, t);
    qk<4>(dpt, Vs, r0, Ds, 0, nk, g, t);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = nt * 8 + 2 * t + (c & 1);
        const float b = bk[c >> 1];
        const bool ok = q0 + qi < T && b != -INFINITY;
        const float p = ok ? expf(score(st[nt][c], scale, b) - lse_s[qi]) : 0.f;
        st[nt][c] = p;
        dpt[nt][c] = p * (dpt[nt][c] - del_s[qi]) * scale;
      }
    pv<2>(dva, st, Ds, nd, g, t);
    pv<2>(dka, dpt, Qs, nd, g, t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + r0 + g + 8 * h;
    if (row >= T) continue;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = dt * 8 + 2 * t + j;
        if (col < D) {
          dk[base + (size_t)row * D + col] = __float2bfloat16_rn(dka[dt][2 * h + j]);
          dv[base + (size_t)row * D + col] = __float2bfloat16_rn(dva[dt][2 * h + j]);
        }
      }
  }
}

// grid (ceil(T / 64), BH); each warp owns 16 queries and loops over all keys
__global__ void __launch_bounds__(THREADS)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const float* __restrict__ mask, const float* __restrict__ lse,
            const float* __restrict__ delta, const bf16* __restrict__ dout_b,
            bf16* __restrict__ dq, int T, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + ROWS * LD;
  bf16* Ks = Ds + ROWS * LD;
  bf16* Vs = Ks + STEP * LD;
  float* kbias = reinterpret_cast<float*>(Vs + STEP * LD);
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * T * D;
  const int nk = (D + 15) / 16, nd = (D + 7) / 8, r0 = warp * 16;

  load_tile<ROWS>(Qs, q + base, q0, T, D);
  load_tile<ROWS>(Ds, dout_b + base, q0, T, D);
  float ls[2], de[2];
  bool ok_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    ok_row[h] = row < T;
    ls[h] = ok_row[h] ? lse[(size_t)bh * T + row] : 0.f;
    de[h] = ok_row[h] ? delta[(size_t)bh * T + row] : 0.f;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int kv0 = 0; kv0 < T; kv0 += STEP) {
    __syncthreads();
    load_tile<STEP>(Ks, k + base, kv0, T, D);
    load_tile<STEP>(Vs, v + base, kv0, T, D);
    load_bias<STEP>(kbias, mask + (size_t)bh * T, kv0, T);
    __syncthreads();
    float s[4][4], dp[4][4];
    qk<4>(s, Qs, r0, Ks, 0, nk, g, t);
    qk<4>(dp, Ds, r0, Vs, 0, nk, g, t);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b = kbias[nt * 8 + 2 * t + (c & 1)];
        const int h = c >> 1;
        const bool ok = ok_row[h] && b != -INFINITY;
        const float p = ok ? expf(score(s[nt][c], scale, b) - ls[h]) : 0.f;
        dp[nt][c] = p * (dp[nt][c] - de[h]) * scale;
      }
    pv<2>(acc, dp, Ks, nd, g, t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= T) continue;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = dt * 8 + 2 * t + j;
        if (col < D) dq[base + (size_t)row * D + col] = __float2bfloat16_rn(acc[dt][2 * h + j]);
      }
  }
}

// ------------------------------------------------------- fp32: plain FMA

constexpr int PER = DP / 32;   // columns per lane

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load_row(float* r, const float* src, int D, int lane) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    r[i] = c < D ? src[c] : 0.f;
  }
}

__device__ __forceinline__ float row_dot(const float* r, const float* src, int D, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    if (c < D) s += r[i] * src[c];
  }
  return warp_sum(s);
}

// one warp per query row; grid (ceil(T / 4), BH)
__global__ void __launch_bounds__(THREADS)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse,
        int T, int D, float scale) {
  const int bh = blockIdx.y, row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  const size_t base = (size_t)bh * T * D;
  const float* mrow = mask + (size_t)bh * T;
  float qr[PER], acc[PER];
  load_row(qr, q + base + (size_t)row * D, D, lane);
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < T; ++j) {
    const float s = score(row_dot(qr, k + base + (size_t)j * D, D, lane), scale,
                          (mrow[j] - 1.0f) * 1e9f);
    const float m_new = fmaxf(m, s);
    l = l * expf(m - m_new) + expf(s - m_new);
    m = m_new;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  for (int j = 0; j < T; ++j) {
    const float s = score(row_dot(qr, k + base + (size_t)j * D, D, lane), scale,
                          (mrow[j] - 1.0f) * 1e9f);
    const float p = expf(s - m);
    const float* vr = v + base + (size_t)j * D;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      if (c < D) acc[i] += p * vr[c];
    }
  }
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    if (c < D) out[base + (size_t)row * D + c] = acc[i] / lc;
  }
  if (lane == 0) lse[(size_t)bh * T + row] = m + logf(lc);
}

// one warp per query row: dq
__global__ void __launch_bounds__(THREADS)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ mask, const float* __restrict__ lse,
           const float* __restrict__ delta, const float* __restrict__ dout,
           float* __restrict__ dq, int T, int D, float scale) {
  const int bh = blockIdx.y, row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  const size_t base = (size_t)bh * T * D;
  const float* mrow = mask + (size_t)bh * T;
  float qr[PER], dr[PER], acc[PER];
  load_row(qr, q + base + (size_t)row * D, D, lane);
  load_row(dr, dout + base + (size_t)row * D, D, lane);
  const float ls = lse[(size_t)bh * T + row], de = delta[(size_t)bh * T + row];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  for (int j = 0; j < T; ++j) {
    const float* kr = k + base + (size_t)j * D;
    const float p = expf(score(row_dot(qr, kr, D, lane), scale, (mrow[j] - 1.0f) * 1e9f) - ls);
    const float ds = p * (row_dot(dr, v + base + (size_t)j * D, D, lane) - de) * scale;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      if (c < D) acc[i] += ds * kr[c];
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    if (c < D) dq[base + (size_t)row * D + c] = acc[i];
  }
}

// one warp per key row: dk and dv
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ mask, const float* __restrict__ lse,
             const float* __restrict__ delta, const float* __restrict__ dout,
             float* __restrict__ dk, float* __restrict__ dv, int T, int D, float scale) {
  const int bh = blockIdx.y, key = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (key >= T) return;
  const size_t base = (size_t)bh * T * D;
  const float bias = (mask[(size_t)bh * T + key] - 1.0f) * 1e9f;
  float kr[PER], vr[PER], dka[PER], dva[PER];
  load_row(kr, k + base + (size_t)key * D, D, lane);
  load_row(vr, v + base + (size_t)key * D, D, lane);
#pragma unroll
  for (int i = 0; i < PER; ++i) dka[i] = dva[i] = 0.f;
  for (int j = 0; j < T; ++j) {
    const float* qr = q + base + (size_t)j * D;
    const float* dr = dout + base + (size_t)j * D;
    const float p = expf(score(row_dot(kr, qr, D, lane), scale, bias) - lse[(size_t)bh * T + j]);
    const float ds = p * (row_dot(vr, dr, D, lane) - delta[(size_t)bh * T + j]) * scale;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        dva[i] += p * dr[c];
        dka[i] += ds * qr[c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    if (c < D) {
      dk[base + (size_t)key * D + c] = dka[i];
      dv[base + (size_t)key * D + c] = dva[i];
    }
  }
}

cudaError_t set_smem(const void* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

const char* mtts_flash_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Forward.  q, k, v: (BH, T, D) bf16 (is_bf16) or fp32; mask: (BH, T) fp32
// {0, 1}; out: (BH, T, D) fp32; lse: (BH, T) fp32.  D <= 128, and a
// multiple of 8 for bf16.  Returns the first CUDA error (0 on success).
int mtts_flash_fwd(const void* q, const void* k, const void* v, const float* mask, float* out,
                   float* lse, int BH, int T, int D, int is_bf16, float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (D > DP || D < 1 || (is_bf16 && D % 8)) return cudaErrorInvalidValue;
  cudaError_t e;
  if (is_bf16) {
    if ((e = set_smem((const void*)fwd_bf16, FWD_SMEM)) != cudaSuccess) return e;
    dim3 grid((T + ROWS - 1) / ROWS, BH);
    fwd_bf16<<<grid, THREADS, FWD_SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, out, lse, T, D, scale);
  } else {
    dim3 grid((T + 3) / 4, BH);
    fwd_f32<<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, out, lse, T, D, scale);
  }
  return cudaGetLastError();
}

// Backward.  As the forward, plus out, lse from it; dout: (BH, T, D) fp32;
// scratch: delta (BH, T) fp32 and, for bf16, dout_b (BH, T, D) bf16;
// dq, dk, dv: (BH, T, D) in the input dtype.  Three launches on `stream`.
int mtts_flash_bwd(const void* q, const void* k, const void* v, const float* mask,
                   const float* out, const float* lse, const float* dout, float* delta,
                   void* dout_b, void* dq, void* dk, void* dv, int BH, int T, int D, int is_bf16,
                   float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (D > DP || D < 1 || (is_bf16 && (D % 8 || !dout_b))) return cudaErrorInvalidValue;
  cudaError_t e;
  const int rows = BH * T;
  bwd_delta<<<(rows + 3) / 4, THREADS, 0, stream>>>(
      dout, out, delta, is_bf16 ? static_cast<bf16*>(dout_b) : nullptr, rows, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (is_bf16) {
    if ((e = set_smem((const void*)bwd_dkdv_bf16, BWD_SMEM)) != cudaSuccess) return e;
    if ((e = set_smem((const void*)bwd_dq_bf16, BWD_SMEM)) != cudaSuccess) return e;
    dim3 grid((T + ROWS - 1) / ROWS, BH);
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout_b);
    bwd_dkdv_bf16<<<grid, THREADS, BWD_SMEM, stream>>>(
        qb, kb, vb, mask, lse, delta, db, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, D,
        scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    bwd_dq_bf16<<<grid, THREADS, BWD_SMEM, stream>>>(qb, kb, vb, mask, lse, delta, db,
                                                      static_cast<bf16*>(dq), T, D, scale);
  } else {
    dim3 grid((T + 3) / 4, BH);
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v);
    bwd_dkdv_f32<<<grid, THREADS, 0, stream>>>(qf, kf, vf, mask, lse, delta, dout,
                                                static_cast<float*>(dk), static_cast<float*>(dv),
                                                T, D, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    bwd_dq_f32<<<grid, THREADS, 0, stream>>>(qf, kf, vf, mask, lse, delta, dout,
                                              static_cast<float*>(dq), T, D, scale);
  }
  return cudaGetLastError();
}

}  // extern "C"
