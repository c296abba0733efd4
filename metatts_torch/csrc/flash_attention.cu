// Flash self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of flash_attention (Pallas, ops/pallas/
// attention.py of the JAX package): _fwd_kernel / _fwd_call (:95) and
// _bwd_kernel / _bwd_call (:129).  Semantics, per (b*h) slice of q, k, v
// (T, D):
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
// 11.5 MB and the backward 10*BH*T^2*D = 10.3 GFLOP on 23 MB, so both are
// bound by tensor-core operations (0.0042 / 0.0104 ms at 989 TFLOP/s); at
// T=128 (0.08 / 0.21 GFLOP) both are bound by bytes, and a call by the
// host's enqueue.
//
// Design (bf16): every product is wgmma.mma_async (m64nNk16, bf16 in, fp32
// accumulate; hopper.cuh) on tiles that TMA brings into shared memory in
// the 128-byte swizzled layout, 64 rows by 128 columns (D <= 128: TMA
// zero-fills the columns past D and the rows past T).  A block is one
// consumer warpgroup that owns 64 rows and issues wgmma, and one producer
// warp that streams the other operand's tiles through a 2-stage ring of
// mbarriers, with each tile's key biases (or its queries' lse and delta)
// computed into the stage beside it; the producer's warpgroup gives its
// registers to the consumer (setmaxnreg 24 / 232).  82 KB (forward) or
// 98 KB (backward) of shared memory and 256 x 128 registers a block, so two
// blocks share an SM: the forward's 140 blocks at BH=10, T=896 run in one
// wave on 132 SMs, where a block an SM would leave a second wave of 8, and
// two blocks on an SM overlap one's softmax and loads with the other's
// products (at one block an SM the forward at T=896 takes 1.5x as long on
// an H100).  Where the time goes: tools/flash_ablate.py.
//
// * Forward: two passes over the keys, as the TPU kernel rounds P with the
//   final row max.  Pass 1 scores 128 keys a step (S = Q K^T, wgmma SS) and
//   keeps the fp32 row max and sum; pass 2 scores 64 keys with their V,
//   forms cd(exp(s - m)) in registers and feeds it as the register A
//   operand of P V, V read through the transpose bit.  The epilogue divides
//   by l and writes fp32 out and the natural-log lse.  Softmax runs in base
//   2: s log2(e) = fma(dot, scale log2(e), bias log2(e)), one ex2 a score.
// * Backward: a prologue kernel (delta from the fp32 do and out, and do
//   rounded to bf16), then one launch of two roles with no atomics, so the
//   result is deterministic.  Role 0 owns 64 keys and loops over the query
//   tiles: S^T = K Q^T and dP^T = V dO^T (SS), then P^T and dS^T in
//   registers, dV += P^T dO and dK += dS^T Q with P^T and dS^T as register
//   A operands and dO and Q through the transpose bit.  Role 1 owns 64
//   queries and loops over the key tiles: S = Q K^T, dP = dO V^T, then dQ
//   += dS K.  All role-0 blocks are scheduled before role-1 blocks.
//
// fp32 inputs take a plain-FMA path (one warp per row), which is slow and
// exact to fp32 rounding.

#include "hopper.cuh"

namespace {

constexpr int DP = 128;        // head width of the tiles: D <= DP, zero filled
constexpr int THREADS = 128;   // fp32 path: 4 warps, a row each
constexpr int ROWS = 64;       // rows of a tile; the consumer warpgroup's rows

// ------------------------------------------------------- bf16: wgmma + TMA

constexpr int WG_THREADS = 256;                // consumer + producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 232;   // 2 x 128 x 256 = 64K
constexpr int TILE = ROWS * DP * 2;            // 16 KB: two 64-column boxes of 8 KB
// a slot holds two tiles a (0) and b (1) box by box: [box 0 of a | box 0
// of b | box 1 of a | box 1 of b], so a and b are also one 128-row operand
constexpr int BOX_STRIDE = 2 * 8192;
constexpr int SLOT = 2 * TILE;
constexpr int VEC = 128;                       // floats of a stage's vector
constexpr int NBARS = 5;                       // resident, full[2], empty[2]
constexpr int FWD_SMEM = 1024 + TILE + 2 * SLOT + 2 * VEC * 4 + NBARS * 8;
constexpr int BWD_SMEM = 1024 + SLOT + 2 * SLOT + 2 * VEC * 4 + NBARS * 8;
constexpr float LN2 = 0.6931471805599453f;

// the base-2 bias of a key: 0 valid, -1e9 log2(e) masked, -inf past T
__device__ __forceinline__ float key_bias(const float* mrow, int key, int T) {
  return key < T ? __fmul_rn(__fmul_rn(mrow[key] - 1.0f, 1e9f), LOG2E) : -INFINITY;
}

// rows [r0, r0 + 64) of slice z of a (BH, T, D) tensor into tile x of a slot
__device__ __forceinline__ void load_tile(uint8_t* slot, int x, const CUtensorMap* map,
                                          uint64_t* bar, int r0, int z) {
  tma_load_3d(slot + x * 8192, map, bar, 0, r0, z);
  tma_load_3d(slot + BOX_STRIDE + x * 8192, map, bar, 64, r0, z);
}

// K-major operand of tile x (from x = 0 with N = 128: both tiles), k step kk
__device__ __forceinline__ uint64_t kdesc(const uint8_t* slot, int x, int kk) {
  return sw128_desc(slot + (kk >> 2) * BOX_STRIDE + x * 8192 + (kk & 3) * 32, 16, 1024);
}

// rows [16 kk, 16 kk + 16) of tile x as the K of a product whose N is the
// tile's 128 columns: MN-major, read through the transpose bit
__device__ __forceinline__ uint64_t mndesc(const uint8_t* slot, int x, int kk) {
  return sw128_desc(slot + x * 8192 + kk * 2048, BOX_STRIDE, 1024);
}

// keep the compiler from reusing a register A operand before wgmma is done
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// an accumulator of 64 rows x 16 k (columns 16 kk..) as register A operands
// of the next product, rounded to bf16
template <int R>
__device__ __forceinline__ void to_frag(uint32_t (&a)[4][4], const float (&d)[R]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[kk][q] = pack_bf16(d[8 * kk + 2 * q], d[8 * kk + 2 * q + 1]);
}

// scores of NJ groups of 8 keys in base 2: s log2(e) = dot scale log2(e) +
// bias log2(e), with the bias from the stage's vector
template <int NJ>
__device__ __forceinline__ void add_bias(float (&s)[4 * NJ], const float* vec, int cq,
                                         float scale2) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(vec + 8 * j + cq);
    s[4 * j] = fmaf(s[4 * j], scale2, b.x);
    s[4 * j + 1] = fmaf(s[4 * j + 1], scale2, b.y);
    s[4 * j + 2] = fmaf(s[4 * j + 2], scale2, b.x);
    s[4 * j + 3] = fmaf(s[4 * j + 3], scale2, b.y);
  }
}

__device__ __forceinline__ void init_bars(uint64_t* bars) {
  mbar_init(&bars[0], 1);
  for (int s = 0; s < 2; ++s) {
    mbar_init(&bars[1 + s], 32);   // the producer warp's lanes
    mbar_init(&bars[3 + s], 4);    // the consumer's warps
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the consumer is done with stage s (every lane's reads of it included)
__device__ __forceinline__ void release(uint64_t* bars, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&bars[3 + s]);
}

// grid (ceil(T / 64), BH): 64 queries a block against all keys.  Items
// 0..n1-1 are pass 1's 128-key steps (two K tiles), then pass 2's 64-key
// tiles (K in tile a, V in tile b)
__global__ void __launch_bounds__(WG_THREADS, 2)
fwd_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, const float* __restrict__ mask,
         float* __restrict__ out, float* __restrict__ lse, int T, int D, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* stages = smem + TILE;
  float* vecs = reinterpret_cast<float*>(stages + 2 * SLOT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(vecs + 2 * VEC);
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int n1 = (T + 127) / 128, items = n1 + (T + 63) / 64;

  if (threadIdx.x == 0) init_bars(bars);
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one warp; the rest of its warpgroup only gives registers back
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x >= 160) return;
    const int lane = threadIdx.x & 31;
    const float* mrow = mask + static_cast<size_t>(bh) * T;
    if (lane == 0) {
      mbar_expect_tx(&bars[0], TILE);
      tma_load_3d(qs, &qmap, &bars[0], 0, q0, bh);
      tma_load_3d(qs + 8192, &qmap, &bars[0], 64, q0, bh);
    }
    for (int i = 0; i < items; ++i) {
      const int s = i & 1;
      const bool pass1 = i < n1;
      const int kv0 = pass1 ? 128 * i : 64 * (i - n1);
      float b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) b[e] = key_bias(mrow, kv0 + lane + 32 * e, T);
      if (i >= 2) mbar_wait(&bars[3 + s], ((i >> 1) - 1) & 1);
      float* vec = vecs + s * VEC;
#pragma unroll
      for (int e = 0; e < 4; ++e) vec[lane + 32 * e] = b[e];
      if (lane == 0) {
        uint8_t* st = stages + s * SLOT;
        mbar_expect_tx(&bars[1 + s], SLOT);
        load_tile(st, 0, &kmap, &bars[1 + s], kv0, bh);
        if (pass1) load_tile(st, 1, &kmap, &bars[1 + s], kv0 + 64, bh);
        else load_tile(st, 1, &vmap, &bars[1 + s], kv0, bh);
      } else {
        mbar_arrive(&bars[1 + s]);
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, cq = (lane & 3) * 2;
  const float scale2 = scale * LOG2E;
  mbar_wait(&bars[0], 0);

  // pass 1: base-2 row max and sum of 2^(s - m) over all keys, 128 a step
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < n1; ++i) {
    const int s = i & 1;
    mbar_wait(&bars[1 + s], (i >> 1) & 1);
    const uint8_t* st = stages + s * SLOT;
    float sc[64];
    zero(sc);
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<128>(sc, sw128_desc(qs + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024),
                    kdesc(st, 0, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    add_bias<16>(sc, vecs + s * VEC, cq, scale2);
    release(bars, s, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2[h], mx);       // finite: key 0 is in every row
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sum += ex2(sc[4 * j + 2 * h] - m_new) + ex2(sc[4 * j + 2 * h + 1] - m_new);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * ex2(m2[h] - m_new) + sum;
      m2[h] = m_new;
    }
  }

  // pass 2: O += cd(2^(s - m)) V, 64 keys a step, P never leaves registers
  float acc[DP / 2];
  zero(acc);
  for (int i = n1; i < items; ++i) {
    const int s = i & 1;
    mbar_wait(&bars[1 + s], (i >> 1) & 1);
    const uint8_t* st = stages + s * SLOT;
    float sc[32];
    zero(sc);
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<64>(sc, sw128_desc(qs + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024),
                   kdesc(st, 0, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    add_bias<8>(sc, vecs + s * VEC, cq, scale2);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[4 * j + e] = ex2(sc[4 * j + e] - m2[e >> 1]);
    uint32_t pa[4][4];
    to_frag(pa, sc);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<128>(acc, pa[kk], mndesc(st, 1, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_frag(pa);
    release(bars, s, lane);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * h;
    if (row >= T) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    float* orow = out + (static_cast<size_t>(bh) * T + row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + cq;
      if (c < D)
        *reinterpret_cast<float2*>(orow + c) =
            make_float2(acc[4 * j + 2 * h] / lc, acc[4 * j + 2 * h + 1] / lc);
    }
    if ((lane & 3) == 0) lse[static_cast<size_t>(bh) * T + row] = m2[h] * LN2 + logf(lc);
  }
}

// delta = rowsum(do * out) from the fp32 do and out, and do rounded to bf16;
// 16 threads a row, 8 columns a thread (D % 8 == 0, D <= 128)
__global__ void __launch_bounds__(256)
bwd_prep_bf16(const float* __restrict__ dout, const float* __restrict__ out,
              float* __restrict__ delta, bf16* __restrict__ dout_b, int rows, int D) {
  const int row = blockIdx.x * 16 + (threadIdx.x >> 4), c = (threadIdx.x & 15) * 8;
  float s = 0.f;
  if (row < rows && c < D) {
    const size_t i = static_cast<size_t>(row) * D + c;
    const float4 d0 = *reinterpret_cast<const float4*>(dout + i);
    const float4 d1 = *reinterpret_cast<const float4*>(dout + i + 4);
    const float4 o0 = *reinterpret_cast<const float4*>(out + i);
    const float4 o1 = *reinterpret_cast<const float4*>(out + i + 4);
    s = d0.x * o0.x + d0.y * o0.y + d0.z * o0.z + d0.w * o0.w +
        d1.x * o1.x + d1.y * o1.y + d1.z * o1.z + d1.w * o1.w;
    uint4 h;
    h.x = pack_bf16(d0.x, d0.y);
    h.y = pack_bf16(d0.z, d0.w);
    h.z = pack_bf16(d1.x, d1.y);
    h.w = pack_bf16(d1.z, d1.w);
    *reinterpret_cast<uint4*>(dout_b + i) = h;
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && (threadIdx.x & 15) == 0) delta[row] = s;
}

// role 0: dK, dV of the keys [r0, r0 + 64) (K in tile a, V in tile b of the
// resident slot) over the query tiles (Q in a, dO in b of each stage, their
// base-2 lse and delta in the stage's vector; lse +inf past T)
__device__ __forceinline__ void dkdv_consumer(const uint8_t* res, const uint8_t* stages,
                                              const float* vecs, uint64_t* bars,
                                              const float* mrow, bf16* dk, bf16* dv,
                                              int r0, int n, int T, int D, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, cq = (lane & 3) * 2;
  const float scale2 = scale * LOG2E;
  float kb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kb[h] = key_bias(mrow, r0 + warp * 16 + (lane >> 2) + 8 * h, T);
  mbar_wait(&bars[0], 0);
  float dka[DP / 2], dva[DP / 2];
  zero(dka);
  zero(dva);
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    mbar_wait(&bars[1 + s], (i >> 1) & 1);
    const uint8_t* st = stages + s * SLOT;
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<64>(sc, kdesc(res, 0, kk), kdesc(st, 0, kk));
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<64>(dp, kdesc(res, 1, kk), kdesc(st, 1, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const float2* qv = reinterpret_cast<const float2*>(vecs + s * VEC);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 x = qv[8 * j + cq + e];     // (lse log2(e), delta) of the query
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int idx = 4 * j + 2 * h + e;
          const float p = ex2(fmaf(sc[idx], scale2, kb[h]) - x.x);
          dp[idx] = p * (dp[idx] - x.y) * scale;
          sc[idx] = p;
        }
      }
    uint32_t pa[4][4], pd[4][4];
    to_frag(pa, sc);
    to_frag(pd, dp);
    fence_regs(dva);
    fence_regs(dka);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<128>(dva, pa[kk], mndesc(st, 1, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<128>(dka, pd[kk], mndesc(st, 0, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_frag(pa);
    fence_frag(pd);
    release(bars, s, lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + (lane >> 2) + 8 * h;
    if (row >= T) continue;
    bf16* krow = dk + static_cast<size_t>(row) * D;
    bf16* vrow = dv + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + cq;
      if (c < D) {
        *reinterpret_cast<__nv_bfloat162*>(krow + c) =
            __floats2bfloat162_rn(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(vrow + c) =
            __floats2bfloat162_rn(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
      }
    }
  }
}

// role 1: dQ of the queries [r0, r0 + 64) (Q in tile a, dO in tile b of the
// resident slot) over the key tiles (K in a, V in b of each stage, their
// base-2 biases in the stage's vector)
__device__ __forceinline__ void dq_consumer(const uint8_t* res, const uint8_t* stages,
                                            const float* vecs, uint64_t* bars,
                                            const float* lrow, const float* drow, bf16* dq,
                                            int r0, int n, int T, int D, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, cq = (lane & 3) * 2;
  const float scale2 = scale * LOG2E;
  float l2[2], de[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + (lane >> 2) + 8 * h;
    l2[h] = row < T ? __fmul_rn(lrow[row], LOG2E) : INFINITY;
    de[h] = row < T ? drow[row] : 0.f;
  }
  mbar_wait(&bars[0], 0);
  float dqa[DP / 2];
  zero(dqa);
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    mbar_wait(&bars[1 + s], (i >> 1) & 1);
    const uint8_t* st = stages + s * SLOT;
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<64>(sc, kdesc(res, 0, kk), kdesc(st, 0, kk));
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<64>(dp, kdesc(res, 1, kk), kdesc(st, 1, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    add_bias<8>(sc, vecs + s * VEC, cq, scale2);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, idx = 4 * j + e;
        dp[idx] = ex2(sc[idx] - l2[h]) * (dp[idx] - de[h]) * scale;
      }
    uint32_t pd[4][4];
    to_frag(pd, dp);
    fence_regs(dqa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<128>(dqa, pd[kk], mndesc(st, 0, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(dqa);
    fence_frag(pd);
    release(bars, s, lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + (lane >> 2) + 8 * h;
    if (row >= T) continue;
    bf16* qrow = dq + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + cq;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(qrow + c) =
            __floats2bfloat162_rn(dqa[4 * j + 2 * h], dqa[4 * j + 2 * h + 1]);
    }
  }
}

// grid (ceil(T / 64), BH, 2): z = 0 the dK/dV role of a key tile, z = 1 the
// dQ role of a query tile; delta and dout_b come from bwd_prep_bf16
__global__ void __launch_bounds__(WG_THREADS, 2)
bwd_bf16(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
         const float* __restrict__ mask, const float* __restrict__ lse,
         const float* __restrict__ delta, bf16* __restrict__ dq, bf16* __restrict__ dk,
         bf16* __restrict__ dv, int T, int D, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* res = smem;                   // role 0: K | V; role 1: Q | dO
  uint8_t* stages = smem + SLOT;         // role 0: Q | dO; role 1: K | V
  float* vecs = reinterpret_cast<float*>(stages + 2 * SLOT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(vecs + 2 * VEC);
  const bool keys = blockIdx.z == 0;
  const int bh = blockIdx.y, r0 = blockIdx.x * ROWS, n = (T + ROWS - 1) / ROWS;
  const size_t base = static_cast<size_t>(bh) * T;

  if (threadIdx.x == 0) init_bars(bars);
  __syncthreads();

  if (threadIdx.x >= 128) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x >= 160) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(&bars[0], SLOT);
      load_tile(res, 0, keys ? &kmap : &qmap, &bars[0], r0, bh);
      load_tile(res, 1, keys ? &vmap : &dmap, &bars[0], r0, bh);
    }
    for (int i = 0; i < n; ++i) {
      const int s = i & 1, c0 = i * ROWS;
      // two entries a lane: the queries' (lse log2(e), delta), +inf and 0
      // past T (role 0), or the keys' biases (role 1)
      float2 x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = c0 + 2 * lane + e;
        if (keys)
          x[e] = r < T ? make_float2(__fmul_rn(lse[base + r], LOG2E), delta[base + r])
                       : make_float2(INFINITY, 0.f);
        else
          x[e].x = key_bias(mask + base, r, T);
      }
      if (i >= 2) mbar_wait(&bars[3 + s], ((i >> 1) - 1) & 1);
      float* vec = vecs + s * VEC;
      if (keys) {
        reinterpret_cast<float2*>(vec)[2 * lane] = x[0];
        reinterpret_cast<float2*>(vec)[2 * lane + 1] = x[1];
      } else {
        vec[2 * lane] = x[0].x;
        vec[2 * lane + 1] = x[1].x;
      }
      if (lane == 0) {
        uint8_t* st = stages + s * SLOT;
        mbar_expect_tx(&bars[1 + s], SLOT);
        load_tile(st, 0, keys ? &qmap : &kmap, &bars[1 + s], c0, bh);
        load_tile(st, 1, keys ? &dmap : &vmap, &bars[1 + s], c0, bh);
      } else {
        mbar_arrive(&bars[1 + s]);
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  if (keys)
    dkdv_consumer(res, stages, vecs, bars, mask + base, dk + base * D, dv + base * D, r0, n, T,
                  D, scale);
  else
    dq_consumer(res, stages, vecs, bars, lse + base, delta + base, dq + base * D, r0, n, T, D,
                scale);
}

// ------------------------------------------------------- fp32: plain FMA

__device__ __forceinline__ float score(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// delta = rowsum(do * out) (fp32); one warp per row
__global__ void __launch_bounds__(THREADS)
bwd_delta(const float* __restrict__ dout, const float* __restrict__ out, float* __restrict__ delta,
          int rows, int D) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* d = dout + (size_t)row * D;
  const float* o = out + (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += d[c] * o[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}


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

bool flash_map(CUtensorMap* map, const void* ptr, int BH, int T, int D) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)T, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)T * D * 2};
  return bf16_map(map, ptr, 3, dims, strides, ROWS);
}

}  // namespace

extern "C" {

const char* mtts_flash_error_string(int e) {
  if (e == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled is unavailable or refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Forward.  q, k, v: (BH, T, D) bf16 (is_bf16) or fp32, 16-byte aligned;
// mask: (BH, T) fp32 {0, 1}; out: (BH, T, D) fp32; lse: (BH, T) fp32.
// D <= 128, and a multiple of 8 for bf16.  Returns the first CUDA error (0
// on success); one launch on `stream`.
int mtts_flash_fwd(const void* q, const void* k, const void* v, const float* mask, float* out,
                   float* lse, int BH, int T, int D, int is_bf16, float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (D > DP || D < 1 || (is_bf16 && D % 8)) return cudaErrorInvalidValue;
  if (is_bf16) {
    static bool attr[64] = {false};
    const cudaError_t e = set_smem_once(fwd_bf16, FWD_SMEM, attr);
    if (e != cudaSuccess) return e;
    CUtensorMap qm, km, vm;
    if (!flash_map(&qm, q, BH, T, D) || !flash_map(&km, k, BH, T, D) ||
        !flash_map(&vm, v, BH, T, D))
      return ERR_TENSOR_MAP;
    fwd_bf16<<<dim3((T + ROWS - 1) / ROWS, BH), WG_THREADS, FWD_SMEM, stream>>>(
        qm, km, vm, mask, out, lse, T, D, scale);
  } else {
    dim3 grid((T + 3) / 4, BH);
    fwd_f32<<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, out, lse, T, D, scale);
  }
  return cudaGetLastError();
}

// Backward.  As the forward, plus out, lse from it; dout: (BH, T, D) fp32;
// scratch: delta (BH, T) fp32 and, for bf16, dout_b (BH, T, D) bf16, 16-byte
// aligned; dq, dk, dv: (BH, T, D) in the input dtype.  Two launches (bf16)
// or three (fp32) on `stream`.
int mtts_flash_bwd(const void* q, const void* k, const void* v, const float* mask,
                   const float* out, const float* lse, const float* dout, float* delta,
                   void* dout_b, void* dq, void* dk, void* dv, int BH, int T, int D, int is_bf16,
                   float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (D > DP || D < 1 || (is_bf16 && (D % 8 || !dout_b))) return cudaErrorInvalidValue;
  cudaError_t e;
  const int rows = BH * T;
  if (is_bf16) {
    static bool attr[64] = {false};
    if ((e = set_smem_once(bwd_bf16, BWD_SMEM, attr)) != cudaSuccess) return e;
    CUtensorMap qm, km, vm, dm;
    if (!flash_map(&qm, q, BH, T, D) || !flash_map(&km, k, BH, T, D) ||
        !flash_map(&vm, v, BH, T, D) || !flash_map(&dm, dout_b, BH, T, D))
      return ERR_TENSOR_MAP;
    bwd_prep_bf16<<<(rows + 15) / 16, 256, 0, stream>>>(dout, out, delta,
                                                       static_cast<bf16*>(dout_b), rows, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    bwd_bf16<<<dim3((T + ROWS - 1) / ROWS, BH, 2), WG_THREADS, BWD_SMEM, stream>>>(
        qm, km, vm, dm, mask, lse, delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), T, D, scale);
  } else {
    bwd_delta<<<(rows + 3) / 4, THREADS, 0, stream>>>(dout, out, delta, rows, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
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
