// Fused FFT block (eval mode) for Hopper, sm_90a: wgmma + TMA.
//
// Replaces the TPU kernel fused_fft_block (Pallas, ops/pallas/fftblock.py:93
// of the JAX package, its kernel body _kernel at :42).
// That kernel holds one whole batch row in fast memory; on Hopper a block
// has at most 227 KB of shared memory, while the fp32 (T, D) stream at
// T=1000, D=256 is 1 MB and the k=9 conv weight is 4.5 MB.  So the block is
// split at the points where the TPU kernel already rounds to bf16, and
// every intermediate that goes through device memory carries exactly the
// rounding the TPU kernel applies:
//
//   1. qkv = bf16(x) @ [Wq|Wk|Wv]^T + b      -> bf16, q scaled by 1/sqrt(d_k)
//   2. o   = softmax(q k^T + (valid-1)*1e9) v -> bf16 (P rounded to bf16)
//   3. x1  = mask * LN(bf16(o) @ Wfc^T + b + x)         -> fp32 and bf16
//   4. hid = relu(sum_j x1b[t+j-pad] @ W1_j^T + b1)     -> bf16
//   5. out = mask * LN(hid @ W2^T + b2 + x1)            -> fp32 or bf16
//
// Bound: at B=8, T=1000, D=256, H=2, F=1024, K=9 one call does 54.33 GFLOP
// on 22.2 MB, so it is bound by tensor-core operations (0.0549 ms at 989
// TFLOP/s bf16); the k=9 conv is 37.7 GFLOP of it.  What the design does
// about that bound:
//
// * Every product is wgmma.mma_async (m64nNk16, bf16 in, fp32 accumulate),
//   the only route to the card's full tensor rate, with operands read from
//   shared memory in the 128-byte swizzled layout that TMA writes, so no
//   thread spends an instruction on a tile load or an address.
// * The four GEMMs share one kernel: one thread of a producer warpgroup
//   keeps TMA loads of A and B tiles (64 deep) in flight through a 3-4
//   stage ring tracked by mbarriers, while 1-3 consumer warpgroups issue
//   wgmma and keep one group in flight.  The producer hands its registers
//   to the consumers (setmaxnreg: registers are allocated per warpgroup,
//   so a lone producer warp would cap the consumers at 168 and spill the
//   128-column accumulators).  The tile shape is picked per call so the grid
//   fills the card (128x256 for the conv at B=8, T=1000: 256 tiles; 64x128
//   at B=1 or T=64).
// * A is read through a 3-D tensor map over (B, T, channels) and an M tile
//   never crosses a batch row, so the k-tap conv is one GEMM whose tap j
//   loads the box at row t0 + j - pad: TMA zero-fills rows outside [0, T)
//   of that batch row (negative ones too), which is the SAME padding of the
//   TPU kernel with no index arithmetic in the loop.
// * Epilogues: the accumulators are staged through the free ring in shared
//   memory, then a short rolled loop whose threads each keep one group of
//   8 columns writes 16 bytes at a time: bias and the q scale (QKV,
//   written per head into a zero-padded head-major layout that the
//   attention kernel reads by TMA), bias and ReLU (conv), bias, residual,
//   LayerNorm and mask (the two LN GEMMs: one block owns whole rows of
//   D <= 512 and a warp takes a row; wider rows go through fp32 scratch and
//   a row LayerNorm kernel).  The last one writes fp32 or bf16.
// * Attention: one warpgroup per (batch row, head, 64 queries).  Q.K^T and
//   P.V are wgmma; K and V tiles are double-buffered by TMA; P stays in
//   registers and is the register A operand of P.V, with V read from
//   shared memory by the transpose bit.  The row max and sum come from a
//   first pass over the keys, so the second pass rounds the *normalised* P
//   to bf16 exactly where the TPU kernel does.
// * Host: tensor maps are encoded per call (cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, so no -lcuda), shared-memory attributes are set
//   once per kernel instance and device, and the caller hands in one cached
//   workspace.  Where the time goes: tools/fftblock_ablate.py.
// * The PTX helpers (mbarriers, TMA, wgmma, descriptors, setmaxnreg) and
//   the tensor-map encoder are in hopper.cuh, shared with
//   flash_attention.cu.
//
// Widths: any D % 128 == 0 and d_k = D / H <= 128 (heads are zero-padded
// to 64 or 128 columns), any filter size (the caller pads F to a multiple
// of 128 with zero weights), any T and B.

#include "hopper.cuh"

namespace {

enum { EPI_QKV = 0, EPI_RELU = 1, EPI_PRE = 2, EPI_LN = 3 };

// ------------------------------------------------------------------ GEMM
//
// C (rows of one batch row, N) = sum over taps j of A[b, t + j - pad, :] @
// W[:, j*kc : (j+1)*kc]^T, then an epilogue.  A: (nb, T, kc) bf16, W: (N,
// taps*kc) bf16, both K-major; kc % 64 == 0.

struct GemmArgs {
  int T, nb;               // rows per batch row, batch rows
  int N, kc, taps, pad;    // output columns, A channels per tap, conv taps, tap offset
  int mode;                // EPI_*
  const float* bias;       // (N)
  // EPI_QKV: columns < D scaled; written into (3, nb, H, T, dkp), pad columns 0
  float scale;
  int D, H, dk, dkp;
  bf16* qkv;
  // EPI_RELU: (nb*T, N) bf16
  bf16* out_b;
  // EPI_PRE (fp32 acc + bias + resid into out_f) and EPI_LN
  const void* resid;       // (nb*T, N) fp32, or bf16 when resid_bf16
  int resid_bf16;
  const float* gamma;
  const float* beta;
  const uint8_t* valid;    // (nb*T) {0, 1}
  float* out_f;            // optional
  bf16* out_h;             // optional (EPI_LN)
};

template <int WGM, int WGN, int WN>
struct GemmCfg {
  static constexpr int NC = WGM * WGN;              // consumer warpgroups
  static constexpr int THREADS = 128 * (NC + 1);    // + the producer warpgroup
  // registers a consumer thread gets once the producer gives its own back
  // (setmaxnreg; registers are allocated per warpgroup, 64K an SM)
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS =
      ((65536 - 128 * PRODUCER_REGS) / (128 * NC)) / 8 * 8 > 232
          ? 232 : ((65536 - 128 * PRODUCER_REGS) / (128 * NC)) / 8 * 8;
  static constexpr int BM = 64 * WGM, BN = WN * WGN;
  static constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;   // one 64-deep k step of A and B
  static constexpr int RING = 232448 - 1024 - 2048;
  static constexpr int STAGES = RING / STAGE > 4 ? 4 : RING / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static constexpr int CT = 128 * NC;               // consumer threads
  static constexpr int LDC = BN + 8;                // fp32 row stride of the staged tile
  static_assert(STAGES >= 2, "tile too large for the ring");
  static_assert(BM * LDC * 4 <= STAGES * STAGE, "the staged tile must fit in the ring");
};

// four consecutive values of an fp32 or bf16 row as fp32
__device__ __forceinline__ float4 load4(const void* base, size_t i, int is_bf16) {
  if (is_bf16) {
    const uint2 h = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(base) + i);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int WGM, int WGN, int WN>
__global__ void __launch_bounds__(GemmCfg<WGM, WGN, WN>::THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                const GemmArgs g) {
  using C = GemmCfg<WGM, WGN, WN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;

  const int tiles_t = (g.T + C::BM - 1) / C::BM;
  const int b = blockIdx.y / tiles_t, t0 = (blockIdx.y - b * tiles_t) * C::BM;
  const int n0 = blockIdx.x * C::BN;
  const int kb = g.kc / 64, nk = g.taps * kb;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::NC) {
    // producer warpgroup: one thread keeps the ring full
    if constexpr (C::NC > 1)
      reg_dealloc<C::PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(&empty[s], ((i / C::STAGES) - 1) & 1);
        uint8_t* st = smem + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);
        const int j = i / kb, c0 = (i - j * kb) * 64;
        tma_load_3d(st, &amap, &full[s], c0, t0 + j - g.pad, b);
#pragma unroll
        for (int w = 0; w < WGN; ++w)
          tma_load_2d(st + C::A_BYTES + w * WN * 128, &bmap, &full[s], j * g.kc + c0,
                      n0 + w * WN);
      }
    }
    return;
  }

  // consumer warpgroup (wm, wn): rows 64*wm.., columns WN*wn.. of the tile
  if constexpr (C::NC > 1)
    reg_alloc<C::CONSUMER_REGS>();
  const int wm = wg / WGN, wn = wg - wm * WGN;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % C::STAGES;
    mbar_wait(&full[s], (i / C::STAGES) & 1);
    const uint8_t* at = smem + s * C::STAGE + wm * 8192;
    const uint8_t* bt = smem + s * C::STAGE + C::A_BYTES + wn * WN * 128;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<WN>(acc, sw128_desc(at + kk * 32, 16, 1024), sw128_desc(bt + kk * 32, 16, 1024));
    wg_commit();
    wg_wait<1>();
    fence_regs(acc);
    // the group before this one has finished reading its stage
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % C::STAGES]);
  }
  wg_wait<0>();
  fence_regs(acc);

  // the accumulators go through shared memory (the ring is free once every
  // consumer is past its last k step); then each epilogue is a short rolled
  // loop whose threads write 16 consecutive bytes each
  named_sync(1, C::CT);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float* cs = reinterpret_cast<float*>(smem);
  {
    const int r = wm * 64 + warp * 16 + (lane >> 2), c = wn * WN + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      *reinterpret_cast<float2*>(cs + r * C::LDC + c + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(cs + (r + 8) * C::LDC + c + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  named_sync(1, C::CT);
  const int ctid = threadIdx.x;                       // consumers: 0 .. CT - 1
  const int rows = min(C::BM, g.T - t0);              // tile rows inside the batch row

  if (g.mode == EPI_LN) {
    // a warp a row: bias, residual, mean, variance, scale, mask (N == BN).
    // A lane's columns are the same in every row, so its bias, gamma and
    // beta are read once; each warp takes RB rows at a time, reads all
    // their residuals and masks first and reduces their sums together, so
    // that the reads and the shuffles of the RB rows overlap
    constexpr int PER = C::BN / 128, NW = C::CT / 32;   // float4 a lane
    constexpr int RB = PER <= 2 ? 8 : 4;
    float4 bias[PER], gam[PER], bet[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = 4 * lane + 128 * i;
      bias[i] = *reinterpret_cast<const float4*>(g.bias + c);
      gam[i] = *reinterpret_cast<const float4*>(g.gamma + c);
      bet[i] = *reinterpret_cast<const float4*>(g.beta + c);
    }
    for (int r0 = ctid >> 5; r0 < rows; r0 += RB * NW) {
      float4 v[RB][PER];
      float sum[RB], sq[RB];
      bool keep[RB];
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int r = min(r0 + k * NW, rows - 1);      // rows past the end: a copy
        const size_t m = static_cast<size_t>(b) * g.T + t0 + r;
        keep[k] = g.valid[m] != 0;
        sum[k] = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int c = 4 * lane + 128 * i;
          const float4 a = *reinterpret_cast<const float4*>(cs + r * C::LDC + c);
          const float4 rr = load4(g.resid, m * g.N + c, g.resid_bf16);
          v[k][i] = make_float4(a.x + bias[i].x + rr.x, a.y + bias[i].y + rr.y,
                                a.z + bias[i].z + rr.z, a.w + bias[i].w + rr.w);
          sum[k] += (v[k][i].x + v[k][i].y) + (v[k][i].z + v[k][i].w);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < RB; ++k) sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], o);
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        sum[k] /= g.N;                                   // the mean
        sq[k] = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const float dx = v[k][i].x - sum[k], dy = v[k][i].y - sum[k],
                      dz = v[k][i].z - sum[k], dw = v[k][i].w - sum[k];
          sq[k] += (dx * dx + dy * dy) + (dz * dz + dw * dw);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < RB; ++k) sq[k] += __shfl_xor_sync(0xffffffffu, sq[k], o);
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int r = r0 + k * NW;
        if (r >= rows) continue;
        const size_t m = static_cast<size_t>(b) * g.T + t0 + r;
        const float mean = sum[k], rstd = 1.0f / sqrtf(sq[k] / g.N + 1e-5f);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int c = 4 * lane + 128 * i;
          float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
          if (keep[k]) {
            const float4 u = v[k][i];
            y = make_float4((u.x - mean) * rstd * gam[i].x + bet[i].x,
                            (u.y - mean) * rstd * gam[i].y + bet[i].y,
                            (u.z - mean) * rstd * gam[i].z + bet[i].z,
                            (u.w - mean) * rstd * gam[i].w + bet[i].w);
          }
          if (g.out_f) *reinterpret_cast<float4*>(g.out_f + m * g.N + c) = y;
          if (g.out_h) {
            uint2 h;
            h.x = pack_bf16(y.x, y.y);
            h.y = pack_bf16(y.z, y.w);
            *reinterpret_cast<uint2*>(g.out_h + m * g.N + c) = h;
          }
        }
      }
    }
    return;
  }

  // a thread keeps one group of 8 columns (CT is a multiple of the groups
  // a row), so its bias and head indexing are computed once
  constexpr int G = C::BN / 8;                        // 8-column groups a tile row
  static_assert(C::CT % G == 0, "a thread's columns must not change across rows");
  const int c = (ctid % G) * 8, n = n0 + c;
  if (n < g.N) {
    const float4 b0 = *reinterpret_cast<const float4*>(g.bias + n);
    const float4 b1 = *reinterpret_cast<const float4*>(g.bias + n + 4);
    // EPI_QKV: column n is column c0 of head hh = which * H + head
    int hh = 0, c0 = 0;
    bf16* qdst = nullptr;
    float scale = 1.0f;
    if (g.mode == EPI_QKV) {
      hh = n / g.dk;
      c0 = n - hh * g.dk;
      const int which = hh / g.H, head = hh - which * g.H;
      qdst = g.qkv + ((static_cast<size_t>(which) * g.nb + b) * g.H + head) * g.T * g.dkp + c0;
      if (n < g.D) scale = g.scale;                   // D % 8 == 0: all 8 or none
    }
    for (int r = ctid / G; r < rows; r += C::CT / G) {
      const int t = t0 + r;
      const size_t m = static_cast<size_t>(b) * g.T + t;
      float v[8];
      const float4 a0 = *reinterpret_cast<const float4*>(cs + r * C::LDC + c);
      const float4 a1 = *reinterpret_cast<const float4*>(cs + r * C::LDC + c + 4);
      v[0] = a0.x + b0.x; v[1] = a0.y + b0.y; v[2] = a0.z + b0.z; v[3] = a0.w + b0.w;
      v[4] = a1.x + b1.x; v[5] = a1.y + b1.y; v[6] = a1.z + b1.z; v[7] = a1.w + b1.w;
      if (g.mode == EPI_RELU) {
        uint4 h;
        h.x = pack_bf16(fmaxf(v[0], 0.f), fmaxf(v[1], 0.f));
        h.y = pack_bf16(fmaxf(v[2], 0.f), fmaxf(v[3], 0.f));
        h.z = pack_bf16(fmaxf(v[4], 0.f), fmaxf(v[5], 0.f));
        h.w = pack_bf16(fmaxf(v[6], 0.f), fmaxf(v[7], 0.f));
        *reinterpret_cast<uint4*>(g.out_b + m * g.N + n) = h;
      } else if (g.mode == EPI_PRE) {
        const float4 r0 = load4(g.resid, m * g.N + n, g.resid_bf16);
        const float4 r1 = load4(g.resid, m * g.N + n + 4, g.resid_bf16);
        *reinterpret_cast<float4*>(g.out_f + m * g.N + n) =
            make_float4(v[0] + r0.x, v[1] + r0.y, v[2] + r0.z, v[3] + r0.w);
        *reinterpret_cast<float4*>(g.out_f + m * g.N + n + 4) =
            make_float4(v[4] + r1.x, v[5] + r1.y, v[6] + r1.z, v[7] + r1.w);
      } else if (g.dk % 8 == 0) {                     // EPI_QKV, the 8 columns in one head
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= scale;
        uint4 h;
        h.x = pack_bf16(v[0], v[1]);
        h.y = pack_bf16(v[2], v[3]);
        h.z = pack_bf16(v[4], v[5]);
        h.w = pack_bf16(v[6], v[7]);
        *reinterpret_cast<uint4*>(qdst + static_cast<size_t>(t) * g.dkp) = h;
      } else {                                        // EPI_QKV, heads narrower than 8
        int eh = hh, ec = c0;
        for (int e = 0; e < 8; ++e) {
          const int ew = eh / g.H, ehd = eh - ew * g.H;
          g.qkv[(((static_cast<size_t>(ew) * g.nb + b) * g.H + ehd) * g.T + t) * g.dkp + ec] =
              __float2bfloat16_rn(v[e] * scale);
          if (++ec == g.dk) {
            ec = 0;
            ++eh;
          }
        }
      }
    }
  }
  if (g.mode == EPI_QKV && g.dk < g.dkp) {
    // zero the pad columns [dk, dkp) of every head whose last column lies
    // in this tile, for its rows (the workspace is reused across shapes)
    const int c_hi = min(n0 + C::BN, g.N);
    const int h_lo = n0 / g.dk, nh = c_hi / g.dk - h_lo, npad = g.dkp - g.dk;
    for (int i = ctid; i < nh * rows * npad; i += C::CT) {
      const int hh = h_lo + i / (rows * npad), r = (i / npad) % rows, c = g.dk + i % npad;
      const int which = hh / g.H, head = hh - which * g.H;
      g.qkv[(((static_cast<size_t>(which) * g.nb + b) * g.H + head) * g.T + t0 + r) * g.dkp + c] =
          __float2bfloat16_rn(0.f);
    }
  }
}

// -------------------------------------------------------------- attention
//
// qkv: (3, nb, H, T, DKP) bf16 through a 3-D tensor map (DKP, T, 3*nb*H),
// q scaled, head columns past d_k zero; valid: (nb*T); o: (nb*T, H*dk)
// bf16.  grid (ceil(T/64), H, nb), one warpgroup a block.

template <int DKP>
struct AttnCfg {
  static constexpr int BOXES = DKP / 64;            // 64-column boxes of 8 KB per tile
  static constexpr int TILE = 64 * DKP * 2;         // one 64-row tile
  // a stage holds two 64-row tiles, box by box: [box 0 of tile a | box 0 of
  // tile b | box 1 of a | box 1 of b]; pass 2 puts K and V there, pass 1 two
  // consecutive K tiles, which are then one 128-row operand
  static constexpr int BOX_STRIDE = 2 * 8192;
  static constexpr int SMEM = 1024 + 5 * TILE + 3 * 8;   // Q, two stages, barriers
};

// item i < n1: keys [128 i, 128 i + 128) for pass 1; else key tile i - n1
// (64 keys) with its V for pass 2
template <int DKP>
__device__ __forceinline__ void attn_issue(int i, int n1, const CUtensorMap* map, uint8_t* smem,
                                           uint64_t* bars, int zk, int zv) {
  using C = AttnCfg<DKP>;
  const int s = i & 1;
  uint8_t* st = smem + (1 + 2 * s) * C::TILE;
  const bool pass1 = i < n1;
  const int kv0 = pass1 ? 128 * i : 64 * (i - n1);
  mbar_expect_tx(&bars[1 + s], 2 * C::TILE);
#pragma unroll
  for (int c = 0; c < C::BOXES; ++c) {
    tma_load_3d(st + c * C::BOX_STRIDE, map, &bars[1 + s], c * 64, kv0, zk);
    tma_load_3d(st + c * C::BOX_STRIDE + 8192, map, &bars[1 + s], c * 64,
                pass1 ? kv0 + 64 : kv0, pass1 ? zk : zv);
  }
}

// s = Q K^T for NK keys (64 or 128), with the keys' bias: 0 valid, -1e9
// masked, -inf past T (no such key)
template <int DKP, int NK>
__device__ __forceinline__ void attn_scores(float (&s)[NK / 2], const uint8_t* qs,
                                            const uint8_t* ks, const uint8_t* vrow, int kv0,
                                            int T, int cq) {
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk)
    wgmma_ss<NK>(s, sw128_desc(qs + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024),
                 sw128_desc(ks + (kk >> 2) * AttnCfg<DKP>::BOX_STRIDE + (kk & 3) * 32, 16, 1024));
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = kv0 + 8 * j + cq + e;
      const float bias = key < T ? (vrow[key] ? 0.f : -1e9f) : -INFINITY;
      s[4 * j + e] += bias;
      s[4 * j + 2 + e] += bias;
    }
  }
}

template <int DKP>
__global__ void __launch_bounds__(128) attn_kernel(const __grid_constant__ CUtensorMap map,
                                                   const uint8_t* __restrict__ valid,
                                                   bf16* __restrict__ o, int nb, int T, int H,
                                                   int dk) {
  using C = AttnCfg<DKP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 5 * C::TILE);   // Q, stage 0, stage 1
  const int q0 = blockIdx.x * 64, head = blockIdx.y, b = blockIdx.z;
  const int zq = b * H + head, zk = (nb + b) * H + head, zv = (2 * nb + b) * H + head;
  // pass 1 reads the keys 128 at a time, pass 2 64 at a time with V
  const int n1 = (T + 127) / 128, nkv = (T + 63) / 64, items = n1 + nkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto stage = [&](int i) { return smem + (1 + 2 * (i & 1)) * C::TILE; };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], C::TILE);
#pragma unroll
    for (int c = 0; c < C::BOXES; ++c) tma_load_3d(smem + c * 8192, &map, &bars[0], c * 64, q0, zq);
    attn_issue<DKP>(0, n1, &map, smem, bars, zk, zv);
    attn_issue<DKP>(1, n1, &map, smem, bars, zk, zv);   // items >= 2: T >= 1
  }
  mbar_wait(&bars[0], 0);

  const int cq = (lane & 3) * 2;
  const uint8_t* vrow = valid + static_cast<size_t>(b) * T;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // pass 1: row max and sum of exp over all keys, 128 at a time
  for (int i = 0; i < n1; ++i) {
    float s[64];
    mbar_wait(&bars[1 + (i & 1)], (i >> 1) & 1);
    attn_scores<DKP, 128>(s, smem, stage(i), vrow, 128 * i, T, cq);
    named_sync(1, 128);                               // every warp is done with the stage
    if (tid == 0 && i + 2 < items) attn_issue<DKP>(i + 2, n1, &map, smem, bars, zk, zv);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx), mb = m_new * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sum += ex2(fmaf(s[4 * j + 2 * h], LOG2E, -mb)) + ex2(fmaf(s[4 * j + 2 * h + 1], LOG2E, -mb));
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = l_run[h] * ex2((m_run[h] - m_new) * LOG2E) + sum;
      m_run[h] = m_new;
    }
  }

  // pass 2: P = exp(s - m) / l = 2^(s log2 e - (m log2 e + log2 l)) rounded
  // to bf16, O += P V
  const float off[2] = {m_run[0] * LOG2E + log2f(l_run[0]), m_run[1] * LOG2E + log2f(l_run[1])};
  float acc[DKP / 2];
#pragma unroll
  for (int i = 0; i < DKP / 2; ++i) acc[i] = 0.f;
  for (int i = n1; i < items; ++i) {
    float s[32];
    mbar_wait(&bars[1 + (i & 1)], (i >> 1) & 1);
    const uint8_t* st = stage(i);
    attn_scores<DKP, 64>(s, smem, st, vrow, (i - n1) * 64, T, cq);
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1, idx = 8 * kk + 2 * q;
        pa[kk][q] = pack_bf16(ex2(fmaf(s[idx], LOG2E, -off[h])),
                              ex2(fmaf(s[idx + 1], LOG2E, -off[h])));
      }
    }
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)     // 16 keys a step; V is (keys, DKP): MN-major
      wgmma_rs<DKP>(acc, pa[kk], sw128_desc(st + 8192 + kk * 2048, C::BOX_STRIDE, 1024));
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    named_sync(1, 128);
    if (tid == 0 && i + 2 < items) attn_issue<DKP>(i + 2, n1, &map, smem, bars, zk, zv);
  }

  const int D = H * dk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q0 + warp * 16 + (lane >> 2) + 8 * h;
    if (t >= T) continue;
    bf16* orow = o + (static_cast<size_t>(b) * T + t) * D + head * dk;
#pragma unroll
    for (int j = 0; j < DKP / 8; ++j) {
      const int c = 8 * j + cq;
      if ((dk & 1) == 0) {
        if (c < dk)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        if (c < dk) orow[c] = __float2bfloat16_rn(acc[4 * j + 2 * h]);
        if (c + 1 < dk) orow[c + 1] = __float2bfloat16_rn(acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------------- small kernels

// out = mask * LN(pre) per row, one warp a row (rows wider than the fused
// LayerNorm epilogue's 512); N % 128 == 0
__global__ void __launch_bounds__(256) ln_rows_kernel(const float* __restrict__ pre,
                                                      const float* __restrict__ gamma,
                                                      const float* __restrict__ beta,
                                                      const uint8_t* __restrict__ valid,
                                                      float* __restrict__ out_f,
                                                      bf16* __restrict__ out_h, int M, int N) {
  const int m = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  const float* row = pre + static_cast<size_t>(m) * N;
  float s = 0.f;
  for (int c = 4 * lane; c < N; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = warp_sum(s) / N;
  float q = 0.f;
  for (int c = 4 * lane; c < N; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    q += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean) +
         (v.z - mean) * (v.z - mean) + (v.w - mean) * (v.w - mean);
  }
  const float rstd = 1.0f / sqrtf(warp_sum(q) / N + 1e-5f);
  const bool keep = valid[m] != 0;
  for (int c = 4 * lane; c < N; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = keep ? (y[e] - mean) * rstd * gamma[c + e] + beta[c + e] : 0.f;
    const size_t i = static_cast<size_t>(m) * N + c;
    if (out_f) *reinterpret_cast<float4*>(out_f + i) = make_float4(y[0], y[1], y[2], y[3]);
    if (out_h) {
      *reinterpret_cast<__nv_bfloat162*>(out_h + i) = __floats2bfloat162_rn(y[0], y[1]);
      *reinterpret_cast<__nv_bfloat162*>(out_h + i + 2) = __floats2bfloat162_rn(y[2], y[3]);
    }
  }
}

// bf16 copy of an fp32 input, 4 values a thread (n % 4 == 0)
__global__ void to_bf16_kernel(const float* __restrict__ x, bf16* __restrict__ y, size_t n) {
  const size_t i = 4 * (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const float4 v = *reinterpret_cast<const float4*>(x + i);
  *reinterpret_cast<__nv_bfloat162*>(y + i) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(y + i + 2) = __floats2bfloat162_rn(v.z, v.w);
}

// ------------------------------------------------------------------ host

template <int WGM, int WGN, int WN>
cudaError_t launch_gemm(const void* A, const void* W, const GemmArgs& g, cudaStream_t st) {
  using C = GemmCfg<WGM, WGN, WN>;
  static bool attr[64] = {false};
  cudaError_t e = set_smem_once(gemm_kernel<WGM, WGN, WN>, C::SMEM, attr);
  if (e != cudaSuccess) return e;
  CUtensorMap amap, bmap;
  const uint64_t adims[3] = {(uint64_t)g.kc, (uint64_t)g.T, (uint64_t)g.nb};
  const uint64_t astr[2] = {(uint64_t)g.kc * 2, (uint64_t)g.T * g.kc * 2};
  const uint64_t bdims[2] = {(uint64_t)g.taps * g.kc, (uint64_t)g.N};
  const uint64_t bstr[1] = {(uint64_t)g.taps * g.kc * 2};
  if (!bf16_map(&amap, A, 3, adims, astr, C::BM) || !bf16_map(&bmap, W, 2, bdims, bstr, WN))
    return static_cast<cudaError_t>(ERR_TENSOR_MAP);
  const dim3 grid((g.N + C::BN - 1) / C::BN, g.nb * ((g.T + C::BM - 1) / C::BM));
  gemm_kernel<WGM, WGN, WN><<<grid, C::THREADS, C::SMEM, st>>>(amap, bmap, g);
  return cudaGetLastError();
}

// a GEMM whose epilogue is per element: the tile shape with the least
// estimated time, ceil(tiles / SMs) waves of (rows x columns / efficiency)
cudaError_t gemm_any(const void* A, const void* W, const GemmArgs& g, cudaStream_t st) {
  struct Tile { int bm, bn; float eff; };
  const Tile tiles[3] = {{128, 256, 1.0f}, {128, 128, 0.85f}, {64, 128, 0.7f}};
  const int sms = sm_count();
  int best = 2;
  float best_cost = 3.4e38f;
  for (int i = 0; i < 3; ++i) {
    if (tiles[i].bn > g.N) continue;
    const long n = (long)((g.N + tiles[i].bn - 1) / tiles[i].bn) * g.nb *
                   ((g.T + tiles[i].bm - 1) / tiles[i].bm);
    const float cost = (float)((n + sms - 1) / sms) * tiles[i].bm * tiles[i].bn / tiles[i].eff;
    if (cost < best_cost) {
      best_cost = cost;
      best = i;
    }
  }
  if (best == 0) return launch_gemm<2, 1, 256>(A, W, g, st);
  if (best == 1) return launch_gemm<2, 1, 128>(A, W, g, st);
  return launch_gemm<1, 1, 128>(A, W, g, st);
}

// out = mask * LN(A @ W^T + bias + resid): the LayerNorm in the epilogue
// while one block can hold a row (D <= 512), else through fp32 scratch
cudaError_t gemm_ln(const void* A, const void* W, GemmArgs g, float* pre, cudaStream_t st) {
  g.mode = EPI_LN;
  switch (g.N) {
    case 128: return launch_gemm<1, 1, 128>(A, W, g, st);
    case 256: return launch_gemm<1, 2, 128>(A, W, g, st);
    case 384: return launch_gemm<1, 3, 128>(A, W, g, st);
    case 512: return launch_gemm<1, 2, 256>(A, W, g, st);
    default: break;
  }
  float* out_f = g.out_f;
  bf16* out_h = g.out_h;
  g.mode = EPI_PRE;
  g.out_f = pre;
  cudaError_t e = gemm_any(A, W, g, st);
  if (e != cudaSuccess) return e;
  const int M = g.nb * g.T;
  ln_rows_kernel<<<(M + 7) / 8, 256, 0, st>>>(pre, g.gamma, g.beta, g.valid, out_f, out_h, M,
                                               g.N);
  return cudaGetLastError();
}

template <int DKP>
cudaError_t launch_attn(const bf16* qkv, const uint8_t* valid, bf16* o, int nb, int T, int H,
                        int dk, cudaStream_t st) {
  using C = AttnCfg<DKP>;
  static bool attr[64] = {false};
  cudaError_t e = set_smem_once(attn_kernel<DKP>, C::SMEM, attr);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  const uint64_t dims[3] = {(uint64_t)DKP, (uint64_t)T, (uint64_t)3 * nb * H};
  const uint64_t str[2] = {(uint64_t)DKP * 2, (uint64_t)T * DKP * 2};
  if (!bf16_map(&map, qkv, 3, dims, str, 64)) return static_cast<cudaError_t>(ERR_TENSOR_MAP);
  const dim3 grid((T + 63) / 64, H, nb);
  attn_kernel<DKP><<<grid, 128, C::SMEM, st>>>(map, valid, o, nb, T, H, dk);
  return cudaGetLastError();
}

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

// scratch regions of one call, byte offsets into the caller's workspace
struct Layout {
  size_t xb, qkv, o, x1, x1b, hid, pre, total;
  Layout(int B, int T, int D, int H, int F, bool x_bf16) {
    const size_t M = (size_t)B * T, dkp = (D / H) <= 64 ? 64 : 128;
    size_t at = 0;
    auto take = [&](size_t bytes) { const size_t here = at; at += align256(bytes); return here; };
    xb = take(x_bf16 ? 0 : M * D * 2);
    qkv = take(3 * M * H * dkp * 2);
    o = take(M * D * 2);
    x1 = take(M * D * 4);
    x1b = take(M * D * 2);
    hid = take(M * F * 2);
    pre = take(D > 512 ? M * D * 4 : 0);
    total = at;
  }
};

}  // namespace

extern "C" {

const char* mtts_error_string(int e) {
  if (e == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled is unavailable or refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// bytes of workspace one call needs; F is the packed (padded) filter size
size_t mtts_fft_block_workspace(int B, int T, int D, int H, int F, int x_bf16) {
  return Layout(B, T, D, H, F, x_bf16 != 0).total;
}

// One eval-mode FFT block, or one of its stages (stage 0..4: QKV,
// attention, out-projection + LN1, conv + ReLU, W2 + LN2; -1: all) on the
// workspace a full call with the same arguments left.  All pointers are
// device pointers: x (B, T, D) bf16 when x_bf16 else fp32; valid (B, T)
// bytes {0, 1}; params the 12 tensors w_qkv (3D, D), b_qkv, w_fc (D, D),
// b_fc, ln1_w, ln1_b, w1 (F, K*D) tap-major, b1, w2 (D, F), b2, ln2_w,
// ln2_b (weights bf16, vectors fp32), F % 128 == 0 (zero-padded); out
// (B, T, D) bf16 when out_bf16 else fp32.  Returns the first CUDA error
// (0 on success); launches on `stream`.
int mtts_fft_block(const void* x, int x_bf16, const uint8_t* valid, const void* const* params,
                   void* ws, void* out, int out_bf16,
                   int B, int T, int D, int H, int F, int K, int stage, void* stream_ptr) {
  const void* w_qkv = params[0];
  const float* b_qkv = static_cast<const float*>(params[1]);
  const void* w_fc = params[2];
  const float* b_fc = static_cast<const float*>(params[3]);
  const float* ln1_w = static_cast<const float*>(params[4]);
  const float* ln1_b = static_cast<const float*>(params[5]);
  const void* w1 = params[6];
  const float* b1 = static_cast<const float*>(params[7]);
  const void* w2 = params[8];
  const float* b2 = static_cast<const float*>(params[9]);
  const float* ln2_w = static_cast<const float*>(params[10]);
  const float* ln2_b = static_cast<const float*>(params[11]);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int dk = D / H, dkp = dk <= 64 ? 64 : 128;
  const size_t M = (size_t)B * T;
  if (D % 128 || D % H || dk > 128 || F % 128 || B * T == 0) return cudaErrorInvalidValue;
  const Layout L(B, T, D, H, F, x_bf16 != 0);
  uint8_t* w = static_cast<uint8_t*>(ws);
  bf16* xb = x_bf16 ? (bf16*)x : (bf16*)(w + L.xb);
  bf16* qkv = (bf16*)(w + L.qkv);
  bf16* o = (bf16*)(w + L.o);
  float* x1 = (float*)(w + L.x1);
  bf16* x1b = (bf16*)(w + L.x1b);
  bf16* hid = (bf16*)(w + L.hid);
  float* pre = (float*)(w + L.pre);
  cudaError_t e = cudaSuccess;

  GemmArgs g = {};
  g.T = T;
  g.nb = B;
  g.taps = 1;
  g.valid = valid;

  if (stage < 0 || stage == 0) {   // qkv = bf16(x) @ Wqkv^T + b, q scaled, per head
    if (!x_bf16) {
      to_bf16_kernel<<<(unsigned)((M * D / 4 + 255) / 256), 256, 0, st>>>(
          static_cast<const float*>(x), xb, M * D);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    GemmArgs q = g;
    q.mode = EPI_QKV; q.N = 3 * D; q.kc = D; q.bias = b_qkv;
    q.scale = 1.0f / sqrtf((float)dk); q.D = D; q.H = H; q.dk = dk; q.dkp = dkp; q.qkv = qkv;
    if ((e = gemm_any(xb, w_qkv, q, st)) != cudaSuccess) return e;
  }
  if (stage < 0 || stage == 1) {   // masked attention
    e = dkp == 64 ? launch_attn<64>(qkv, valid, o, B, T, H, dk, st)
                  : launch_attn<128>(qkv, valid, o, B, T, H, dk, st);
    if (e != cudaSuccess) return e;
  }
  if (stage < 0 || stage == 2) {   // x1 = mask * LN(o @ Wfc^T + b + x)
    GemmArgs l = g;
    l.N = D; l.kc = D; l.bias = b_fc; l.resid = x; l.resid_bf16 = x_bf16;
    l.gamma = ln1_w; l.beta = ln1_b; l.out_f = x1; l.out_h = x1b;
    if ((e = gemm_ln(o, w_fc, l, pre, st)) != cudaSuccess) return e;
  }
  if (stage < 0 || stage == 3) {   // hid = relu(conv_k(x1b) + b1)
    GemmArgs c = g;
    c.mode = EPI_RELU; c.N = F; c.kc = D; c.taps = K; c.pad = (K - 1) / 2;
    c.bias = b1; c.out_b = hid;
    if ((e = gemm_any(x1b, w1, c, st)) != cudaSuccess) return e;
  }
  if (stage < 0 || stage == 4) {   // out = mask * LN(hid @ W2^T + b2 + x1)
    GemmArgs l = g;
    l.N = D; l.kc = F; l.bias = b2; l.resid = x1; l.resid_bf16 = 0;
    l.gamma = ln2_w; l.beta = ln2_b;
    l.out_f = out_bf16 ? nullptr : static_cast<float*>(out);
    l.out_h = out_bf16 ? static_cast<bf16*>(out) : nullptr;
    if ((e = gemm_ln(hid, w2, l, pre, st)) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // extern "C"
