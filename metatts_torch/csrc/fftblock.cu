// Fused FFT block (eval mode) for Hopper, sm_90a.
//
// Replaces the TPU kernel fused_fft_block (Pallas, ops/pallas/fftblock.py
// of the JAX package).  That kernel holds one whole batch row in fast
// memory; on Hopper a block has at most 227 KB of shared memory, while the
// fp32 (T, D) stream at T=1000, D=256 is 1 MB and the k=9 conv weight is
// 4.5 MB.  So the block is split at the points where the TPU kernel already
// rounds to bf16, and every intermediate that goes through device memory
// carries exactly the rounding the TPU kernel applies:
//
//   1. qkv  = bf16(x) @ [Wq|Wk|Wv]^T + b      -> bf16, q scaled by 1/sqrt(d_k)
//   2. o    = softmax(q k^T + (valid-1)*1e9) v -> bf16 (P rounded to bf16)
//   3. x1   = mask * LN(bf16(o) @ Wfc^T + b + x)          -> fp32 and bf16
//   4. hid  = relu(sum_j x1b[t+j-pad] @ W1_j^T + b1)      -> bf16
//   5. out  = mask * LN(hid @ W2^T + b2 + x1)             -> fp32
//
// Bound: at D=256, F=1024, K=9 the block does ~6.8 MFLOP per row and moves
// ~22 MB per (8, 1000) call, so it is bound by tensor-core operations.
// Design: one tiled bf16 GEMM (WMMA 16x16x16, fp32 accumulate) with a
// taps parameter (the k=9 conv is a GEMM whose A rows are read shifted,
// zero outside [0, T) of the same batch row) and three epilogues, plus one
// attention kernel that takes two passes over the keys (row max and sum,
// then normalised P @ V), which reproduces the TPU kernel's rounding of the
// normalised P.  A simple kernel that is right; wgmma, TMA and keeping hid
// out of device memory are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;
constexpr int BN = 256;       // a LayerNorm epilogue holds a whole row: N <= BN
constexpr int BK = 32;
constexpr int KPAD = BK + 8;   // shared row stride (bf16) of the A and B tiles
constexpr int GEMM_THREADS = 256;

enum { EPI_QKV = 0, EPI_RELU = 1, EPI_LN = 2 };

struct GemmArgs {
  const void* A;      // (M_rows, lda), bf16 or fp32
  int lda;            // row stride of A (elements); also the channel count per tap
  int taps;           // conv taps (1 for a plain GEMM)
  int pad;            // tap offset: row t reads row t + j - pad
  int T;              // rows per batch row (taps never cross batch rows)
  const bf16* W;      // (N, Kd) row-major, Kd = taps * lda
  int M, N, Kd;
  const float* bias;  // (N)
  float scale;        // EPI_QKV: columns < scale_cols are multiplied by scale
  int scale_cols;
  const float* resid; // EPI_LN: (M, N) fp32
  const float* gamma;
  const float* beta;
  const float* mask;  // EPI_LN: (M) {0, 1}
  float* out_f;       // EPI_LN: (M, N) fp32
  bf16* out_b;        // (M, N) bf16 (optional for EPI_LN)
};

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return r;
}

template <bool A_F32, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);        // BM x KPAD
  bf16* Bs = As + BM * KPAD;                        // BN x KPAD
  float* Cs = reinterpret_cast<float*>(smem);       // BM x LDC, after the main loop
  constexpr int LDC = BN + 4;
  constexpr int WN = 4;                             // 2 x 4 warps
  constexpr int WTM = BM / 2, WTN = BN / WN;
  constexpr int FM = WTM / 16, FN = WTN / 16;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < g.Kd; k0 += BK) {
    // A tile: BM x BK in chunks of 8 elements, one chunk per thread
    {
      const int r = tid / (BK / 8), c = (tid % (BK / 8)) * 8;
      const int m = m0 + r, kk = k0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m < g.M && kk < g.Kd) {
        const int j = kk / g.lda, ch = kk - j * g.lda;
        const int b = m / g.T, t = m - b * g.T;
        const int ts = t + j - g.pad;
        if (ts >= 0 && ts < g.T) {
          const size_t off = (size_t)(b * g.T + ts) * g.lda + ch;
          if (A_F32) {
            const float4* p = reinterpret_cast<const float4*>(
                static_cast<const float*>(g.A) + off);
            float v[8];
            *reinterpret_cast<float4*>(v) = p[0];
            *reinterpret_cast<float4*>(v + 4) = p[1];
            val = pack8(v);
          } else {
            val = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.A) + off);
          }
        }
      }
      *reinterpret_cast<uint4*>(As + r * KPAD + c) = val;
    }
    // B tile: BN x BK
    for (int i = tid; i < BN * (BK / 8); i += GEMM_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int n = n0 + r, kk = k0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (n < g.N && kk < g.Kd)
        val = *reinterpret_cast<const uint4*>(g.W + (size_t)n * g.Kd + kk);
      *reinterpret_cast<uint4*>(Bs + r * KPAD + c) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * WTM + i * 16) * KPAD + kk, KPAD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wn * WTN + j * 16) * KPAD + kk, KPAD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WTM + i * 16) * LDC + wn * WTN + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  if (EPI == EPI_LN) {
    // one warp per row; the tile holds the whole row (N <= BN, n0 == 0)
    constexpr int PER = BN / 32;
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      const int m = m0 + r;
      if (m >= g.M) continue;
      float v[PER];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        v[i] = 0.f;
        if (c < g.N) {
          v[i] = Cs[r * LDC + c] + g.bias[c] + g.resid[(size_t)m * g.N + c];
          s += v[i];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float mean = s / g.N;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        if (c < g.N) q += (v[i] - mean) * (v[i] - mean);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
      const float rstd = 1.0f / sqrtf(q / g.N + 1e-5f);
      const bool keep = g.mask[m] != 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        if (c < g.N) {
          const float y = keep ? (v[i] - mean) * rstd * g.gamma[c] + g.beta[c] : 0.f;
          g.out_f[(size_t)m * g.N + c] = y;
          if (g.out_b) g.out_b[(size_t)m * g.N + c] = __float2bfloat16_rn(y);
        }
      }
    }
  } else {
    for (int i = tid; i < BM * BN; i += GEMM_THREADS) {
      const int r = i / BN, c = i % BN;
      const int m = m0 + r, n = n0 + c;
      if (m >= g.M || n >= g.N) continue;
      float v = Cs[r * LDC + c] + g.bias[n];
      if (EPI == EPI_QKV) {
        if (n < g.scale_cols) v *= g.scale;
      } else {
        v = fmaxf(v, 0.f);
      }
      g.out_b[(size_t)m * g.N + n] = __float2bfloat16_rn(v);
    }
  }
}

constexpr int GEMM_SMEM = (BM * KPAD + BN * KPAD) * 2 > BM * (BN + 4) * 4
                              ? (BM * KPAD + BN * KPAD) * 2
                              : BM * (BN + 4) * 4;

template <bool A_F32, int EPI>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  if (EPI == EPI_LN && g.N > BN) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gemm_kernel<A_F32, EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  gemm_kernel<A_F32, EPI><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(g);
  return cudaGetLastError();
}

// ------------------------------------------------------------- attention

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int ATT_THREADS = 128;   // 4 warps x 16 query rows
constexpr int DKP = 128;           // head width of the tiles; d_k <= DKP, zero-padded

struct AttnSmem {
  static constexpr int LDQ = DKP + 8;
  static constexpr int LDS = (BKV > DKP ? BKV : DKP) + 4;
  static constexpr int LDP = BKV + 8;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BQ * LDQ * 2;
  static constexpr int v_off = k_off + BKV * LDQ * 2;
  static constexpr int s_off = v_off + BKV * LDQ * 2;
  static constexpr int p_off = s_off + 4 * 16 * LDS * 4;
  static constexpr int bytes = p_off + 4 * 16 * LDP * 2;
};

// rows [r0, r0 + 64) of one head's columns (col0 .. col0 + dk) into a
// zero-padded (64, DKP) shared tile
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int r0, int T,
                                          int ld, int col0, int dk) {
  constexpr int LDQ = DKP + 8;
  for (int i = threadIdx.x; i < 64 * (DKP / 8); i += ATT_THREADS) {
    const int r = i / (DKP / 8), c = (i % (DKP / 8)) * 8;
    const int t = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < T && c < dk)
      val = *reinterpret_cast<const uint4*>(base + (size_t)t * ld + col0 + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = val;
  }
}

__device__ __forceinline__ void scores(const bf16* Qw, const bf16* Ks, float* Sw) {
  constexpr int LDQ = DKP + 8, LDS = AttnSmem::LDS;
#pragma unroll
  for (int j = 0; j < BKV / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
    wmma::fill_fragment(s, 0.0f);
#pragma unroll
    for (int kk = 0; kk < DKP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Qw + kk, LDQ);
      wmma::load_matrix_sync(b, Ks + j * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(s, a, b, s);
    }
    wmma::store_matrix_sync(Sw + j * 16, s, LDS, wmma::mem_row_major);
  }
}

// qkv: (B*T, 3*H*dk) bf16, q already scaled; mask: (B*T) {0, 1};
// o: (B*T, H*dk) bf16.  grid (ceil(T/64), H, B).
__global__ void __launch_bounds__(ATT_THREADS) attn_kernel(const bf16* __restrict__ qkv,
                                                           const float* __restrict__ mask,
                                                           bf16* __restrict__ o,
                                                           int T, int H, int dk) {
  using L = AttnSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * L::LDS;
  bf16* Pw = reinterpret_cast<bf16*>(smem + L::p_off) + warp * 16 * L::LDP;
  const bf16* Qw = Qs + warp * 16 * L::LDQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * dk, ld = 3 * D;
  const bf16* base = qkv + (size_t)b * T * ld;
  const float* mrow = mask + (size_t)b * T;

  load_tile(Qs, base, q0, T, ld, h * dk, dk);

  // each lane owns half of one query row: row rr, columns c0 .. c0 + 32
  const int rr = lane >> 1, c0 = (lane & 1) * 32;
  float m_run = -INFINITY, l_run = 0.f;

  // pass 1: row max and sum of exp over all T keys
  for (int kv0 = 0; kv0 < T; kv0 += BKV) {
    __syncthreads();
    load_tile(Ks, base, kv0, T, ld, D + h * dk, dk);
    __syncthreads();
    scores(Qw, Ks, Sw);
    __syncwarp();
    float s[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int key = kv0 + c0 + c;
      s[c] = key < T ? Sw[rr * L::LDS + c0 + c] + (mrow[key] - 1.0f) * 1e9f : -INFINITY;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) sum += expf(s[c] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
    __syncwarp();
  }

  // pass 2: P = exp(s - m) / l rounded to bf16, O += P @ V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DKP / 16];
#pragma unroll
  for (int j = 0; j < DKP / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int kv0 = 0; kv0 < T; kv0 += BKV) {
    __syncthreads();
    load_tile(Ks, base, kv0, T, ld, D + h * dk, dk);
    load_tile(Vs, base, kv0, T, ld, 2 * D + h * dk, dk);
    __syncthreads();
    scores(Qw, Ks, Sw);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int key = kv0 + c0 + c;
      float p = 0.f;
      if (key < T) {
        const float s = Sw[rr * L::LDS + c0 + c] + (mrow[key] - 1.0f) * 1e9f;
        p = expf(s - m_run) / l_run;
      }
      Pw[rr * L::LDP + c0 + c] = __float2bfloat16_rn(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Pw + kk, L::LDP);
#pragma unroll
      for (int j = 0; j < DKP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> v;
        wmma::load_matrix_sync(v, Vs + kk * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(acc[j], a, v, acc[j]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < DKP / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, acc[j], L::LDS, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * DKP; i += 32) {
    const int r = i / DKP, c = i % DKP;
    const int t = q0 + warp * 16 + r;
    if (t < T && c < dk)
      o[((size_t)b * T + t) * D + h * dk + c] = __float2bfloat16_rn(Sw[r * L::LDS + c]);
  }
}

cudaError_t launch_attn(const bf16* qkv, const float* mask, bf16* o, int B, int T, int H,
                        int dk, cudaStream_t stream) {
  constexpr int smem = AttnSmem::bytes;
  cudaError_t e = cudaFuncSetAttribute(attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  attn_kernel<<<grid, ATT_THREADS, smem, stream>>>(qkv, mask, o, T, H, dk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mtts_error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// One eval-mode FFT block.  All pointers are device pointers; weights are
// bf16, biases, LayerNorm parameters, mask and the fp32 streams are fp32.
// Scratch buffers (qkv, o, x1, x1b, hid) are allocated by the caller.
// Returns the first CUDA error (0 on success); launches on `stream`.
int mtts_fft_block(const float* x, const float* mask,
                   const void* w_qkv, const float* b_qkv,
                   const void* w_fc, const float* b_fc,
                   const float* ln1_w, const float* ln1_b,
                   const void* w1, const float* b1,
                   const void* w2, const float* b2,
                   const float* ln2_w, const float* ln2_b,
                   void* qkv, void* o, float* x1, void* x1b, void* hid, float* out,
                   int B, int T, int D, int H, int F, int K, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = B * T, dk = D / H;
  cudaError_t e;

  GemmArgs g = {};
  g.T = T;
  g.M = M;
  g.taps = 1;
  g.pad = 0;

  // 1. qkv = bf16(x) @ Wqkv^T + b, q scaled
  g.A = x; g.lda = D; g.W = static_cast<const bf16*>(w_qkv); g.N = 3 * D; g.Kd = D;
  g.bias = b_qkv; g.scale = 1.0f / sqrtf((float)dk); g.scale_cols = D;
  g.out_b = static_cast<bf16*>(qkv);
  if ((e = launch_gemm<true, EPI_QKV>(g, stream)) != cudaSuccess) return e;

  // 2. masked attention
  if (dk > DKP || dk % 8) return cudaErrorInvalidValue;
  e = launch_attn(static_cast<const bf16*>(qkv), mask, static_cast<bf16*>(o), B, T, H, dk,
                  stream);
  if (e != cudaSuccess) return e;

  // 3. x1 = mask * LN(o @ Wfc^T + b + x)
  g.A = o; g.lda = D; g.W = static_cast<const bf16*>(w_fc); g.N = D; g.Kd = D;
  g.bias = b_fc; g.resid = x; g.gamma = ln1_w; g.beta = ln1_b; g.mask = mask;
  g.out_f = x1; g.out_b = static_cast<bf16*>(x1b);
  if ((e = launch_gemm<false, EPI_LN>(g, stream)) != cudaSuccess) return e;

  // 4. hid = relu(conv_k(x1b) + b1)
  g.A = x1b; g.lda = D; g.taps = K; g.pad = (K - 1) / 2;
  g.W = static_cast<const bf16*>(w1); g.N = F; g.Kd = K * D;
  g.bias = b1; g.out_b = static_cast<bf16*>(hid);
  if ((e = launch_gemm<false, EPI_RELU>(g, stream)) != cudaSuccess) return e;

  // 5. out = mask * LN(hid @ W2^T + b2 + x1)
  g.A = hid; g.lda = F; g.taps = 1; g.pad = 0;
  g.W = static_cast<const bf16*>(w2); g.N = D; g.Kd = F;
  g.bias = b2; g.resid = x1; g.gamma = ln2_w; g.beta = ln2_b; g.mask = mask;
  g.out_f = out; g.out_b = nullptr;
  if ((e = launch_gemm<false, EPI_LN>(g, stream)) != cudaSuccess) return e;
  return cudaSuccess;
}

}  // extern "C"
