// Log-mel spectrogram and energy in one kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_mel_spectrogram (Pallas, the TPU package's
// ops/pallas/melspec.py: fused_mel_spectrogram, _kernel, _make_constants).
// Per utterance b of y (B, T) fp32:
//
//   x       = y reflect-padded by n_fft/2 on both sides (numpy "reflect",
//             reflecting again where n_fft/2 > T - 1)
//   frame f = x[f*hop : f*hop + n_fft] * window,  f < T/hop + 1 = frames
//             (periodic Hann, centred when win_length < n_fft)
//   X       = real DFT of the frame, bins 0 .. n_fft/2
//   power   = |X|^2,  mag = sqrt(power)
//   mel     = log(max(mel_basis . mag, 1e-5))   -> out_mel (B, n_mels, frames)
//   energy  = sqrt(sum over bins of power)      -> out_en  (B, frames)
//
// Every product and sum is fp32 FMA (no TF32): the TPU test holds the
// log-mel to atol 1e-4, and log magnifies the error of bins near the clamp.
//
// Bound: per frame the window (n_fft), a real FFT (2.5 n_fft log2 n_fft),
// power, magnitude and energy of the n_fft/2 + 1 bins, the filterbank's
// nonzero weights (~1,000 at 1024 / 80) and the log clamp: 31,350 FLOP at
// n_fft 1024, against the fp32 peak outside the tensor cores (67 TFLOP/s);
// bytes are the audio in, the window and nonzero weights, log-mel and energy
// out, against 3.35 TB/s.  At 16 utterances of 10 s that is 0.432 GFLOP and
// 18.6 MB, 6.5 us, set by operations about as much as by bytes; at one
// utterance 0.40 us, below a launch's own latency.
//
// Design: the work the function needs, and enough blocks to fill the card.
// - A real FFT per frame: the n_fft real samples packed as M = n_fft/2
//   complex ones z[n] = x[2n] + i x[2n+1], an M-point complex FFT, then the
//   split step X[k] = E[k] + W_N^k O[k], X[M-k] = conj(E[k] - W_N^k O[k]),
//   with E = (Z[k] + conj Z[M-k]) / 2 and O = -i (Z[k] - conj Z[M-k]) / 2.
//   Bins 0 and M come out of Z[0]; no bin needs a dot product of its own.
// - The M-point FFT is Stockham (self-sorting) in radix-8 passes and one
//   radix-2 or radix-4 pass where log2 M is not a multiple of 3 (M = 512:
//   8 x 8 x 8).  M/8 threads per frame, each holding 8 complex values in
//   registers; the first pass reads the windowed frame straight from the
//   audio span, each later pass is one exchange through shared memory,
//   padded by one float every 8 against bank conflicts.
// - Twiddles (W_M^t for the passes, W_N^k for the split step) and the
//   window are built in float64 on the host, cast once to fp32, and staged
//   in shared memory once per block.
// - 256 threads per block, 2048 / M frames per block (4 at n_fft 1024): one
//   10 s utterance is 216 blocks on 132 SMs.  The block's audio span,
//   (frames - 1) * hop + n_fft samples, is read once into shared memory with
//   the reflect padding in its indexing; the overlapping frame matrix is
//   never built.  The grid is capped at what the card holds at once and
//   each block walks over groups of frames, so the tables are loaded once
//   per block at any batch.
// - The filterbank is sparse: per band its first bin, bin count and
//   weights (a compact table built by the wrapper, ~1,000 weights at
//   1024 / 80), staged in shared memory with the twiddles.  Each thread sums
//   its bands over their own bins; the energy is a warp-shuffle reduction
//   of power.  Log-mel goes through shared memory so each row of the
//   (B, n_mels, frames) output gets the block's frames in one run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_MELS = 128;
constexpr float SQRT1_2 = 0.70710678118654752f;

// shared index of element i of a frame's FFT buffer: one float of padding
// every 8, so the strided stores of the early passes hit distinct banks
__device__ __forceinline__ int pidx(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// forward DFTs in registers, natural order in and out
__device__ __forceinline__ void dft2(float2* v) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 e0 = cadd(a0, a2), e1 = csub(a0, a2), e2 = cadd(a1, a3), d = csub(a1, a3);
  const float2 e3 = make_float2(d.y, -d.x);   // -i (a1 - a3)
  a0 = cadd(e0, e2);
  a2 = csub(e0, e2);
  a1 = cadd(e1, e3);
  a3 = csub(e1, e3);
}

__device__ __forceinline__ void dft8(float2* v) {
  float2 a[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = cadd(v[j], v[j + 4]);
    b[j] = csub(v[j], v[j + 4]);
  }
  // b_j *= W_8^j
  b[1] = make_float2((b[1].x + b[1].y) * SQRT1_2, (b[1].y - b[1].x) * SQRT1_2);
  b[2] = make_float2(b[2].y, -b[2].x);
  b[3] = make_float2((b[3].y - b[3].x) * SQRT1_2, -(b[3].x + b[3].y) * SQRT1_2);
  dft4(a[0], a[1], a[2], a[3]);
  dft4(b[0], b[1], b[2], b[3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = a[j];
    v[2 * j + 1] = b[j];
  }
}

template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 8) dft8(v);
  else if constexpr (R == 4) dft4(v[0], v[1], v[2], v[3]);
  else dft2(v);
}

// One Stockham pass of radix R over an M-point sequence, after p = 2^logp
// points of it are done.  Thread t owns the 8 / R butterflies
// b = t + s * M/8; butterfly b reads in[b + r * M/R] and, after the twiddle
// W_M^(r k M/(pR)) (k = b mod p) and an R-point DFT, writes
// out[(b - k) R + k + r p].  v[s R + r] holds butterfly s's element r.
template <int R, int M>
__device__ __forceinline__ void load_pass(float2 (&v)[8], const float* re, const float* im,
                                          int t) {
#pragma unroll
  for (int s = 0; s < 8 / R; ++s)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = pidx(t + s * (M / 8) + r * (M / R));
      v[s * R + r] = make_float2(re[i], im[i]);
    }
}

template <int R, int LOGM>
__device__ __forceinline__ void twiddle_dft(float2 (&v)[8], const float2* tw, int t, int logp) {
  constexpr int M = 1 << LOGM;
  const int p = 1 << logp;
  const int shift = LOGM - logp - (R == 8 ? 3 : R == 4 ? 2 : 1);
#pragma unroll
  for (int s = 0; s < 8 / R; ++s) {
    const int k = (t + s * (M / 8)) & (p - 1);
#pragma unroll
    for (int r = 1; r < R; ++r) v[s * R + r] = cmul(v[s * R + r], tw[(r * k) << shift]);
    dft<R>(v + s * R);
  }
}

template <int R, int M>
__device__ __forceinline__ void store_pass(const float2 (&v)[8], float* re, float* im, int t,
                                           int p) {
#pragma unroll
  for (int s = 0; s < 8 / R; ++s) {
    const int b = t + s * (M / 8);
    const int k = b & (p - 1);
    const int j = (b - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = pidx(j + r * p);
      re[i] = v[s * R + r].x;
      im[i] = v[s * R + r].y;
    }
  }
}

// shared floats of one block that depend on n_fft alone: twiddles 4M,
// window 2M, FFT buffers, energy partials (the launch adds the audio span,
// the log-mel staging and the filterbank)
template <int LOGM>
constexpr int fixed_floats() {
  constexpr int M = 1 << LOGM, FPB = THREADS / (M / 8);
  return 6 * M + FPB * 2 * (M + M / 8) + 4 * FPB;
}

template <int LOGM>
__global__ void __launch_bounds__(THREADS, 4)
melspec_kernel(const float* __restrict__ y, const float* __restrict__ tables,
               const int* __restrict__ bands, const float* __restrict__ weights,
               float* __restrict__ out_mel, float* __restrict__ out_en, int T, int hop,
               int n_mels, int n_weights, int n_frames, int groups, int groups_per_utt) {
  constexpr int M = 1 << LOGM, N = 2 * M;
  constexpr int TPF = M / 8;                       // threads per frame
  constexpr int FPB = THREADS / TPF;               // frames per block
  constexpr int PM = M + M / 8;                    // padded length of re (or im)
  constexpr int L8 = LOGM / 3;                     // radix-8 passes
  constexpr int REM = 1 << (LOGM % 3);             // last pass's radix (1: none)
  constexpr int WPF = TPF >= 32 ? TPF / 32 : 1;    // energy partials per frame

  extern __shared__ __align__(16) float smem[];
  const float2* tw = reinterpret_cast<const float2*>(smem);       // W_M^t, t < M
  const float2* tws = tw + M;                                     // W_N^k, k < M
  const float2* win2 = reinterpret_cast<const float2*>(smem + 4 * M);   // window, N
  float* buf = smem + 6 * M;                                      // FPB x (re, im)
  float* part = buf + FPB * 2 * PM;                               // FPB x 4
  float* span = part + 4 * FPB;                                   // audio span
  float* mel_s = span + (FPB - 1) * hop + N;                      // n_mels x FPB
  int* bands_s = reinterpret_cast<int*>(mel_s + n_mels * FPB);    // n_mels x 3
  float* w_s = reinterpret_cast<float*>(bands_s + 3 * n_mels);    // n_weights

  const int tid = threadIdx.x;
  const int fl = tid / TPF, t = tid % TPF;
  for (int i = tid; i < 6 * M / 4; i += THREADS)
    reinterpret_cast<float4*>(smem)[i] = reinterpret_cast<const float4*>(tables)[i];
  // the filterbank too: a warp's bands are scattered over it, which device
  // memory serves a cache line per thread
  for (int i = tid; i < 3 * n_mels; i += THREADS) bands_s[i] = __ldg(bands + i);
  for (int i = tid; i < n_weights; i += THREADS) w_s[i] = __ldg(weights + i);
  float* re = buf + fl * 2 * PM;
  float* im = re + PM;
  const int pad = M;                               // n_fft / 2
  const int S = (FPB - 1) * hop + N;
  const long long period = 2LL * (T - 1);

  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int b = g / groups_per_utt;
    const int f0 = (g % groups_per_utt) * FPB;
    const float* yb = y + (size_t)b * T;

    // the audio span, reflect padding in the indexing, zeros past the end
    for (int s = tid; s < S; s += THREADS) {
      long long j = (long long)f0 * hop + s - pad;
      float v = 0.f;
      if (j < (long long)T + pad) {
        if (j < 0 || j >= T) {
          if (T > 1) {
            j %= period;
            if (j < 0) j += period;
            if (j >= T) j = period - j;
          } else {
            j = 0;
          }
        }
        v = __ldg(yb + j);
      }
      span[s] = v;
    }
    __syncthreads();

    // first radix-8 pass straight from the windowed frame
    float2 v[8];
    const float* fr = span + fl * hop;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = t + r * TPF;
      const float2 w = win2[n];
      v[r] = make_float2(fr[2 * n] * w.x, fr[2 * n + 1] * w.y);
    }
    dft8(v);
    store_pass<8, M>(v, re, im, t, 1);
    __syncthreads();
#pragma unroll
    for (int ps = 1; ps < L8; ++ps) {
      load_pass<8, M>(v, re, im, t);
      __syncthreads();
      twiddle_dft<8, LOGM>(v, tw, t, 3 * ps);
      store_pass<8, M>(v, re, im, t, 1 << (3 * ps));
      __syncthreads();
    }
    if constexpr (REM > 1) {
      load_pass<REM, M>(v, re, im, t);
      __syncthreads();
      twiddle_dft<REM, LOGM>(v, tw, t, 3 * L8);
      store_pass<REM, M>(v, re, im, t, 1 << (3 * L8));
      __syncthreads();
    }

    // split step: thread t takes k = t + q M/8 (bins k and M - k), and
    // thread 0 also bin M/2
    float2 za[4], zb[4], zmid = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = t + q * TPF;
      const int i = pidx(k), j = pidx((M - k) & (M - 1));
      za[q] = make_float2(re[i], im[i]);
      zb[q] = make_float2(re[j], im[j]);
    }
    if (t == 0) zmid = make_float2(re[pidx(M / 2)], im[pidx(M / 2)]);
    __syncthreads();
    float* mag = re;                                 // bins 0 .. M, unpadded
    float e = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = t + q * TPF;
      const float2 a = za[q], c = zb[q];
      const float ex = 0.5f * (a.x + c.x), ey = 0.5f * (a.y - c.y);
      const float2 wo = cmul(tws[k], make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x)));
      const float xr = ex + wo.x, xi = ey + wo.y;    // X[k]
      const float yr = ex - wo.x, yi = ey - wo.y;    // conj X[M - k]
      const float pk = fmaf(xr, xr, xi * xi), pm = fmaf(yr, yr, yi * yi);
      e += pk + pm;
      mag[k] = sqrtf(pk);
      mag[M - k] = sqrtf(pm);
    }
    if (t == 0) {
      const float pk = fmaf(zmid.x, zmid.x, zmid.y * zmid.y);
      e += pk;
      mag[M / 2] = sqrtf(pk);
    }
#pragma unroll
    for (int o = (TPF < 32 ? TPF : 32) / 2; o > 0; o >>= 1)
      e += __shfl_xor_sync(0xffffffffu, e, o);
    if ((t & 31) == 0) part[fl * 4 + (t >> 5)] = e;
    __syncthreads();

    // the sparse mel product, each band over its own bins
    for (int m = t; m < n_mels; m += TPF) {
      const int first = bands_s[3 * m], cnt = bands_s[3 * m + 1];
      const float* wm = w_s + bands_s[3 * m + 2];
      float acc = 0.f;
      for (int j = 0; j < cnt; ++j) acc = fmaf(wm[j], mag[first + j], acc);
      mel_s[m * FPB + fl] = logf(fmaxf(acc, 1e-5f));
    }
    __syncthreads();

    for (int i = tid; i < n_mels * FPB; i += THREADS) {
      const int f = f0 + i % FPB;
      if (f < n_frames) out_mel[((size_t)b * n_mels + i / FPB) * n_frames + f] = mel_s[i];
    }
    if (tid < FPB && f0 + tid < n_frames) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WPF; ++w) s += part[tid * 4 + w];
      out_en[(size_t)b * n_frames + f0 + tid] = sqrtf(s);
    }
  }
}

template <int LOGM>
int launch(const float* y, const float* tables, const int* bands, const float* weights,
           float* out_mel, float* out_en, int B, int T, int hop, int n_mels, int n_weights,
           cudaStream_t stream) {
  constexpr int M = 1 << LOGM, FPB = THREADS / (M / 8);
  const int n_frames = T / hop + 1;
  const long long per_utt = (n_frames + FPB - 1) / FPB;
  const long long groups = per_utt * B;
  if (groups > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t floats = (size_t)fixed_floats<LOGM>() + (size_t)(FPB - 1) * hop + 2 * M +
                        (size_t)n_mels * (FPB + 3) + n_weights;
  const size_t bytes = sizeof(float) * floats;
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = melspec_kernel<LOGM>;
  // the grid cap (SMs x resident blocks) for this device and shared-memory
  // size, asked of the runtime once and reused: the queries cost more host
  // time than a one-utterance launch takes on the card
  static thread_local int last_dev = -1, last_cap = 0;
  static thread_local size_t last_bytes = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != last_dev || bytes != last_bytes) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute((const void*)kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)) !=
        cudaSuccess)
      return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes)) !=
        cudaSuccess)
      return e;
    last_dev = dev;
    last_bytes = bytes;
    last_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long cap = last_cap;
  const int grid = (int)(groups < cap ? groups : cap);
  kernel<<<grid, THREADS, bytes, stream>>>(y, tables, bands, weights, out_mel, out_en, T, hop,
                                           n_mels, n_weights, n_frames, (int)groups,
                                           (int)per_utt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mtts_melspec_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// y: (B, T) fp32; tables: fp32, M = n_fft/2 complex W_M^t, then M complex
// W_N^k (N = n_fft), then the n_fft-point window; bands: (n_mels, 3) int32,
// per band its first bin, bin count and offset into weights; weights:
// n_weights fp32, each band's weights over its bins; out_mel: (B, n_mels,
// frames); out_en: (B, frames), frames = T/hop + 1.  n_fft a power of two
// from 256 to 2048, hop >= 1, 1 <= n_mels <= 128, 1 <= n_weights <= n_fft + 2,
// T >= 1.  One launch on `stream`; returns the first CUDA error (0 on
// success).
int mtts_melspec(const float* y, const float* tables, const int* bands, const float* weights,
                 float* out_mel, float* out_en, int B, int T, int n_fft, int hop, int n_mels,
                 int n_weights, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || T < 1 || hop < 1 || n_mels < 1 || n_mels > MAX_MELS || n_weights < 1 ||
      n_weights > n_fft + 2)
    return cudaErrorInvalidValue;
  switch (n_fft) {
    case 256:
      return launch<7>(y, tables, bands, weights, out_mel, out_en, B, T, hop, n_mels,
                        n_weights, stream);
    case 512:
      return launch<8>(y, tables, bands, weights, out_mel, out_en, B, T, hop, n_mels,
                        n_weights, stream);
    case 1024:
      return launch<9>(y, tables, bands, weights, out_mel, out_en, B, T, hop, n_mels,
                        n_weights, stream);
    case 2048:
      return launch<10>(y, tables, bands, weights, out_mel, out_en, B, T, hop, n_mels,
                        n_weights, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
