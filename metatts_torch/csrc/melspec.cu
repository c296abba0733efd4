// Log-mel spectrogram and energy in one kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_mel_spectrogram (Pallas, the TPU package's
// ops/pallas/melspec.py: _kernel, _make_constants).  Per utterance b of
// y (B, T) fp32:
//
//   x       = y reflect-padded by n_fft/2 on both sides (numpy "reflect",
//             reflecting again where n_fft/2 > T - 1)
//   frame f = x[f*hop : f*hop + n_fft],  f < T/hop + 1 = frames
//   re, im  = frame @ cos, frame @ sin   (Hann window folded into the bases,
//             cutoff = n_fft/2 + 1 bins)
//   power   = re^2 + im^2,  mag = sqrt(power)
//   mel     = log(max(mag @ mel_basis, 1e-5))  -> out_mel (B, n_mels, frames)
//   energy  = sqrt(sum over bins of power)     -> out_en  (B, frames)
//
// Every product and sum is fp32 FMA: the TPU test holds the log-mel to
// atol 1e-4, which TF32 (about three decimal digits) cannot keep for
// quiet bins.
//
// Bound: the function needs far less work than this kernel does.  Per
// frame a real FFT of n_fft points (~2.5 n_fft log2 n_fft FLOP), power,
// magnitude and energy of the cutoff bins, and the filterbank's nonzero
// weights come to ~31 kFLOP on ~1 KB of new audio, so at 16 utterances of
// 10 s the least time is ~6.5 us, set by fp32 operations (67 TFLOP/s
// outside the tensor cores) about as much as by bytes (~19 MB).  This
// kernel does the DFT as two dense products instead: per frame
// 2 * (n_fft * cutoff) * 2 + cutoff * n_mels * 2 FLOP (~2.18 MFLOP, ~70x
// the FFT's count), ~30 GFLOP at that size, so it cannot come near the
// bound; an FFT-based design is the later redesign.
//
// Design: one block of 128 threads per (utterance, tile of 64 frames).
// - The block reads its audio span, (64 - 1) * hop + n_fft samples, into
//   shared memory once, doing the reflect padding in its own indexing; the
//   4x-overlapping frame matrix is never built.  Four floats of padding
//   every 128 samples put neighbouring frames (hop 256 apart) in other
//   banks and keep 4-sample runs 16-byte aligned for vector loads.
// - Bins [0, n_fft/2) go in tiles of 64.  For each tile the windowed
//   cos/sin basis streams through shared memory in chunks of 32 samples
//   (cp.async, two stages); each thread accumulates re and im of 8 frames
//   x 4 bins in registers (64 accumulators).
// - At the end of a tile each thread adds its power to its frames' energy,
//   writes the magnitude to shared memory, and the block multiplies that
//   64 x 64 tile straight into its 64 x 80 mel accumulator (registers, 8
//   frames x 5 bands a thread).  Power and magnitude never reach device
//   memory.
// - The Nyquist bin (n_fft/2) is a dot product per frame, one warp each.
// - The epilogue reduces the energy over the 16 threads of a frame, takes
//   log(max(mel, 1e-5)) and sqrt(energy), and masks the ragged last tile.
// Faster forms (3xTF32 split products on wgmma, TMA, a persistent grid, an
// FFT) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FT = 64;          // frames per block
constexpr int THREADS = 128;
constexpr int BT = 64;          // bins per tile
constexpr int KC = 32;          // samples per basis chunk
constexpr int FPT = 8;          // frames per thread: tf + 8 i
constexpr int BPT = 4;          // bins per thread: 4 tb + j
constexpr int MPT = 5;          // mel bands per thread: tb + 16 j
constexpr int MAX_MELS = 16 * MPT;
constexpr int ROW = 2 * BT;     // one basis row: 64 cos then 64 sin
constexpr int MAG_LD = BT + 1;  // magnitude tile row stride

// shared index of span sample s: 4 floats of padding every 128 samples
__device__ __forceinline__ int sidx(int s) { return s + 4 * (s >> 7); }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(THREADS, 2)
melspec_kernel(const float* __restrict__ y, const float* __restrict__ tiles,
               const float* __restrict__ nyq, const float* __restrict__ melT,
               float* __restrict__ out_mel, float* __restrict__ out_en, int T, int n_fft,
               int hop, int n_mels, int n_frames, int span_pad) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                          // audio span, padded index
  float* bs = smem + span_pad;               // 2 stages of KC basis rows
  float* mag = bs;                           // FT x MAG_LD, between tiles only
  float* nyq_pow = bs + 2 * KC * ROW;        // FT

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const int tb = tid & 15, tf = tid >> 4;
  const float* yb = y + (size_t)b * T;
  const int pad = n_fft / 2;
  const int span = (FT - 1) * hop + n_fft;
  const long long xlen = (long long)T + 2 * pad;
  const long long period = 2LL * (T - 1);

  // the audio span, reflect padding in the indexing, zeros past the end
  for (int s = tid; s < span; s += THREADS) {
    const long long p = (long long)f0 * hop + s;
    float v = 0.f;
    if (p < xlen) {
      long long j = 0;
      if (T > 1) {
        j = (p - pad) % period;
        if (j < 0) j += period;
        if (j >= T) j = period - j;
      }
      v = yb[j];
    }
    as[sidx(s)] = v;
  }

  float mel[FPT][MPT];
  float en[FPT];
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    en[i] = 0.f;
#pragma unroll
    for (int j = 0; j < MPT; ++j) mel[i][j] = 0.f;
  }

  const int n_tiles = n_fft / (2 * BT);
  const int n_chunks = n_fft / KC;
  auto load_chunk = [&](int t, int c, int stage) {
    const float* src = tiles + ((size_t)t * n_fft + (size_t)c * KC) * ROW;
    float* dst = bs + stage * KC * ROW;
    for (int i = tid; i < KC * ROW / 4; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i);
    cp_async_commit();
  };

  for (int t = 0; t < n_tiles; ++t) {
    float re[FPT][BPT], im[FPT][BPT];
#pragma unroll
    for (int i = 0; i < FPT; ++i)
#pragma unroll
      for (int j = 0; j < BPT; ++j) re[i][j] = im[i][j] = 0.f;

    load_chunk(t, 0, 0);
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        load_chunk(t, c + 1, (c + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* bc = bs + (c & 1) * KC * ROW + 4 * tb;
      int abase[FPT];
#pragma unroll
      for (int i = 0; i < FPT; ++i) abase[i] = sidx((tf + 8 * i) * hop + c * KC);
#pragma unroll
      for (int kk = 0; kk < KC; kk += 4) {
        float4 a[FPT];
#pragma unroll
        for (int i = 0; i < FPT; ++i) a[i] = *reinterpret_cast<const float4*>(as + abase[i] + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 cv = *reinterpret_cast<const float4*>(bc + (kk + q) * ROW);
          const float4 sv = *reinterpret_cast<const float4*>(bc + (kk + q) * ROW + BT);
#pragma unroll
          for (int i = 0; i < FPT; ++i) {
            const float av = comp(a[i], q);
            re[i][0] = fmaf(av, cv.x, re[i][0]);
            re[i][1] = fmaf(av, cv.y, re[i][1]);
            re[i][2] = fmaf(av, cv.z, re[i][2]);
            re[i][3] = fmaf(av, cv.w, re[i][3]);
            im[i][0] = fmaf(av, sv.x, im[i][0]);
            im[i][1] = fmaf(av, sv.y, im[i][1]);
            im[i][2] = fmaf(av, sv.z, im[i][2]);
            im[i][3] = fmaf(av, sv.w, im[i][3]);
          }
        }
      }
      __syncthreads();   // the stage just read is the target of the load after next
    }

    // power into the energy, magnitude into shared memory (the stages are idle)
#pragma unroll
    for (int i = 0; i < FPT; ++i)
#pragma unroll
      for (int j = 0; j < BPT; ++j) {
        const float p = re[i][j] * re[i][j] + im[i][j] * im[i][j];
        en[i] += p;
        mag[(tf + 8 * i) * MAG_LD + 4 * tb + j] = sqrtf(p);
      }
    __syncthreads();
    const float* mt = melT + (size_t)t * BT * n_mels;
    for (int k = 0; k < BT; ++k) {
      float mv[MPT];
#pragma unroll
      for (int j = 0; j < MPT; ++j) {
        const int m = tb + 16 * j;
        mv[j] = m < n_mels ? __ldg(mt + k * n_mels + m) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < FPT; ++i) {
        const float g = mag[(tf + 8 * i) * MAG_LD + k];
#pragma unroll
        for (int j = 0; j < MPT; ++j) mel[i][j] = fmaf(g, mv[j], mel[i][j]);
      }
    }
    __syncthreads();   // the magnitude tile aliases the next tile's stages
  }

  // the Nyquist bin: one warp per frame
  const int warp = tid >> 5, lane = tid & 31;
  for (int fl = warp; fl < FT; fl += THREADS / 32) {
    float r = 0.f, q = 0.f;
    for (int k = lane; k < n_fft; k += 32) {
      const float a = as[sidx(fl * hop + k)];
      r = fmaf(a, __ldg(nyq + k), r);
      q = fmaf(a, __ldg(nyq + n_fft + k), q);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      r += __shfl_xor_sync(0xffffffffu, r, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) nyq_pow[fl] = r * r + q * q;
  }
  __syncthreads();

  const float* mn = melT + (size_t)(n_fft / 2) * n_mels;
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    const int fl = tf + 8 * i, f = f0 + fl;
    const float pn = nyq_pow[fl];
    const float gn = sqrtf(pn);
    float e = en[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
    if (f < n_frames) {
      if (tb == 0) out_en[(size_t)b * n_frames + f] = sqrtf(e + pn);
#pragma unroll
      for (int j = 0; j < MPT; ++j) {
        const int m = tb + 16 * j;
        if (m < n_mels)
          out_mel[((size_t)b * n_mels + m) * n_frames + f] =
              logf(fmaxf(fmaf(gn, __ldg(mn + m), mel[i][j]), 1e-5f));
      }
    }
  }
}

}  // namespace

extern "C" {

const char* mtts_melspec_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// y: (B, T) fp32; tiles: (n_fft/128, n_fft, 128) fp32, per 64-bin tile the
// windowed cos then sin columns; nyq: (2, n_fft) fp32, cos and sin of bin
// n_fft/2; melT: (n_fft/2 + 1, n_mels) fp32; out_mel: (B, n_mels, frames);
// out_en: (B, frames), frames = T/hop + 1.  n_fft a multiple of 128, hop of
// 32, n_mels <= 80, T >= 1.  One launch on `stream`; returns the first CUDA
// error (0 on success).
int mtts_melspec(const float* y, const float* tiles, const float* nyq, const float* melT,
                 float* out_mel, float* out_en, int B, int T, int n_fft, int hop, int n_mels,
                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || T < 1 || n_fft < 128 || n_fft % 128 || hop < 32 || hop % 32 || n_mels < 1 ||
      n_mels > MAX_MELS)
    return cudaErrorInvalidValue;
  const int n_frames = T / hop + 1;
  const int span = (FT - 1) * hop + n_fft;
  const int span_pad = (span + 4 * ((span + 127) / 128) + 3) / 4 * 4;
  const size_t bytes = sizeof(float) * ((size_t)span_pad + 2 * KC * ROW + FT);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute((const void*)melspec_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((n_frames + FT - 1) / FT, B);
  melspec_kernel<<<grid, THREADS, bytes, stream>>>(y, tiles, nyq, melT, out_mel, out_en, T, n_fft,
                                                   hop, n_mels, n_frames, span_pad);
  return cudaGetLastError();
}

}  // extern "C"
