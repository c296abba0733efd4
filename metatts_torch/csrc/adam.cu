// NoamAdam's update over every leaf in a few launches, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the optimizer to optax's
// chain under jit, which XLA fuses.  On the card the same step written per
// leaf in PyTorch costs ~20 launches a leaf (~4,300 a baseline step of 216
// leaves) and a host read of the norm for the clip; this file does it in
// 1 + (leaves / NORM_LEAVES) + (leaves / UPDATE_LEAVES) launches, rounded up,
// and no host read.
//
// The step (train/optim.py NoamAdam, optax's order), per element of each
// leaf, with g_norm the global L2 norm of every gradient:
//
//   g  = g / g_norm * clip          where !(g_norm < clip), else g
//   mu = mu * b1 + (1 - b1) * g
//   nu = nu * b2 + (1 - b2) * (g * g)
//   u  = (mu * inv_c1) / (sqrt(nu * inv_c2) + eps) + weight_decay * p
//   p  = p + lr * u                 (lr already negated)
//
// Each operation is one fp32 operation rounded to nearest, written with the
// _rn intrinsics so that nvcc contracts nothing into an FMA: the sequence
// and roundings of PyTorch's own CUDA kernels in the per-leaf loop, which
// divide by a Python scalar as a product with its fp32 reciprocal (mu / c1,
// nu / c2; inv_c1 and inv_c2 come rounded from the host).  A null gradient
// reads as 0.
//
// Bound: bytes.  The norm reads g; the update reads g, p, mu and nu and
// writes p, mu and nu: 8 x 4 B an element, 1.12 GB at the baseline's
// 34.94 M parameters, 0.33 ms at 3.35 TB/s (0.29 ms for the 7 that the
// update alone moves).
//
// Design:
// - Leaves are passed by value as kernel arguments (pointers and sizes),
//   at most NORM_LEAVES / UPDATE_LEAVES a launch, so the 4 KB argument
//   limit holds and nothing is copied to the card; the host chunks them.
// - A launch lays its leaves end to end in slots of one float4 and runs
//   a fixed grid of BLOCKS x THREADS (one wave), thread t taking slots t,
//   t + STRIDE, ...; each thread walks the leaves once, in order, and waits
//   on one slot at a time.  (A grid-stride loop per leaf made every thread
//   wait once per leaf: 216 memory round trips a thread, 0.64 ms a step.)
//   A slot is one float4 load where the leaf's pointers are 16-byte
//   aligned, else element by element.
// - The norm: each block writes its sum of squares to a fixed slot of a
//   partials buffer (a warp shuffle tree, then the warps in order); one
//   block sums the slots in a fixed order and takes the sqrt into a device
//   scalar.  No atomics: a repeat gives the same bits.
// - The update reads that scalar and decides the clip on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS = 528;           // 4 blocks of 256 threads on each of 132 SMs
constexpr int STRIDE = BLOCKS * THREADS;
constexpr long long MAX_ELEMENTS = (1LL << 31) - 1 - 2LL * STRIDE;   // a step's, in all
constexpr int FINISH_THREADS = 1024;
constexpr int NORM_LEAVES = 320;      // 12 B a leaf: 3,840 B of arguments
constexpr int UPDATE_LEAVES = 108;    // 36 B a leaf: 3,888 B

struct NormArgs {
  const float* g[NORM_LEAVES];
  int n[NORM_LEAVES];
};

struct UpdateArgs {
  const float* g[UPDATE_LEAVES];
  float* p[UPDATE_LEAVES];
  float* mu[UPDATE_LEAVES];
  float* nu[UPDATE_LEAVES];
  int n[UPDATE_LEAVES];
};

struct Scalars {
  float clip, b1, one_minus_b1, b2, one_minus_b2, inv_c1, inv_c2, eps, weight_decay, lr;
};

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// The slots of a launch: its leaves laid end to end in slots of one float4,
// each leaf from a new slot.  Thread t takes slots t, t + STRIDE, ... of
// that run, so it waits on one slot at a time and meets only the leaves its
// slots fall in; it walks the leaves once, in order, with 32-bit arithmetic
// (the host keeps a step under MAX_ELEMENTS).
struct Walk {
  int leaf = 0, start = 0;  // the leaf of the current slot, its first slot
  // Move to the leaf that holds slot s (s only grows); false past the last.
  // `a` is the kernel's argument struct, read in place.
  template <class Args>
  __device__ __forceinline__ bool seek(const Args& a, int leaves, int s) {
    while (leaf < leaves) {
      const int slots = (a.n[leaf] + 3) / 4;
      if (s < start + slots) return true;
      start += slots;
      ++leaf;
    }
    return false;
  }
};

// the block's sum of v in a fixed order; the result in thread 0
template <int N>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warps[N / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < N / 32; ++w) s += warps[w];
  }
  return s;
}

__global__ void __launch_bounds__(THREADS) norm_kernel(const NormArgs a, int leaves,
                                                       float* partials) {
  float acc = 0.f;
  Walk w;
  for (int s = blockIdx.x * THREADS + threadIdx.x; w.seek(a, leaves, s); s += STRIDE) {
    const float* g = a.g[w.leaf];
    if (g == nullptr) continue;
    const int n = a.n[w.leaf], e = (s - w.start) * 4;
    if (aligned16(g) && e + 4 <= n) {
      const float4 v = *reinterpret_cast<const float4*>(g + e);
      acc = fmaf(v.x, v.x, acc);
      acc = fmaf(v.y, v.y, acc);
      acc = fmaf(v.z, v.z, acc);
      acc = fmaf(v.w, v.w, acc);
    } else {
      for (int j = e; j < n && j < e + 4; ++j) acc = fmaf(g[j], g[j], acc);
    }
  }
  const float total = block_sum<THREADS>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(FINISH_THREADS) finish_kernel(const float* partials, int n,
                                                                float* g_norm) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += FINISH_THREADS) acc += partials[i];
  const float total = block_sum<FINISH_THREADS>(acc);
  if (threadIdx.x == 0) *g_norm = __fsqrt_rn(total);
}

__device__ __forceinline__ void adam(float g, float& p, float& mu, float& nu, bool clip,
                                     float g_norm, const Scalars& s) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, g_norm), s.clip);
  mu = __fadd_rn(__fmul_rn(mu, s.b1), __fmul_rn(s.one_minus_b1, g));
  nu = __fadd_rn(__fmul_rn(nu, s.b2), __fmul_rn(s.one_minus_b2, __fmul_rn(g, g)));
  float u = __fdiv_rn(__fmul_rn(mu, s.inv_c1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(nu, s.inv_c2)), s.eps));
  u = __fadd_rn(u, __fmul_rn(s.weight_decay, p));
  p = __fadd_rn(p, __fmul_rn(s.lr, u));
}

__global__ void __launch_bounds__(THREADS) update_kernel(const UpdateArgs a, int leaves,
                                                         const float* g_norm_p,
                                                         const Scalars s) {
  const float g_norm = *g_norm_p;
  const bool clip = !(g_norm < s.clip);
  Walk w;
  for (int i = blockIdx.x * THREADS + threadIdx.x; w.seek(a, leaves, i); i += STRIDE) {
    const int l = w.leaf, n = a.n[l], e = (i - w.start) * 4;
    const float* __restrict__ g = a.g[l];
    float* __restrict__ p = a.p[l];
    float* __restrict__ mu = a.mu[l];
    float* __restrict__ nu = a.nu[l];
    if ((g == nullptr || aligned16(g)) && aligned16(p) && aligned16(mu) && aligned16(nu) &&
        e + 4 <= n) {
      const float4 gv =
          g ? *reinterpret_cast<const float4*>(g + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 pv = *reinterpret_cast<const float4*>(p + e);
      float4 mv = *reinterpret_cast<const float4*>(mu + e);
      float4 nv = *reinterpret_cast<const float4*>(nu + e);
      adam(gv.x, pv.x, mv.x, nv.x, clip, g_norm, s);
      adam(gv.y, pv.y, mv.y, nv.y, clip, g_norm, s);
      adam(gv.z, pv.z, mv.z, nv.z, clip, g_norm, s);
      adam(gv.w, pv.w, mv.w, nv.w, clip, g_norm, s);
      *reinterpret_cast<float4*>(p + e) = pv;
      *reinterpret_cast<float4*>(mu + e) = mv;
      *reinterpret_cast<float4*>(nu + e) = nv;
    } else {
      for (int j = e; j < n && j < e + 4; ++j) {
        float pj = p[j], mj = mu[j], nj = nu[j];
        adam(g ? g[j] : 0.f, pj, mj, nj, clip, g_norm, s);
        p[j] = pj;
        mu[j] = mj;
        nu[j] = nj;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* mtts_adam_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// One optimizer step over `leaves` leaves on `stream`.  ptrs: 4 per leaf,
// (g, p, mu, nu) device addresses of contiguous fp32 tensors (g may be 0:
// no gradient); sizes: the leaves' element counts, at most MAX_ELEMENTS in
// all.  norm_bounds (n_norm + 1 leaf indices) and update_bounds (n_update +
// 1) cut the leaves into the launches' chunks, each at most NORM_LEAVES /
// UPDATE_LEAVES leaves.  scratch: 1 + n_norm * BLOCKS floats; scratch[0]
// receives the global norm.  The scalars are fp32 as the per-leaf loop rounds them (lr
// negated).  Launches n_norm + 1 + n_update kernels and returns the first
// CUDA error (0 on success).
int mtts_adam_step(const long long* ptrs, const int* sizes, int leaves, const int* norm_bounds,
                   int n_norm, const int* update_bounds, int n_update, float* scratch,
                   float clip, float b1, float one_minus_b1, float b2, float one_minus_b2,
                   float inv_c1, float inv_c2, float eps, float weight_decay, float lr,
                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (leaves < 1 || n_norm < 1 || n_update < 1 || scratch == nullptr ||
      norm_bounds[0] != 0 || norm_bounds[n_norm] != leaves || update_bounds[0] != 0 ||
      update_bounds[n_update] != leaves)
    return cudaErrorInvalidValue;
  for (int c = 0; c < n_norm; ++c) {
    const int k = norm_bounds[c + 1] - norm_bounds[c];
    if (k < 1 || k > NORM_LEAVES) return cudaErrorInvalidValue;
  }
  for (int c = 0; c < n_update; ++c) {
    const int k = update_bounds[c + 1] - update_bounds[c];
    if (k < 1 || k > UPDATE_LEAVES) return cudaErrorInvalidValue;
  }
  long long total = 0;   // every slot, and a stride past the last, in an int
  for (int l = 0; l < leaves; ++l) {
    total += sizes[l];
    if (sizes[l] < 0 || (sizes[l] > 0 && (ptrs[4 * l + 1] == 0 || ptrs[4 * l + 2] == 0 ||
                                           ptrs[4 * l + 3] == 0)))
      return cudaErrorInvalidValue;
  }
  if (total > MAX_ELEMENTS) return cudaErrorInvalidValue;
  float* g_norm = scratch;
  float* partials = scratch + 1;
  for (int c = 0; c < n_norm; ++c) {
    NormArgs a;
    const int first = norm_bounds[c], k = norm_bounds[c + 1] - first;
    for (int j = 0; j < k; ++j) {
      a.g[j] = reinterpret_cast<const float*>(ptrs[4 * (first + j)]);
      a.n[j] = sizes[first + j];
    }
    norm_kernel<<<BLOCKS, THREADS, 0, stream>>>(a, k, partials + (long long)c * BLOCKS);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  finish_kernel<<<1, FINISH_THREADS, 0, stream>>>(partials, n_norm * BLOCKS, g_norm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Scalars s{clip, b1, one_minus_b1, b2, one_minus_b2, inv_c1, inv_c2, eps, weight_decay,
                  lr};
  for (int c = 0; c < n_update; ++c) {
    UpdateArgs a;
    const int first = update_bounds[c], k = update_bounds[c + 1] - first;
    for (int j = 0; j < k; ++j) {
      const long long* q = ptrs + 4 * (first + j);
      a.g[j] = reinterpret_cast<const float*>(q[0]);
      a.p[j] = reinterpret_cast<float*>(q[1]);
      a.mu[j] = reinterpret_cast<float*>(q[2]);
      a.nu[j] = reinterpret_cast<float*>(q[3]);
      a.n[j] = sizes[first + j];
    }
    update_kernel<<<BLOCKS, THREADS, 0, stream>>>(a, k, g_norm, s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return 0;
}

}  // extern "C"
