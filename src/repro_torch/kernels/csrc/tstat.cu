// Elementwise t statistic and the fused t^2 survivor screen for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/tstat.py:
//   `_tstat_kernel`  (reached through `tstat`)          -> tstat_kernel
//   `_screen_kernel` (reached through `screen_compact`) -> screen_kernel
// Both serve the mixed-model engine's fused epilogue
// (`core/engines.py::build_lmm_step`, `--lmm-epilogue fused`).
//
// What they compute, over the flat row-major (M * P) correlation tile r:
//   t     = clip(r, -1, 1) * rsqrt(max(1 - r^2, eps) / dof)
//   mask  = t^2 >= t2_screen                      (screen_kernel only, int8)
//   count = survivors per CUDA block             (screen_kernel only, int32)
// `dof`, `eps` and `t2_screen` are runtime arguments.  The t of both kernels
// comes from one device function, so the two t tiles are bitwise identical
// (the reference's own contract: the sparse epilogue's t equals the dense
// fused path's).  The arithmetic is written with explicit rounding
// (__fmul_rn, __fsub_rn, __fdiv_rn): nvcc's default -fmad=true would
// otherwise contract 1 - r*r into an FMA.  The screen squares t with
// __fmul_rn too, so the mask is the same IEEE compare as the host's plain
// float32 `t * t >= t2_screen` over the pulled t tile (the sparse
// epilogue's overflow fallback).
//
// Bound on an H100 SXM: bytes.  tstat reads r and writes t (8 bytes per
// element); screen also writes the int8 mask (9 bytes per element) plus one
// int32 per block.  At a (4096, 1024) cell that is 33.5 MB and 37.7 MB,
// 0.010 ms and 0.011 ms at 3.35 TB/s; a handful of flops per element is far
// below the card's rate.  At these sizes the launch itself costs about as
// much as the bound.
//
// Design (first version: simple and right).  One thread per element, 256
// threads per block, bounds-checked in place of the reference's zero
// padding to (block_m, block_p) tiles.  The screen counts its survivors
// with one warp ballot + __popc per warp and a shared-memory sum across the
// block's 8 warps; the caller sums the per-block counts.  Compaction of the
// survivor indices stays in the wrapper (torch.nonzero, row-major order);
// an ordered in-kernel scatter is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// clip, then t.  The compares keep a NaN r NaN (as the reference's clip and
// maximum do); fminf/fmaxf would turn it into a bound.
__device__ __forceinline__ float t_from_r(float r, float dof, float eps) {
  r = (r < -1.f) ? -1.f : ((r > 1.f) ? 1.f : r);
  const float one_minus = __fsub_rn(1.f, __fmul_rn(r, r));
  const float denom = (one_minus < eps) ? eps : one_minus;
  return __fmul_rn(r, rsqrtf(__fdiv_rn(denom, dof)));
}

__global__ void __launch_bounds__(THREADS)
tstat_kernel(const float* __restrict__ r, float* __restrict__ t, long long n,
             float dof, float eps) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) t[i] = t_from_r(r[i], dof, eps);
}

__global__ void __launch_bounds__(THREADS)
screen_kernel(const float* __restrict__ r, float* __restrict__ t,
              int8_t* __restrict__ mask, int* __restrict__ counts, long long n,
              float dof, float t2_screen, float eps) {
  __shared__ int warp_counts[WARPS];
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  bool keep = false;
  if (i < n) {
    const float tv = t_from_r(r[i], dof, eps);
    t[i] = tv;
    keep = __fmul_rn(tv, tv) >= t2_screen;
    mask[i] = keep ? 1 : 0;
  }
  // Every thread of the block reaches the ballot (no early return).
  const unsigned votes = __ballot_sync(0xffffffffu, keep);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = __popc(votes);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += warp_counts[w];
    counts[blockIdx.x] = total;
  }
}

inline unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` and
// returns the cudaError_t of the launch (0 on success); none synchronizes.

// Threads per block, hence elements per entry of screen_launch's `counts`.
extern "C" int tstat_block_threads() { return THREADS; }

extern "C" int tstat_launch(const void* r, void* t, long long n, float dof,
                            float eps, void* stream) {
  if (n <= 0) return 0;
  tstat_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<float*>(t), n, dof, eps);
  return static_cast<int>(cudaGetLastError());
}

// `counts` holds ceil(n / tstat_block_threads()) int32 entries.
extern "C" int screen_launch(const void* r, void* t, void* mask, void* counts,
                             long long n, float dof, float t2_screen, float eps,
                             void* stream) {
  if (n <= 0) return 0;
  screen_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<float*>(t),
      static_cast<int8_t*>(mask), static_cast<int*>(counts), n, dof, t2_screen,
      eps);
  return static_cast<int>(cudaGetLastError());
}
