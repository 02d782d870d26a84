// Elementwise t statistic and the t^2 survivor screen with in-kernel ordered
// compaction, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/tstat.py:
//   `_tstat_kernel`  (reached through `tstat`)          -> tstat_kernel
//   `_screen_kernel` (reached through `screen_compact`) -> compact_kernel<false>
// and, as compact_kernel<true>, the XLA `nonzero` compaction of the fused
// OLS path's sparse epilogue (src/repro/core/association.py:339-355).
//
// What they compute, over the flat row-major tile of n = M * P elements:
//   t     = clip(r, -1, 1) * rsqrt(max(1 - r^2, eps) / dof)
//   keep  = t^2 >= t2_screen
//   idx   = ascending flat indices of the first `capacity` survivors, -1 padded
//   count = the exact number of survivors (also when it exceeds `capacity`)
// tstat_kernel emits t; compact_kernel<false> ("r mode") emits t, idx and
// count; compact_kernel<true> ("t mode") takes t in place of r and emits idx
// and count only.  `dof`, `eps` and `t2_screen` are runtime arguments.  The t
// of both r-taking kernels comes from one device function, so the two t
// tiles are bitwise identical (the reference's own contract: the sparse
// epilogue's t equals the dense fused path's).  The arithmetic is written
// with explicit rounding (__fmul_rn, __fsub_rn, __fdiv_rn): nvcc's default
// -fmad=true would otherwise contract 1 - r*r into an FMA.  The screen
// squares t with __fmul_rn too, so keep is the same IEEE compare as the
// host's plain float32 `t * t >= t2_screen` (NaN never survives).
//
// Bound on an H100 SXM: bytes.  tstat reads r and writes t (8 bytes per
// element).  The compaction reads r and writes t in r mode (8 bytes per
// element), reads t in t mode (4), and in both writes idx (4 per slot) and
// one 8-byte status word per tile.  At a (4096, 1024) cell with capacity
// 4,096 that is 33.6 MB (r mode) and 16.8 MB (t mode): 0.0100 ms and
// 0.0050 ms at 3.35 TB/s.  A handful of flops per element is far below the
// card's rate; at these sizes a launch costs about as much as the bound.
//
// Design of the compaction: one pass, a decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016), so the survivor count never travels to the host.
//   * A tile is 4,096 elements: 256 threads, each loading four float4 at
//     element tile * 4096 + k * 1024 + 4 * thread + j (k, j < 4).  Every warp
//     load touches 512 contiguous bytes.  Survivor order within a tile is
//     (k, thread, j), i.e. ascending index.
//   * Each thread counts its survivors of each chunk k into one 16-bit lane
//     of a 64-bit word; one warp scan (__shfl_up_sync) and a scan over the 8
//     warp totals in shared memory rank all four chunks at once (a lane's
//     total is at most 1,024, so lanes never carry into each other).
//   * A tile takes its id from an atomicAdd on a counter, not from blockIdx:
//     every lower id belongs to a block already running, which guarantees
//     the look-back forward progress.
//   * The prefix across tiles: each tile posts its aggregate in a 64-bit
//     status word (epoch | state | count), then warp 0 reads 32 predecessors
//     at a time, waits until all have posted, and sums back to the nearest
//     inclusive prefix; it then posts its own inclusive prefix.
//   * A survivor writes its index at prefix + rank when that is below
//     capacity.  The tile with the highest id holds the total: it writes
//     count and fills [min(total, capacity), capacity) with -1.
//   * Workspace: word 0 is the tile counter, words 1.. the status words.
//     The last tile sets the counter back to 0; a status word from an
//     earlier launch carries another epoch and reads as not yet posted, so
//     the workspace needs no reset between launches on one stream.
//   * Every sum is an integer, so the output does not depend on the schedule.
//
// The canonical refine (refine_kernel, entry refine_launch) replaces no
// Pallas kernel: it moves the reference's host refine
// (src/repro/core/stats.py::refine_neglog10p, the float32 -log10 p of every
// emitted t) onto the card.  It computes src/repro_torch/core/stats.py::
// neglog10_p_from_t lane by lane: the tail's log-space modified-Lentz
// fraction (128 fixed trips), the Edgeworth-corrected normal bulk above
// dof 4096 and the beta-function bulk at or below it, chosen by
// t^2 > t2_switch, then clamped at 0.  One thread a lane, no cross-lane
// work, so a lane's bits depend on its t alone.  A lane evaluates only the
// branch it keeps (the host evaluates both and selects; the kept value is
// the same function), and the tail and the beta bulk share one fraction
// call, so a warp's lanes never run the fraction twice.  The float32
// operations follow the host's torch ops in order, each rounded once
// (__fmul_rn and friends: no FMA contraction), with the host's quirks: a
// scalar over a tensor is a reciprocal and a product, a tensor over a
// scalar an IEEE division; logf, log1pf, expf and erfcf are the IEEE ones
// (no fast math), so a lane agrees with the host to a few float32 ulps.
// The per-scan scalars come from the host (core/stats.py::_refine_scalars).
// Bound on an H100 SXM: launch latency.  It reads t and writes the value
// (8 bytes a lane) and does ~3k flops a lane (two half-steps of the
// fraction a trip, each two divisions and a reciprocal): at 24,576 lanes
// 0.2 MB and 74 MFLOP, 1.1 us at 67 TFLOP/s fp32, far below a launch; a
// lane's 256 dependent half-steps set the kernel's own time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

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

inline unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

// ------------------------------------------------------------- compaction

constexpr int CHUNKS = 4;                  // float4 loads per thread
constexpr int CHUNK = THREADS * 4;         // 1,024 elements
constexpr int TILE = CHUNKS * CHUNK;       // 4,096 elements
constexpr unsigned STATE_AGGREGATE = 1u;   // count = this tile's survivors
constexpr unsigned STATE_PREFIX = 2u;      // count = survivors up to and with this tile

// A status word: epoch in bits 34..63, state in bits 32..33, count below.
__device__ __forceinline__ unsigned long long status_word(unsigned epoch, unsigned state,
                                                          unsigned count) {
  return (static_cast<unsigned long long>(epoch) << 34) |
         (static_cast<unsigned long long>(state) << 32) | count;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <bool FROM_T>
__global__ void __launch_bounds__(THREADS)
compact_kernel(const float* __restrict__ src, float* __restrict__ t_out,
               int* __restrict__ idx, int* __restrict__ count,
               unsigned long long* work, long long n, long long capacity,
               unsigned epoch, float dof, float t2_screen, float eps) {
  __shared__ unsigned long long warp_sums[WARPS];
  __shared__ int tile_s;
  __shared__ long long prefix_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned long long* status = work + 1;

  if (tid == 0) tile_s = static_cast<int>(atomicAdd(reinterpret_cast<unsigned*>(work), 1u));
  __syncthreads();
  const int tile = tile_s;
  // this thread's element of chunk k, lane j: first + k * CHUNK + j
  const long long first = static_cast<long long>(tile) * TILE + 4 * tid;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(t_out)) & 15) == 0;
  const bool full = aligned && (static_cast<long long>(tile) + 1) * TILE <= n;

  float v[CHUNKS][4];
  if (full) {
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(src + first + k * CHUNK);
      v[k][0] = x.x; v[k][1] = x.y; v[k][2] = x.z; v[k][3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long e = first + k * CHUNK + j;
        v[k][j] = (e < n) ? src[e] : 0.f;
      }
  }

  unsigned keep = 0;  // bit 4k + j: element first + k * CHUNK + j survives
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!FROM_T) v[k][j] = t_from_r(v[k][j], dof, eps);
      const bool in = full || first + k * CHUNK + j < n;
      if (in && __fmul_rn(v[k][j], v[k][j]) >= t2_screen) keep |= 1u << (4 * k + j);
    }
    if (!FROM_T) {
      float* out = t_out + first + k * CHUNK;
      if (full) {
        *reinterpret_cast<float4*>(out) = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (first + k * CHUNK + j < n) out[j] = v[k][j];
      }
    }
  }

  // Rank the survivors of all four chunks in one scan: chunk k's count in
  // bits 16k..16k+15.
  unsigned long long mine = 0;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k)
    mine |= static_cast<unsigned long long>(__popc((keep >> (4 * k)) & 0xFu)) << (16 * k);
  unsigned long long incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long up = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned long long before = 0, tile_sum = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const unsigned long long s = warp_sums[w];
    if (w < warp) before += s;
    tile_sum += s;
  }
  const unsigned long long excl = before + incl - mine;
  unsigned chunk_base[CHUNKS];
  unsigned agg = 0;  // this tile's survivors
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    chunk_base[k] = agg;
    agg += static_cast<unsigned>(tile_sum >> (16 * k)) & 0xFFFFu;
  }

  // The survivors of all earlier tiles: decoupled look-back by warp 0.
  if (warp == 0) {
    unsigned prefix = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, status_word(epoch, STATE_PREFIX, agg));
    } else {
      if (lane == 0) store_status(status + tile, status_word(epoch, STATE_AGGREGATE, agg));
      for (int top = tile - 1;; top -= 32) {
        const int p = top - lane;  // lane 0 reads the nearest predecessor
        unsigned state, cnt;
        do {
          state = STATE_PREFIX;  // before tile 0: an inclusive prefix of 0
          cnt = 0;
          if (p >= 0) {
            const unsigned long long s = load_status(status + p);
            state = (static_cast<unsigned>(s >> 34) == epoch)
                        ? static_cast<unsigned>(s >> 32) & 3u : 0u;
            cnt = static_cast<unsigned>(s);
          }
        } while (!__all_sync(FULL_MASK, state != 0u));
        const unsigned prefixes = __ballot_sync(FULL_MASK, state == STATE_PREFIX);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        prefix += __reduce_add_sync(FULL_MASK, lane <= stop ? cnt : 0u);
        if (prefixes) break;
      }
      if (lane == 0) store_status(status + tile, status_word(epoch, STATE_PREFIX, prefix + agg));
    }
    if (lane == 0) prefix_s = prefix;
  }
  __syncthreads();
  const long long prefix = prefix_s;

  if (keep != 0 && prefix < capacity) {
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      long long pos = prefix + chunk_base[k] + ((excl >> (16 * k)) & 0xFFFFull);
      for (unsigned bits = (keep >> (4 * k)) & 0xFu; bits != 0; bits &= bits - 1, ++pos)
        if (pos < capacity) idx[pos] = static_cast<int>(first + k * CHUNK + __ffs(bits) - 1);
    }
  }
  if (tile == static_cast<int>(gridDim.x) - 1) {
    const long long total = prefix + agg;
    if (tid == 0) {
      *count = static_cast<int>(total);
      // every block has taken its id: ready the counter for the next launch
      atomicExch(reinterpret_cast<unsigned*>(work), 0u);
    }
    for (long long i = (total < capacity ? total : capacity) + tid; i < capacity; i += THREADS)
      idx[i] = -1;
  }
}

// ------------------------------------------------------------------ refine

constexpr int REFINE_THREADS = 128;
constexpr int CF_ITERS = 128;
// The host's scalar constants, rounded to float32 as a torch op rounds them.
constexpr float FPMIN = static_cast<float>(1e-30);
constexpr float P_MIN = static_cast<float>(1e-38);
constexpr float NU_BETAINC = 4096.f;
constexpr float SQRT_HALF = static_cast<float>(0.7071067811865476);
constexpr float INV_SQRT_2PI = static_cast<float>(0.3989422804014327);
constexpr float LOG_2 = static_cast<float>(0.6931471805599453);   // -log(1/2)
constexpr float NEG_LOG10E = static_cast<float>(-0.4342944819032518);

// torch.where(abs(v) < FPMIN, FPMIN, v): NaN stays NaN.
__device__ __forceinline__ float tiny_floor(float v) {
  return fabsf(v) < FPMIN ? FPMIN : v;
}

// torch.clamp(v, min=lo) and (v, max=hi): NaN stays NaN, as in torch.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v > hi ? hi : v; }

// stats._betacf: the modified-Lentz fraction for I_x(a, b), 128 trips.
__device__ float betacf(float a, float b, float x) {
  const float qab = __fadd_rn(a, b), qap = __fadd_rn(a, 1.f), qam = __fsub_rn(a, 1.f);
  float c = 1.f;
  float d = __frcp_rn(tiny_floor(__fsub_rn(1.f, __fdiv_rn(__fmul_rn(qab, x), qap))));
  float h = d;
#pragma unroll 4
  for (int m = 0; m < CF_ITERS; ++m) {
    const float mf = static_cast<float>(m + 1), m2 = 2.f * mf;  // exact
    float aa = __fdiv_rn(__fmul_rn(__fmul_rn(__fsub_rn(b, mf), mf), x),
                         __fmul_rn(__fadd_rn(qam, m2), __fadd_rn(a, m2)));
    d = __frcp_rn(tiny_floor(__fadd_rn(1.f, __fmul_rn(aa, d))));
    c = tiny_floor(__fadd_rn(1.f, __fdiv_rn(aa, c)));
    h = __fmul_rn(__fmul_rn(h, d), c);
    aa = __fdiv_rn(__fmul_rn(__fmul_rn(-__fadd_rn(a, mf), __fadd_rn(qab, mf)), x),
                   __fmul_rn(__fadd_rn(a, m2), __fadd_rn(qap, m2)));
    d = __frcp_rn(tiny_floor(__fadd_rn(1.f, __fmul_rn(aa, d))));
    c = tiny_floor(__fadd_rn(1.f, __fdiv_rn(aa, c)));
    h = __fmul_rn(__fmul_rn(h, d), c);
  }
  return h;
}

__global__ void __launch_bounds__(REFINE_THREADS)
refine_kernel(const float* __restrict__ t_in, float* __restrict__ nlp, long long n,
              float nu, float t2_switch, float x_cf_max, float z_switch,
              float betaln_half, float log_a) {
  const long long i = (long long)blockIdx.x * REFINE_THREADS + threadIdx.x;
  if (i >= n) return;
  const float t = t_in[i];
  const float t2 = __fmul_rn(t, t);
  const float a = __fmul_rn(nu, 0.5f);  // exact: also b of the bulk
  // The host clamps t2 at t2_switch (and the tail at 6) from below for the
  // tail and from above for the beta bulk: a kept lane is left as it is.
  const bool tail = t2 > t2_switch;
  const bool use_z = !tail && t2 <= z_switch;  // the beta bulk's I_z(1/2, b)
  float log_p;
  if (!tail && nu > NU_BETAINC) {
    // The Edgeworth-corrected normal: no fraction.
    const float abs_t = fabsf(t);
    const float q_norm = __fmul_rn(0.5f, erfcf(__fmul_rn(abs_t, SQRT_HALF)));
    const float phi = __fmul_rn(INV_SQRT_2PI, expf(__fmul_rn(-0.5f, clamp_max(t2, 160.f))));
    const float corr = __fdiv_rn(__fmul_rn(__fadd_rn(__fmul_rn(abs_t, t2), abs_t), phi),
                                 __fmul_rn(4.f, nu));
    log_p = logf(clamp_max(clamp_min(__fmul_rn(2.f, __fadd_rn(q_norm, corr)), P_MIN), 1.f));
  } else {
    // One fraction for the tail (stats._log_p_tail: I_x(a, 1/2)) and the
    // beta bulk (stats._p_bulk_beta: I_z(1/2, b) or I_x(b, 1/2), each where
    // it converges).
    const float z = __fdiv_rn(t2, __fadd_rn(t2, nu));
    const float x = tail ? clamp_max(__fmul_rn(__frcp_rn(__fadd_rn(t2, nu)), nu), x_cf_max)
                         : (use_z ? z : __fsub_rn(1.f, z));
    const float cf = betacf(use_z ? 0.5f : a, use_z ? a : 0.5f, x);
    const float log_cf = logf(clamp_min(cf, FPMIN));
    // -a log1p(t2/nu) + (log t2 - log(nu + t2))/2 - betaln(a, 1/2)
    const float log_pref = __fsub_rn(
        __fadd_rn(__fmul_rn(-a, log1pf(__fdiv_rn(t2, nu))),
                  __fmul_rn(0.5f, __fsub_rn(logf(t2), logf(__fadd_rn(t2, nu))))),
        betaln_half);
    if (tail) {
      log_p = __fadd_rn(__fsub_rn(log_pref, log_a), log_cf);
    } else {
      const float part = expf(__fadd_rn(__fadd_rn(log_pref, use_z ? LOG_2 : -log_a), log_cf));
      const float p = use_z ? __fsub_rn(1.f, part) : part;
      log_p = logf(clamp_max(clamp_min(p, P_MIN), 1.f));
    }
  }
  nlp[i] = clamp_min(__fmul_rn(NEG_LOG10E, log_p), 0.f);
}

// Tiles for n elements; n == 0 still takes one tile, which writes count and
// the -1 fill.
inline unsigned tiles_for(long long n) {
  return n <= 0 ? 1u : static_cast<unsigned>((n + TILE - 1) / TILE);
}

// Runs `launch` with `device` current on the calling thread, then restores
// the thread's device; returns the launch's cudaError_t.  Doing the switch
// here spares the Python wrapper a device guard on every call.
template <class Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch();
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` of
// `device` and returns the cudaError_t of the launch (0 on success); none
// synchronizes.

// Elements per tile of the compaction: the workspace holds one 8-byte word
// for the tile counter and one status word per tile.
extern "C" int compact_tile_elems() { return TILE; }

extern "C" int tstat_launch(const void* r, void* t, long long n, float dof,
                            float eps, int device, void* stream) {
  if (n <= 0) return 0;
  return on_device(device, [&] {
    tstat_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(r), static_cast<float*>(t), n, dof, eps);
  });
}

// The compaction: idx[capacity] and count, from r (r mode, `from_t` 0,
// which also writes t) or from an existing t (t mode, `from_t` 1; `t`, `dof`
// and `eps` are not read).  `epoch` (1 .. 2^30 - 1) must differ from the
// previous launch's on the same workspace.
extern "C" int compact_launch(const void* src, void* t, void* idx, void* count, void* work,
                              long long n, long long capacity, unsigned epoch, float dof,
                              float t2_screen, float eps, int from_t, int device,
                              void* stream) {
  return on_device(device, [&] {
    auto kernel = from_t ? compact_kernel<true> : compact_kernel<false>;
    kernel<<<tiles_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<float*>(t), static_cast<int*>(idx),
        static_cast<int*>(count), static_cast<unsigned long long*>(work), n, capacity, epoch,
        dof, t2_screen, eps);
  });
}

// The canonical refine: nlp[i] = -log10 p of t[i] at the scan's dof, from
// the per-scan scalars of core/stats.py::_refine_scalars.
extern "C" int refine_launch(const void* t, void* nlp, long long n, float nu, float t2_switch,
                             float x_cf_max, float z_switch, float betaln_half, float log_a,
                             int device, void* stream) {
  if (n <= 0) return 0;
  return on_device(device, [&] {
    refine_kernel<<<static_cast<unsigned>((n + REFINE_THREADS - 1) / REFINE_THREADS),
                    REFINE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(t), static_cast<float*>(nlp), n, nu, t2_switch, x_cf_max,
        z_switch, betaln_half, log_a);
  });
}
