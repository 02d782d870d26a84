// Fused 2-bit decode + standardize + GEMM + t epilogue for Hopper (sm_90a),
// on the tensor cores through warp-level mma.sync.
//
// Replaces the Pallas TPU kernel `gwas_dot_kernel` in
// src/repro/kernels/gwas_dot/gwas_dot.py (built by `build_gwas_dot`, reached
// through `ops.gwas_dot` and `core/engines.py::build_fused_step`).
//
// What it computes, per genotype batch (M markers x N samples x P traits):
//   codes   2-bit PLINK codes in the tile-local layout of `ops.pack_tiled`:
//           sample n lives in byte (n / bn) * (bn/4) + (n % bn) % (bn/4), at
//           2-bit slot (n % bn) / (bn/4), where bn is the layout's block_n
//   g       dosage 2 - c + (c >> 1), standardized (d - mean) * inv_std,
//           missing (code 0b01) -> 0
//   acc     sum over samples of g * y, accumulated in fp32
//   r, t    r = clip(acc / n_samples, -1, 1);
//           t = r * rsqrt(max(1 - r^2, eps) / dof)
// `n_samples` and `dof` are runtime arguments.  Rows of y past `n_y_rows`
// read as 0 (pad samples carry code 0b01, so g is 0 there anyway).
//
// Bound on an H100 SXM: operations.  One scan cell of the paper-sized slice
// (M=4096, N=23000, P=1024) is 2*M*N*P = 1.93e11 FLOP and moves ~0.15 GB
// (packed codes, y, r, t), ~0.05 ms at 3.35 TB/s.  fp32 mode is held to r
// 2e-6, which one TF32 product cannot meet, so it runs three TF32 products
// per multiply-add (3xTF32, below): 5.8e11 tensor-core FLOP at 495 TFLOP/s,
// a floor of 1.17 ms.  bf16 mode is one bf16 pass at 989 TFLOP/s, 0.195 ms.
// mma.sync does not reach wgmma's rate; chip_smoke.py prints the times.
//
// Design.
// * Tiles.  One 256-thread block per 128 x 128 (markers x traits) output
//   tile; 8 warps as 2 (markers) x 4 (traits), each owning a 64 x 32 warp
//   tile of 4 x 4 m16n8 accumulator fragments.  fp32 mode runs
//   mma.sync.m16n8k8 tf32, bf16 mode mma.sync.m16n8k16 bf16 (products of
//   bf16 values are exact in fp32: the plain version's contract).  The
//   chunk accumulators and totals take 128 of a thread's 255 registers, so
//   one block runs per SM.
// * 3xTF32.  Each fp32 operand is split in registers at fragment load into
//   hi = tf32_rna(x) and lo = tf32_rna(x - hi) (cvt.rna's rounding, done by
//   integer operations); each fragment pair takes three mma in a fixed
//   order, small terms first: lo*hi, hi*lo, hi*hi (the dropped lo*lo is
//   ~2^-22 relative).  Shared memory holds fp32 once.
// * Two-level accumulation.  Tensor cores do not round their internal adds
//   to nearest, and an accumulator that runs on over many samples drifts,
//   the more the longer its run: over all 23,000 samples of the scan cell
//   it lands far past the r tolerance (tests/test_torch_kernels.py emulates
//   this).  So the mma accumulators restart from zero every KC = 64 samples
//   and are then added into a per-element fp32 total with __fadd_rn.  Chunk
//   boundaries sit at fixed absolute sample indices, so every output element
//   sums in one order whatever M, P or the grid: no split-K, no atomics, and
//   blocked == unblocked trait grids and sparse == dense epilogues stay
//   bitwise.
// * Stages.  The sample loop takes steps of BK = 32 samples through a
//   3-stage ring in shared memory (105 KB in fp32 mode, so the launcher
//   raises the kernel's dynamic shared-memory limit once per device).  The y
//   tile of step s + 2 arrives by cp.async (16-byte copies, or 4-byte copies
//   when rows are not 16-byte aligned, i.e. P % 4 != 0), zero-filled past
//   n_y_rows and P through the src-size operand, while step s computes; the
//   packed bytes of step s + 2 are loaded into registers, and those of step
//   s + 1 decoded into its stage, around step s's mma.
// * Decode.  Each thread owns half of one marker row's samples for the
//   whole loop, so the three standardized values its codes can take are
//   computed once and a code is decoded by a select.  When (block_n/4) % BK
//   == 0 (the default block_n=512) a step's samples share one tile and one
//   2-bit slot and their bytes are contiguous: one 16-byte load per thread
//   per step, no division per code.  Any other block_n takes a per-code
//   address walk (FAST=false) feeding the same tensor-core loop.
// * Shared-memory pitches are padded so every fragment load of a warp hits
//   32 distinct banks (see the pitch constants).
// * The epilogue runs on the totals in registers with explicit IEEE
//   rounding and stores adjacent columns as float2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // markers per block
constexpr int BP = 128;        // traits per block
constexpr int BK = 32;         // samples per step
constexpr int STAGES = 3;      // shared-memory ring depth
constexpr int THREADS = 256;
constexpr int WM = 64;         // markers per warp (2 warps along M)
constexpr int WP = 32;         // traits per warp (4 warps along P)
constexpr int MF = WM / 16;    // m16 fragments per warp
constexpr int NF = WP / 8;     // n8 fragments per warp
constexpr int KC = 64;         // samples per accumulator chunk
constexpr int CHUNK_STEPS = KC / BK;
constexpr int HALF = BK / 2;   // samples a decoder thread handles per step

// Shared-memory pitches (32-bit words).  In a fragment load, lane (g =
// lane / 4, t = lane % 4) reads word t of row g of the g tile (fp32: one
// sample a word; bf16: two), or trait g of sample row t (bf16: rows 2t and
// 2t + 1) of the y tile.  The banks hit are then
//   fp32 g  pitch 36:  36g + t = 4g + t    (mod 32) -> 32 distinct
//   bf16 g  pitch 20:  20g + t             (mod 32) -> 32 distinct
//   y fp32  pitch 136: 136t + g = 8t + g   (mod 32) -> 32 distinct
//   y bf16  pitch 132: 264t + g = 8t + g   (mod 32) -> 32 distinct
// where unpadded pitches (32, 16, 128) put 4 or 2 lanes on one bank.
constexpr int LDA_F32 = BK + 4;
constexpr int LDA_BF16 = BK / 2 + 4;
constexpr int LDB_F32 = BP + 8;
constexpr int LDB_BF16 = BP + 4;

static_assert(THREADS == 2 * BM, "two decoder threads per marker row");
static_assert(BK * BP == THREADS * 16, "four 16-byte y copies per thread per step");
static_assert(KC % BK == 0, "chunks hold whole steps");

template <bool BF16>
struct Smem;
template <>
struct Smem<false> {
  uint32_t a[STAGES][BM][LDA_F32];   // g as fp32 bits
  float b[STAGES][BK][LDB_F32];
};
template <>
struct Smem<true> {
  uint32_t a[STAGES][BM][LDA_BF16];  // g as bf16 pairs, low half = even sample
  float b[STAGES][BK][LDB_BF16];
};

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero) as integer
// operations: add half a tf32 ulp to the magnitude bits, clear the low 13.
// Bitwise the same for finite x, and cheaper than the cvt instruction on
// sm_90.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Two fp32 values rounded to bf16 (to nearest) in one word, `lo` in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Not volatile: independent mma may be scheduled freely; each accumulator's
// updates keep their order through the data dependence.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `src_bytes` (0..16) bytes and zero-fills the rest of 16.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The t epilogue, with the rounding of the plain version spelled out (nvcc
// would otherwise contract 1 - r*r into an FMA).
__device__ __forceinline__ void epilogue(float acc, float n_samples, float dof, float eps,
                                         float& r, float& t) {
  r = __fdiv_rn(acc, n_samples);
  r = fminf(fmaxf(r, -1.f), 1.f);
  const float denom = fmaxf(__fsub_rn(1.f, __fmul_rn(r, r)), eps);
  t = __fmul_rn(r, rsqrtf(__fdiv_rn(denom, dof)));
}

struct Args {
  const uint8_t* packed;   // (M, packed_stride)
  const float* mean;       // (M,)
  const float* inv_std;    // (M,)
  const float* y;          // (n_y_rows, P)
  float* r_out;            // (M, P)
  float* t_out;            // (M, P)
  int M, N, P, n_y_rows, packed_stride, block_n;
  float n_samples, dof, eps;
};

// The HALF codes of samples k .. k + HALF - 1 of one row, one code in the
// low 2 bits of each byte; rows past M and samples past N read as missing.
template <bool FAST>
__device__ __forceinline__ uint4 fetch_codes(const Args& a, const uint8_t* prow, bool row_ok,
                                             int k) {
  constexpr uint32_t MISSING = 0x01010101u;
  if (!row_ok) return make_uint4(MISSING, MISSING, MISSING, MISSING);
  const int quarter = a.block_n >> 2;
  const int tile = k / a.block_n;
  const int w = k - tile * a.block_n;
  int slot = w / quarter;
  int b = w - slot * quarter;
  if constexpr (FAST) {
    // The step's samples share one tile and one slot: HALF contiguous bytes.
    const uint4 raw = *reinterpret_cast<const uint4*>(prow + tile * quarter + b);
    const int shift = 2 * slot;
    return make_uint4((raw.x >> shift) & 0x03030303u, (raw.y >> shift) & 0x03030303u,
                      (raw.z >> shift) & 0x03030303u, (raw.w >> shift) & 0x03030303u);
  } else {
    const uint8_t* base = prow + tile * quarter;
    uint32_t c[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      uint32_t code = 1u;
      if (k + j < a.N) code = (base[b] >> (2 * slot)) & 3u;
      c[j >> 2] |= code << (8 * (j & 3));
      if (++b == quarter) {
        b = 0;
        if (++slot == 4) {
          slot = 0;
          base += quarter;
        }
      }
    }
    return make_uint4(c[0], c[1], c[2], c[3]);
  }
}

__device__ __forceinline__ uint32_t code_at(const uint4& c, int j) {
  const uint32_t word = j < 4 ? c.x : j < 8 ? c.y : j < 12 ? c.z : c.w;
  return (word >> (8 * (j & 3))) & 3u;
}

// A code's standardized value: code 0 -> v[0] (dosage 2), 1 -> 0 (missing),
// 2 -> v[1] (dosage 1), 3 -> v[2] (dosage 0).
__device__ __forceinline__ uint32_t pick(uint32_t code, const uint32_t (&v)[3]) {
  return (code & 2u) ? ((code & 1u) ? v[2] : v[1]) : ((code & 1u) ? 0u : v[0]);
}

// One row's HALF decoded samples into stage `stage` (fp32 bits, or bf16
// pairs; `v` holds the row's values in that type).
template <bool BF16>
__device__ __forceinline__ void store_g(Smem<BF16>& sm, int stage, int row, int half,
                                        const uint4& c, const uint32_t (&v)[3]) {
  uint4* dst = reinterpret_cast<uint4*>(&sm.a[stage][row][BF16 ? HALF / 2 * half : HALF * half]);
  if constexpr (BF16) {
    uint32_t w[HALF / 2];
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i)
      w[i] = pick(code_at(c, 2 * i), v) | (pick(code_at(c, 2 * i + 1), v) << 16);
#pragma unroll
    for (int q = 0; q < HALF / 8; ++q)
      dst[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < HALF / 4; ++q)
      dst[q] = make_uint4(pick(code_at(c, 4 * q), v), pick(code_at(c, 4 * q + 1), v),
                          pick(code_at(c, 4 * q + 2), v), pick(code_at(c, 4 * q + 3), v));
  }
}

// The BK x BP tile of y for samples k0.., traits p0.., into stage `stage`,
// zero-filled past n_y_rows and P, as one cp.async group.
template <bool BF16, bool VEC_Y>
__device__ __forceinline__ void stage_y(const Args& a, Smem<BF16>& sm, int stage, int k0,
                                        int p0, int tid) {
  constexpr int LDB = BF16 ? LDB_BF16 : LDB_F32;
  float* base = &sm.b[stage][0][0];
  if constexpr (VEC_Y) {
#pragma unroll
    for (int i = 0; i < BK * BP / 4 / THREADS; ++i) {
      const int c = tid + THREADS * i;
      const int row = c / (BP / 4);
      const int col = (c % (BP / 4)) * 4;
      const int n = k0 + row;
      const int p = p0 + col;
      const int bytes = n < a.n_y_rows ? 4 * max(0, min(4, a.P - p)) : 0;
      cp_async16(base + row * LDB + col, bytes ? a.y + (size_t)n * a.P + p : a.y, bytes);
    }
  } else {
    // Kept rolled: unrolled, the 16 copies' addresses spill registers.
#pragma unroll 1
    for (int i = 0; i < BK * BP / THREADS; ++i) {
      const int e = tid + THREADS * i;
      const int row = e / BP;
      const int col = e % BP;
      const int n = k0 + row;
      const int p = p0 + col;
      const bool ok = n < a.n_y_rows && p < a.P;
      cp_async4(base + row * LDB + col, ok ? a.y + (size_t)n * a.P + p : a.y, ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// One step of BK samples from stage `stage` into the warp's accumulators.
// fp32: per 8-sample slice, the three passes lo*hi, hi*lo, hi*hi in that
// order for every accumulator; the four fragments along P sit between two
// updates of one accumulator.
template <bool BF16>
__device__ __forceinline__ void compute(const Smem<BF16>& sm, int stage, int wm0, int wp0,
                                        int g, int t, float (&acc)[MF][NF][4]) {
  if constexpr (BF16) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t b[NF][2];
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int n = wp0 + j * 8 + g;
        b[j][0] = bf16_pair(sm.b[stage][kk + 2 * t][n], sm.b[stage][kk + 2 * t + 1][n]);
        b[j][1] = bf16_pair(sm.b[stage][kk + 2 * t + 8][n], sm.b[stage][kk + 2 * t + 9][n]);
      }
      const int w = kk / 2 + t;
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const int r = wm0 + i * 16 + g;
        const uint32_t af[4] = {sm.a[stage][r][w], sm.a[stage][r + 8][w],
                                sm.a[stage][r][w + 4], sm.a[stage][r + 8][w + 4]};
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_bf16(acc[i][j], af, b[j]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bh[NF][2], bl[NF][2];
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int n = wp0 + j * 8 + g;
        split_tf32(sm.b[stage][kk + t][n], bh[j][0], bl[j][0]);
        split_tf32(sm.b[stage][kk + t + 4][n], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const int r = wm0 + i * 16 + g;
        uint32_t ah[4], al[4];
        split_tf32(__uint_as_float(sm.a[stage][r][kk + t]), ah[0], al[0]);
        split_tf32(__uint_as_float(sm.a[stage][r + 8][kk + t]), ah[1], al[1]);
        split_tf32(__uint_as_float(sm.a[stage][r][kk + t + 4]), ah[2], al[2]);
        split_tf32(__uint_as_float(sm.a[stage][r + 8][kk + t + 4]), ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], al, bh[j]);
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], ah, bl[j]);
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(acc[i][j], ah, bh[j]);
      }
    }
  }
}

// total += acc (IEEE round-to-nearest), then acc = 0: the end of a chunk.
__device__ __forceinline__ void fold(float (&total)[MF][NF][4], float (&acc)[MF][NF][4]) {
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        total[i][j][e] = __fadd_rn(total[i][j][e], acc[i][j][e]);
        acc[i][j][e] = 0.f;
      }
}

template <bool BF16, bool FAST, bool VEC_Y>
__global__ void __launch_bounds__(THREADS, 1) gwas_dot_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<BF16>& sm = *reinterpret_cast<Smem<BF16>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;    // mma group: fragment row / trait
  const int t = lane & 3;     // thread in group: fragment column / sample
  const int m0 = blockIdx.y * BM;
  const int p0 = blockIdx.x * BP;
  const int wm0 = (warp >> 2) * WM;
  const int wp0 = (warp & 3) * WP;

  // Decoder role: row d_row, samples HALF * d_half .. + HALF - 1 of each
  // step.  The standardized values a code of this row can take are computed
  // once, exactly as the plain version computes them (bf16: rounded once).
  const int d_row = tid >> 1;
  const int d_half = tid & 1;
  const int gm = m0 + d_row;
  const bool row_ok = gm < a.M;
  const uint8_t* prow = a.packed + (size_t)(row_ok ? gm : 0) * a.packed_stride;
  uint32_t gv[3] = {0u, 0u, 0u};   // codes 0, 2, 3: dosages 2, 1, 0
  if (row_ok) {
    const float mu = a.mean[gm], istd = a.inv_std[gm];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float v = __fmul_rn(__fsub_rn((float)(2 - i), mu), istd);
      gv[i] = BF16 ? bf16_bits(v) : __float_as_uint(v);
    }
  }

  float acc[MF][NF][4];
  float total[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        total[i][j][e] = 0.f;
      }

  // The ring: y for step s + 2 is in flight while step s computes; the
  // packed bytes of step s + 2 are in registers and those of step s + 1 are
  // decoded into its stage after step s's mma.  One barrier per step.
  const int nsteps = (a.N + BK - 1) / BK;
  const int k_half = HALF * d_half;
  stage_y<BF16, VEC_Y>(a, sm, 0, 0, p0, tid);
  stage_y<BF16, VEC_Y>(a, sm, 1, BK, p0, tid);
  store_g<BF16>(sm, 0, d_row, d_half, fetch_codes<FAST>(a, prow, row_ok, k_half), gv);
  uint4 next = fetch_codes<FAST>(a, prow, row_ok, BK + k_half);
  cp_async_wait_one();
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    // Stages (s + 1) % 3 and (s + 2) % 3 were last read in steps s - 2 and
    // s - 1, which every warp finished before the barrier that ended them.
    uint4 later = next;
    if (s + 2 < nsteps) {
      stage_y<BF16, VEC_Y>(a, sm, (s + 2) % STAGES, (s + 2) * BK, p0, tid);
      later = fetch_codes<FAST>(a, prow, row_ok, (s + 2) * BK + k_half);
    } else {
      cp_async_commit();   // an empty group keeps the wait count uniform
    }
    compute<BF16>(sm, s % STAGES, wm0, wp0, g, t, acc);
    if (s + 1 < nsteps) store_g<BF16>(sm, (s + 1) % STAGES, d_row, d_half, next, gv);
    next = later;
    if ((s + 1) % CHUNK_STEPS == 0) fold(total, acc);
    cp_async_wait_one();   // y of step s + 1 has landed
    __syncthreads();
  }
  if (nsteps % CHUNK_STEPS) fold(total, acc);

  const bool pair_ok = (a.P & 1) == 0;   // float2 stores stay 8-byte aligned
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + i * 16 + g + 8 * h;
      if (m >= a.M) continue;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int p = p0 + wp0 + j * 8 + 2 * t;
        if (p >= a.P) continue;
        float r0, t0, r1, t1;
        epilogue(total[i][j][2 * h], a.n_samples, a.dof, a.eps, r0, t0);
        epilogue(total[i][j][2 * h + 1], a.n_samples, a.dof, a.eps, r1, t1);
        const size_t o = (size_t)m * a.P + p;
        if (pair_ok) {
          *reinterpret_cast<float2*>(a.r_out + o) = make_float2(r0, r1);
          *reinterpret_cast<float2*>(a.t_out + o) = make_float2(t0, t1);
        } else {
          a.r_out[o] = r0;
          a.t_out[o] = t0;
          if (p + 1 < a.P) {
            a.r_out[o + 1] = r1;
            a.t_out[o + 1] = t1;
          }
        }
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <bool BF16, bool FAST, bool VEC_Y>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t s) {
  // The ring exceeds the 48 KB of static shared memory: raise the kernel's
  // dynamic limit once per device.
  static bool raised[MAX_DEVICES] = {};
  constexpr int smem = sizeof(Smem<BF16>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(gwas_dot_kernel<BF16, FAST, VEC_Y>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  gwas_dot_kernel<BF16, FAST, VEC_Y><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch(const Args& a, bool fast, bool vec_y, dim3 grid, cudaStream_t s) {
  if (fast) return vec_y ? launch<BF16, true, true>(a, grid, s) : launch<BF16, true, false>(a, grid, s);
  return vec_y ? launch<BF16, false, true>(a, grid, s) : launch<BF16, false, false>(a, grid, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and returns
// the cudaError_t of the launch (0 on success); never synchronizes.
extern "C" int gwas_dot_launch(const void* packed, const void* mean,
                               const void* inv_std, const void* y, void* r_out,
                               void* t_out, int M, int N, int P, int n_y_rows,
                               int packed_stride, int block_n, float n_samples,
                               float dof, float eps, int bf16, void* stream) {
  if (M <= 0 || P <= 0) return 0;
  const Args a{static_cast<const uint8_t*>(packed), static_cast<const float*>(mean),
               static_cast<const float*>(inv_std), static_cast<const float*>(y),
               static_cast<float*>(r_out), static_cast<float*>(t_out),
               M, N, P, n_y_rows, packed_stride, block_n, n_samples, dof, eps};
  // Contiguous decode: a step's samples share one tile and one slot, and the
  // 16-byte loads stay aligned (rows are whole multiples of block_n/4 bytes).
  const bool fast = (block_n / 4) % BK == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  // 16-byte y copies need every row start 16-byte aligned.
  const bool vec_y = P % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((P + BP - 1) / BP, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? dispatch<true>(a, fast, vec_y, grid, s)
                               : dispatch<false>(a, fast, vec_y, grid, s));
}
