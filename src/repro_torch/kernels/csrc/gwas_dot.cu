// Fused 2-bit decode + standardize + GEMM + t epilogue for Hopper (sm_90a),
// on warpgroup tensor-core products (wgmma) fed by TMA through an mbarrier
// ring.
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
// Only wgmma reaches those rates.  Around it, what costs is turning codes
// into tensor-core operands: in the mma.sync kernel this replaces, a
// constant in place of the decode cut the bf16 time by 39% (PERF.md §6).
//
// Design.
// * Sample order.  The kernel walks each row's packed bytes in order, a
//   stage at a time (16 bytes = 64 samples bf16, 8 bytes = 32 samples fp32),
//   using each byte's four codes at once (`byte_slot`): the loads carry no
//   unused bits and the decode no runtime shift.  The product's sample order
//   is therefore a permutation of the samples, fixed by block_n.
// * Prologue.  `trait_operand_kernel` writes y once per call, in that order,
//   into a scratch buffer the wrapper allocates: (P_pad, K_pad), samples
//   contiguous (wgmma takes a tf32 B only K-major), zero past n_y_rows, the
//   packed bytes and P, in the type the tensor cores take: bf16, or two tf32
//   planes hi = tf32_rna(y), lo = tf32_rna(y - hi) (rows P_pad.. hold lo).
// * Block.  128 markers x 128 traits; three warpgroups.  Warpgroups 0 and 1
//   are consumers, 64 marker rows each (wgmma m64n128); warpgroup 2 is the
//   producer, whose one thread keeps TMA loads (cp.async.bulk.tensor.2d,
//   128-byte swizzle) of the trait tiles in flight through a ring of STAGES
//   stages with full and empty mbarriers.  setmaxnreg gives the producer's
//   registers to the consumers.  No __syncthreads in the loop.
// * A in registers.  wgmma takes A from registers for bf16 and tf32.  A
//   thread's rows are fixed (g and g + 8 of its warp's 16), so their three
//   standardized values are computed once (fp32 mode: their hi/lo words too)
//   and a code becomes an A element by a byte permute from a 4-entry table
//   (bf16) or a select (tf32): no shared-memory round trip, no split per
//   fragment.  In bf16 mode, when rows hold whole 16-byte stages, the
//   producer's TMA brings each stage's code tile (128 rows x 16 bytes) into
//   the ring beside the trait tile, and a thread reads its 4 bytes of a row
//   from shared memory; otherwise (fp32 mode, or rows of other lengths)
//   each thread loads its bytes straight from global memory, two stages
//   ahead.
// * Two-level accumulation.  Tensor cores do not round their internal adds
//   to nearest, and an accumulator that runs on over many samples drifts
//   (tests/test_torch_kernels.py emulates this).  So the wgmma accumulators
//   restart every chunk of CHUNK stages (KC = 256 samples bf16, 32 fp32)
//   through the first wgmma's scale-d = 0, after wgmma.wait_group 0, and are
//   added into an fp32 total with __fadd_rn.  Inside a chunk a stage's
//   products are issued while the previous stage's still run.  A chunk is a
//   fixed set of samples (its bytes of the row) and the fp32 passes run in
//   one fixed order (lo*hi, hi*lo, hi*hi per k8 slice), so every output
//   element sums in one order whatever M, P or the grid: no split-K, no
//   atomics, and blocked == unblocked trait grids and sparse == dense
//   epilogues stay bitwise.  While one consumer warpgroup folds, the other's
//   products keep the tensor cores busy.
// * The epilogue runs on the totals in registers with explicit IEEE
//   rounding and stores adjacent columns as float2, masked at the edges.

#include <cuda.h>   // CUtensorMap and its enums only: the encoder is reached
                    // through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // markers per block
constexpr int BP = 128;            // traits per block (the wgmma's N)
constexpr int CONSUMERS = 2;       // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int ROW_BYTES = 128;     // one swizzle row: a tile row of samples
constexpr int TILE_BYTES = BP * ROW_BYTES;
constexpr int STAGES = 4;          // ring depth

// Per mode: SK samples a stage (one 128-byte row of the type), the codes
// of BYTES packed bytes of each row at all four slots; BPT of those bytes
// per thread; CHUNK stages an accumulator chunk (KC = CHUNK * SK samples);
// PLANES tiles a stage.
template <bool BF16>
struct Mode {
  static constexpr int SK = BF16 ? 64 : 32;
  static constexpr int BYTES = SK / 4;
  static constexpr int BPT = BYTES / 4;
  static constexpr int CHUNK = BF16 ? 4 : 1;
  static constexpr int PLANES = BF16 ? 1 : 2;
  static constexpr int STAGE_BYTES = PLANES * TILE_BYTES;
  // bf16 with whole 16-byte stages: a stage's codes come by TMA too
  static constexpr int CODE_BYTES = BF16 ? BM * BYTES : 0;
};

struct Args {
  const uint8_t* packed;   // (M, packed_stride)
  const float* mean;       // (M,)
  const float* inv_std;    // (M,)
  float* r_out;            // (M, P)
  float* t_out;            // (M, P)
  int M, P, packed_stride, block_n;
  float n_samples, dof, eps;
};

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero) as integer
// operations: add half a tf32 ulp to the magnitude bits, clear the low 13.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The sample order.  The kernel walks each row's packed bytes in order:
// stage s takes bytes BYTES*s .. BYTES*s + BYTES-1, each at its four 2-bit
// slots, and thread t of a group of four takes BPT of them.  wgmma's A
// fragment gives thread t, per k-slice j, the slice's columns {2t, 2t+1,
// 2t+8, 2t+9} (k16, bf16) or {t, t+4} (k8, tf32); element e of those is the
// code at slot j of the thread's byte e.  So logical column `col` of a stage
// holds the sample at (byte, slot) = byte_slot(col), and the tile-local
// layout puts byte B, slot j at sample (B / q) * block_n + j * q + B % q
// (q = block_n / 4).  The prologue writes y in that order; the codes need no
// shift by a runtime slot, and every byte loaded is used whole.
template <bool BF16>
__device__ __forceinline__ void byte_slot(int col, int& byte, int& slot) {
  if constexpr (BF16) {   // col = 16j + 2t + (e & 1) + 8 (e >> 1)
    const int j = col >> 4, c = col & 15;
    const int t = (c & 7) >> 1, e = (c & 1) + 2 * (c >> 3);
    byte = 4 * t + e;
    slot = j;
  } else {                // col = 8j + t + 4e
    const int j = col >> 3, t = col & 3, e = (col >> 2) & 1;
    byte = 2 * t + e;
    slot = j;
  }
}

// ------------------------------------------------------------------ prologue

// y (n_y_rows, P) fp32 -> scratch (PLANES * P_pad, K_pad): row p, logical
// column k holds y[n][p] for the sample n that column k stands for (the
// sample order above), zero past n_y_rows, past the packed bytes and past
// P.  One block per 64 logical columns x 64 traits, through shared memory:
// gathered by logical column, then written transposed.
template <bool BF16>
__global__ void __launch_bounds__(256) trait_operand_kernel(const float* __restrict__ y,
                                                            void* __restrict__ out, int n_y_rows,
                                                            int P, int P_pad, int K_pad,
                                                            int packed_stride, int block_n) {
  constexpr int SK = Mode<BF16>::SK;
  __shared__ float s[64][65];
  const int n0 = blockIdx.x * 64;
  const int p0 = blockIdx.y * 64;
  const int c = threadIdx.x & 63;
  const int r = threadIdx.x >> 6;
  const int quarter = block_n >> 2;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int k = n0 + r + 4 * i;
    int byte, slot;
    byte_slot<BF16>(k % SK, byte, slot);
    byte += (k / SK) * Mode<BF16>::BYTES;
    const int tile = byte / quarter;
    const int n = tile * block_n + slot * quarter + (byte - tile * quarter);
    const int p = p0 + c;
    s[r + 4 * i][c] =
        (byte < packed_stride && n < n_y_rows && p < P) ? y[(size_t)n * P + p] : 0.f;
  }
  __syncthreads();
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int pr = r + 4 * i;
    const float v = s[c][pr];
    const size_t o = (size_t)(p0 + pr) * K_pad + n0 + c;
    if constexpr (BF16) {
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
    } else {
      const uint32_t hi = tf32_rna(v);
      uint32_t* w = static_cast<uint32_t*>(out);
      w[o] = hi;
      w[(size_t)P_pad * K_pad + o] = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
    }
  }
}

// ------------------------------------------------------- barriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte swizzle
// (layout 1): 8-row atoms of 128-byte rows, 1024 bytes apart (SBO); the tile
// is 1024-byte aligned, so a k-slice starts at +32 bytes a slice.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above the wait.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WGMMA_D_OPERANDS                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),             \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),             \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),             \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),             \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),             \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),             \
      "+f"(d[62]), "+f"(d[63])

// d (64 x 128, fp32) = A (64 x 16, bf16, registers) * B (16 x 128, bf16,
// K-major in shared memory) + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D
      ", {%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : WGMMA_D_OPERANDS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

// The same with tf32 operands, k = 8.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WGMMA_D
      ", {%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : WGMMA_D_OPERANDS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

// ------------------------------------------------------------------- decode

// A thread's BPT packed bytes of a stage, for rows g and g + 8 (a code at
// each of a byte's four 2-bit slots).  Rows past M have a zero table, so
// what they read does not matter; bytes past the row read as missing.
struct Codes {
  uint32_t w[2];
};

// Non-coherent loads kept where they are written (volatile): the codes of
// stage s + 2 are requested before stage s's products, not next to their use.
__device__ __forceinline__ uint32_t ld_codes4(const uint8_t* p) {
  uint32_t w;
  asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(w) : "l"(p));
  return w;
}
__device__ __forceinline__ uint32_t ld_codes2(const uint8_t* p) {
  unsigned short h;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(h) : "l"(p));
  return h;
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t w;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(w) : "r"(addr));
  return w;
}

// FAST: every row holds whole stages and the loads are aligned; else a
// bounded byte walk.
template <bool BF16, bool FAST>
__device__ __forceinline__ Codes fetch_codes(const Args& a, const uint8_t* const (&prow)[2],
                                             int s, int t) {
  constexpr int BPT = Mode<BF16>::BPT;
  const int byte = Mode<BF16>::BYTES * s + BPT * t;
  Codes c;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (FAST) {
      c.w[r] = BPT == 4 ? ld_codes4(prow[r] + byte) : ld_codes2(prow[r] + byte);
    } else {
      uint32_t w = 0u;
#pragma unroll
      for (int i = 0; i < BPT; ++i)
        w |= (byte + i < a.packed_stride ? (uint32_t)prow[r][byte + i] : 0x55u) << (8 * i);
      c.w[r] = w;
    }
  }
  return c;
}

// A code's standardized value: code 0 -> v[0] (dosage 2), 1 -> 0 (missing),
// 2 -> v[1] (dosage 1), 3 -> v[2] (dosage 0).
__device__ __forceinline__ uint32_t pick(uint32_t code, const uint32_t (&v)[3]) {
  return (code & 2u) ? ((code & 1u) ? v[2] : v[1]) : ((code & 1u) ? 0u : v[0]);
}

// bf16: a stage's A fragments, 4 k16 slices.  Slice j takes slot j of the
// thread's 4 bytes of row r: bytes e = 0, 1 fill register 0 (row g) / 1
// (row g + 8), bytes 2, 3 register 2 / 3.  A byte permute picks each bf16
// from the row's table of four (code c at bytes 2c, 2c + 1); its selector
// is 34 c + 16 per byte.
__device__ __forceinline__ void decode_bf16(const Codes& c, const uint32_t (&lut_lo)[2],
                                            const uint32_t (&lut_hi)[2], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t codes = (c.w[r] >> (2 * j)) & 0x03030303u;
      const uint32_t sel = codes * 34u + 0x10101010u;
      a[j][r] = __byte_perm(lut_lo[r], lut_hi[r], sel);
      a[j][2 + r] = __byte_perm(lut_lo[r], lut_hi[r], sel >> 16);
    }
  }
}

// tf32: a stage's hi and lo A fragments, 4 k8 slices.  Slice j takes slot j
// of the thread's 2 bytes: byte 0 (column t: registers 0 / 1 for rows g /
// g + 8) and byte 1 (column t + 4: registers 2 / 3).
__device__ __forceinline__ void decode_tf32(const Codes& c, const uint32_t (&vh)[2][3],
                                            const uint32_t (&vl)[2][3], uint32_t (&ah)[4][4],
                                            uint32_t (&al)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t code = (c.w[r] >> (8 * e + 2 * j)) & 3u;
        ah[j][2 * e + r] = pick(code, vh[r]);
        al[j][2 * e + r] = pick(code, vl[r]);
      }
    }
  }
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

// -------------------------------------------------------------- main kernel

template <bool BF16, bool FAST>
__global__ void __launch_bounds__(THREADS, 1)
    gwas_dot_kernel(const __grid_constant__ CUtensorMap ymap,
                    const __grid_constant__ CUtensorMap cmap, const Args a, int P_pad) {
  using MD = Mode<BF16>;
  constexpr bool TMA_CODES = BF16 && FAST;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment: the launcher adds the slack
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  const uint32_t codes = tiles + STAGES * MD::STAGE_BYTES;   // TMA_CODES: (BM, BYTES) a stage
  const uint32_t bars = codes + STAGES * MD::CODE_BYTES;     // full[STAGES], empty[STAGES]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int m0 = blockIdx.y * BM;
  const int p0 = blockIdx.x * BP;
  const int nst = (a.packed_stride + MD::BYTES - 1) / MD::BYTES;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring's TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < nst; ++s) {
        mbar_wait(empty(stage), phase ^ 1u);
        mbar_expect_tx(full(stage), MD::STAGE_BYTES + (TMA_CODES ? MD::CODE_BYTES : 0));
#pragma unroll
        for (int pl = 0; pl < MD::PLANES; ++pl)
          tma_load_2d(tiles + stage * MD::STAGE_BYTES + pl * TILE_BYTES, &ymap, full(stage),
                      s * MD::SK, pl * P_pad + p0);
        if constexpr (TMA_CODES)
          tma_load_2d(codes + stage * MD::CODE_BYTES, &cmap, full(stage), s * MD::BYTES, m0);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---- consumers: rows g and g + 8 of the warp's 16 of the warpgroup's 64
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid & 31;
    const int warp = (tid >> 5) & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = m0 + wg * 64 + warp * 16 + g;
    const uint8_t* prow[2];
    // the rows' values for codes 0, 2, 3 (dosages 2, 1, 0), computed once
    // exactly as the plain version computes them; rows past M stay 0
    float v[2][3];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gm = row0 + 8 * r;
      const bool ok = gm < a.M;
      prow[r] = a.packed + (size_t)(ok ? gm : 0) * a.packed_stride;
      const float mu = ok ? a.mean[gm] : 0.f, istd = ok ? a.inv_std[gm] : 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) v[r][i] = ok ? __fmul_rn(__fsub_rn((float)(2 - i), mu), istd) : 0.f;
    }
    uint32_t lut_lo[2], lut_hi[2];        // bf16: codes 0, 1 | codes 2, 3
    uint32_t vh[2][3], vl[2][3];          // fp32: the values' tf32 hi and lo
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lut_lo[r] = bf16_bits(v[r][0]);
      lut_hi[r] = bf16_bits(v[r][1]) | (bf16_bits(v[r][2]) << 16);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        vh[r][i] = tf32_rna(v[r][i]);
        vl[r][i] = tf32_rna(__fsub_rn(v[r][i], __uint_as_float(vh[r][i])));
      }
    }

    float acc[64], total[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      total[i] = 0.f;
    }

    // without TMA, the codes of stage s + 2 are in flight while stage s
    // computes
    Codes cur = {}, next = {};
    if constexpr (!TMA_CODES) {
      if (nst > 0) cur = fetch_codes<BF16, FAST>(a, prow, 0, t);
      if (nst > 1) next = fetch_codes<BF16, FAST>(a, prow, 1, t);
    }
    // this thread's bytes of rows g and g + 8 in a stage's code tile
    const uint32_t code_at = codes + (wg * 64 + warp * 16 + g) * MD::BYTES + MD::BPT * t;
    // A chunk of CHUNK stages: per stage, decode its A fragments into `ah`
    // (bf16, or the tf32 hi words) and `al` (the tf32 lo words), wait for
    // its trait tiles, issue its products; the previous stage's products
    // may still run (their A registers are the other buffer), and
    // wait_group 1 then frees that stage's tiles.  The chunk's end waits for
    // all, frees the last stage and folds.  The chunk is unrolled, so ptxas
    // sees every read of the accumulators after wait_group 0.
    int stage = 0;
    uint32_t phase = 0;
    uint32_t a0h[4][4], a0l[4][4], a1h[4][4], a1l[4][4];
    for (int s0 = 0; s0 < nst; s0 += MD::CHUNK) {
      int prev = stage;
#pragma unroll
      for (int c = 0; c < MD::CHUNK; ++c) {
        const int s = s0 + c;
        if (s >= nst) break;
        uint32_t(&ah)[4][4] = (c & 1) ? a1h : a0h;
        uint32_t(&al)[4][4] = (c & 1) ? a1l : a0l;
        Codes later = next;
        if constexpr (!TMA_CODES) {
          if (s + 2 < nst) later = fetch_codes<BF16, FAST>(a, prow, s + 2, t);
        }
        const uint32_t tile = tiles + stage * MD::STAGE_BYTES;
        if constexpr (TMA_CODES) {
          mbar_wait(full(stage), phase);
          const uint32_t at = code_at + stage * MD::CODE_BYTES;
          cur.w[0] = lds_u32(at);
          cur.w[1] = lds_u32(at + 8 * MD::BYTES);
          decode_bf16(cur, lut_lo, lut_hi, ah);
        } else {
          if constexpr (BF16) {
            decode_bf16(cur, lut_lo, lut_hi, ah);
          } else {
            decode_tf32(cur, vh, vl, ah, al);
          }
          mbar_wait(full(stage), phase);
        }
        wgmma_fence();
        if constexpr (BF16) {
          const uint64_t b = smem_desc(tile);
#pragma unroll
          for (int j = 0; j < 4; ++j) wgmma_bf16(acc, ah[j], b + 2 * j, j > 0 || c > 0);
        } else {
          const uint64_t bh = smem_desc(tile);
          const uint64_t bl = smem_desc(tile + TILE_BYTES);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wgmma_tf32(acc, al[j], bh + 2 * j, j > 0 || c > 0);
            wgmma_tf32(acc, ah[j], bl + 2 * j, 1);
            wgmma_tf32(acc, ah[j], bh + 2 * j, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (c > 0 && lane == 0) mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
        cur = next;
        next = later;
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty(prev));
      // the end of a chunk: total += acc, rounded to nearest
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] = __fadd_rn(total[i], acc[i]);
    }

    // total[4i + 2h + e]: row g + 8h, column 8i + 2t + e of the warp's tile
    const bool pair_ok = (a.P & 1) == 0;   // float2 stores stay 8-byte aligned
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= a.M) continue;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int p = p0 + 8 * i + 2 * t;
        if (p >= a.P) continue;
        float r0, t0, r1, t1;
        epilogue(total[4 * i + 2 * h], a.n_samples, a.dof, a.eps, r0, t0);
        epilogue(total[4 * i + 2 * h + 1], a.n_samples, a.dof, a.eps, r1, t1);
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

// ------------------------------------------------------------------ launch

constexpr int MAX_DEVICES = 64;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The main kernel's dynamic shared memory: the ring, its barriers, and the
// slack that aligns the ring to 1024 bytes.
template <bool BF16>
constexpr int smem_bytes() {
  return STAGES * (Mode<BF16>::STAGE_BYTES + Mode<BF16>::CODE_BYTES + 16) + 1024;
}

template <bool BF16, bool FAST>
cudaError_t launch(const CUtensorMap& ymap, const CUtensorMap& cmap, const Args& a, int P_pad,
                   dim3 grid, cudaStream_t s) {
  // The ring exceeds the 48 KB of static shared memory: raise the kernel's
  // dynamic limit once per device.
  static bool raised[MAX_DEVICES] = {};
  constexpr int smem = smem_bytes<BF16>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(gwas_dot_kernel<BF16, FAST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  gwas_dot_kernel<BF16, FAST><<<grid, THREADS, smem, s>>>(ymap, cmap, a, P_pad);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t run(const Args& a, const float* y, void* scratch, int n_y_rows, cudaStream_t s) {
  using MD = Mode<BF16>;
  const int P_pad = (a.P + BP - 1) / BP * BP;
  // samples padded to 64: every 16 packed bytes of a row hold 64
  const int K_pad = (a.packed_stride + 15) / 16 * 64;
  // Every row holds whole stages, so the loads stay inside it and aligned.
  const bool fast = a.packed_stride % MD::BYTES == 0 &&
                    reinterpret_cast<uintptr_t>(a.packed) % 16 == 0;
  CUtensorMap ymap = {}, cmap = {};
  if (K_pad > 0) {
    trait_operand_kernel<BF16><<<dim3(K_pad / 64, P_pad / 64), 256, 0, s>>>(
        y, scratch, n_y_rows, a.P, P_pad, K_pad, a.packed_stride, a.block_n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    EncodeTiled encode = encoder();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    const cuuint64_t dims[2] = {(cuuint64_t)K_pad, (cuuint64_t)MD::PLANES * P_pad};
    const cuuint64_t strides[1] = {(cuuint64_t)K_pad * (BF16 ? 2 : 4)};
    const cuuint32_t box[2] = {(cuuint32_t)MD::SK, (cuuint32_t)BP};
    const cuuint32_t unit[2] = {1, 1};
    CUresult res = encode(&ymap,
                          BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          2, scratch, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
    if (BF16 && fast) {
      // the codes, (M, packed_stride) bytes, a stage's BYTES of BM rows a
      // box; rows past M read as zeros (their table is zero)
      const cuuint64_t cdims[2] = {(cuuint64_t)a.packed_stride, (cuuint64_t)a.M};
      const cuuint64_t cstrides[1] = {(cuuint64_t)a.packed_stride};
      const cuuint32_t cbox[2] = {(cuuint32_t)MD::BYTES, (cuuint32_t)BM};
      res = encode(&cmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<uint8_t*>(a.packed),
                   cdims, cstrides, cbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
    }
  }
  const dim3 grid(P_pad / BP, (a.M + BM - 1) / BM);
  return fast ? launch<BF16, true>(ymap, cmap, a, P_pad, grid, s)
              : launch<BF16, false>(ymap, cmap, a, P_pad, grid, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Writes the trait operand into
// `scratch` (bf16 (P_pad, K_pad), or float32 (2 * P_pad, K_pad) in fp32
// mode; P_pad = P rounded up to 128, K_pad = 4 * packed_stride up to 64),
// then launches the main kernel, both on `stream`.  Returns the first
// cudaError_t (0 on success); never synchronizes.
extern "C" int gwas_dot_launch(const void* packed, const void* mean, const void* inv_std,
                               const void* y, void* scratch, void* r_out, void* t_out, int M,
                               int P, int n_y_rows, int packed_stride, int block_n,
                               float n_samples, float dof, float eps, int bf16, void* stream) {
  if (M <= 0 || P <= 0) return 0;
  const Args a{static_cast<const uint8_t*>(packed), static_cast<const float*>(mean),
               static_cast<const float*>(inv_std), static_cast<float*>(r_out),
               static_cast<float*>(t_out), M, P, packed_stride, block_n,
               n_samples, dof, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  return static_cast<int>(bf16 ? run<true>(a, yf, scratch, n_y_rows, s)
                               : run<false>(a, yf, scratch, n_y_rows, s));
}

// The main kernel's dynamic shared memory in bytes, for reports.
extern "C" int gwas_dot_smem_bytes(int bf16) {
  return bf16 ? smem_bytes<true>() : smem_bytes<false>();
}
