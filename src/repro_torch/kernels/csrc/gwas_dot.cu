// Fused 2-bit decode + standardize + GEMM + t epilogue for Hopper (sm_90a).
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
//   acc     sum over samples of g * y, in fp32
//   r, t    r = clip(acc / n_samples, -1, 1);
//           t = r * rsqrt(max(1 - r^2, eps) / dof)
// `n_samples` and `dof` are runtime arguments.  Rows of y past `n_y_rows`
// read as 0 (pad samples carry code 0b01, so g is 0 there anyway).
//
// Bound on an H100 SXM: operations.  The product is 2*M*N*P FLOP, run on the
// fp32 lanes outside the tensor cores (fp32 mode must not use TF32: r is held
// to 2e-6): 132 SMs x 128 lanes x 2 x ~1.98 GHz ~= 67 TFLOP/s.  One scan cell
// of the paper-sized slice (M=4096, N=23000, P=1024) is 1.93e11 FLOP, a floor
// of ~2.9 ms; it moves ~0.15 GB (packed codes, y, r, t), ~0.05 ms at 3.35 TB/s.
//
// Design (first version: simple and right).  One 256-thread block per
// BM x BP output tile; each thread keeps a TM x TP register micro-tile whose
// rows and columns are strided by 16, so the shared-memory reads of a warp
// are broadcasts or consecutive words.  A loop over the samples in steps of
// BK replaces the TPU grid's sequential k axis: each step decodes BM x BK
// codes straight from the packed bytes into shared memory as standardized
// fp32 (the dense g never exists in device memory: 16x fewer genotype bytes
// than a decode-then-GEMM), stages a BK x BP tile of y, and accumulates with
// IEEE fmaf.  The epilogue runs in registers and writes r and t once.
// No split-K and no atomics: every output element's sum runs over the
// samples in one fixed order whatever M, P or the grid, which is what keeps
// blocked == unblocked trait grids and sparse == dense epilogues bitwise.
// bf16 mode rounds g and y to bf16 (__float2bfloat16_rn) and multiplies and
// accumulates in fp32.  What this leaves on the table: the fp32 lanes are fed
// from shared memory with no double buffering, and the tensor cores are idle.
// A later redesign moves the bf16 mode onto wgmma with TMA-fed stages, and
// the fp32 mode onto a 3xTF32 split on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;   // markers per block
constexpr int BP = 128;   // traits per block
constexpr int BK = 8;     // samples per step
constexpr int TM = 8;     // markers per thread
constexpr int TP = 8;     // traits per thread
constexpr int THREADS = (BM / TM) * (BP / TP);   // 256

static_assert(THREADS == 256, "loaders below assume 256 threads");
static_assert(BM * BK == THREADS * 4, "each thread decodes 4 codes per step");
static_assert(BK * BP == THREADS * 4, "each thread stages 4 y values per step");

template <bool BF16>
__device__ __forceinline__ float round_input(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
gwas_dot_kernel(const uint8_t* __restrict__ packed,   // (M, packed_stride)
                const float* __restrict__ mean,       // (M,)
                const float* __restrict__ inv_std,    // (M,)
                const float* __restrict__ y,          // (n_y_rows, P)
                float* __restrict__ r_out,            // (M, P)
                float* __restrict__ t_out,            // (M, P)
                int M, int N, int P, int n_y_rows, int packed_stride,
                int block_n, float n_samples, float dof, float eps) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BP];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int p0 = blockIdx.x * BP;
  const int tx = tid % 16;   // trait lane: columns p0 + tx + 16 * j
  const int ty = tid / 16;   // marker lane: rows m0 + ty + 16 * i

  // Decoder role: row a_row, samples k0 + a_k .. k0 + a_k + 3.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int gm = m0 + a_row;
  const bool row_ok = gm < M;
  const float mu = row_ok ? mean[gm] : 0.f;
  const float istd = row_ok ? inv_std[gm] : 0.f;
  const uint8_t* prow = packed + (size_t)(row_ok ? gm : 0) * packed_stride;
  const int quarter = block_n >> 2;

  // y stager role: sample row k0 + b_k, traits p0 + b_p .. p0 + b_p + 3.
  const int b_k = tid >> 5;
  const int b_p = (tid & 31) * 4;

  float acc[TM][TP];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TP; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = k0 + a_k + j;
      float g = 0.f;
      if (row_ok && n < N) {
        const int tile = n / block_n;
        const int w = n - tile * block_n;
        const int slot = w / quarter;
        const int byte = tile * quarter + (w - slot * quarter);
        const int code = (prow[byte] >> (2 * slot)) & 3;
        const float dosage = (float)(2 - code + (code >> 1));
        g = (code == 1) ? 0.f : __fmul_rn(__fsub_rn(dosage, mu), istd);
      }
      As[a_k + j][a_row] = round_input<BF16>(g);
    }
    {
      const int n = k0 + b_k;
      const bool n_ok = n < n_y_rows;
      const float* yrow = y + (size_t)(n_ok ? n : 0) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + b_p + j;
        const float v = (n_ok && p < P) ? yrow[p] : 0.f;
        Bs[b_k][b_p + j] = round_input<BF16>(v);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TP];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TP; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TP; ++j) {
      const int p = p0 + tx + 16 * j;
      if (p >= P) continue;
      float r = __fdiv_rn(acc[i][j], n_samples);
      r = fminf(fmaxf(r, -1.f), 1.f);
      const float denom = fmaxf(__fsub_rn(1.f, __fmul_rn(r, r)), eps);
      const float t = __fmul_rn(r, rsqrtf(__fdiv_rn(denom, dof)));
      const size_t o = (size_t)m * P + p;
      r_out[o] = r;
      t_out[o] = t;
    }
  }
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
  const dim3 grid((P + BP - 1) / BP, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* mu = static_cast<const float*>(mean);
  const float* is = static_cast<const float*>(inv_std);
  const float* yy = static_cast<const float*>(y);
  float* r = static_cast<float*>(r_out);
  float* t = static_cast<float*>(t_out);
  if (bf16) {
    gwas_dot_kernel<true><<<grid, THREADS, 0, s>>>(pk, mu, is, yy, r, t, M, N, P, n_y_rows,
                                                   packed_stride, block_n, n_samples, dof, eps);
  } else {
    gwas_dot_kernel<false><<<grid, THREADS, 0, s>>>(pk, mu, is, yy, r, t, M, N, P, n_y_rows,
                                                    packed_stride, block_n, n_samples, dof, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
