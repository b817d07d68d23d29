// Fused windowed-DFT magnitude -> mel projection, hand-written for Hopper
// (sm_90a), FFMA in float32.
//
// Replaces the TPU kernel nisqa_tpu/ops/pallas_mel.py::fused_dft_mel
// (body _mel_kernel). Same contract:
//
//   out[n, m] = sum_k |sum_s frames[n, s] * (w_re[s, k] + i * w_im[s, k])| * fb[k, m]
//
// frames (N, span), w_re / w_im (span, K), fb (K, M), out (N, M), all
// contiguous float32. The analysis window, the 1/32768 PCM16 scale and the
// DFT cos / -sin terms are folded into w_re / w_im by the host
// (nisqa_tpu_torch/data/pipeline.py::front_end_consts).
//
// What bounds it on an H100: at 48 kHz (span 960, K 1,792 kept bins, M 48)
// one frame row costs 4 * span * K = 6.9 MFLOP of DFT against 3.8 KB of
// frame read, so the kernel is compute-bound by a wide margin; w_re + w_im
// are 13.8 MB and stay resident in the 50 MB L2. The (N, K) re / im / |.|
// products are the only large intermediates, and they never leave the SM.
//
// Design (right and simple first; tensor cores, TMA and reading frames
// straight from the strided audio buffer are later work):
//   * one block owns TR = 64 frame rows and loops over ALL K tiles itself
//     (the TPU's sequential k grid axis with a revisited output block has no
//     GPU counterpart: blocks run in parallel, in no order);
//   * for each K tile of TK = 64 bins, the span contraction runs in chunks
//     of TS = 16 samples staged in shared memory (64 rows x 960 x 4 B would
//     not fit in 227 KB), and each thread accumulates a 4 x 4 re / im
//     micro-tile in registers;
//   * the magnitude tile goes to shared memory, is multiplied by the matching
//     fb tile and added into a (TR, M) mel accumulator in shared memory that
//     lives for the whole K loop; every accumulator element has one owning
//     thread, so there are no atomics and the result is deterministic;
//   * ragged N, K and span edges are masked on load (zero frames / weights /
//     filter rows contribute exactly zero), so no padding is needed;
//   * fast mode (BF16 = true) rounds every frames and w operand to bf16 with
//     __float2bfloat16_rn before the FFMA: bf16 x bf16 products are exact in
//     float32, so this is "bf16 operands, f32 accumulation". Exact mode uses
//     plain float32 FFMA (never TF32). The mel projection is float32 in both.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 64;          // frame rows per block
constexpr int TK = 64;          // DFT bins per K tile
constexpr int TS = 16;          // span samples per shared-memory chunk
constexpr int RM = 4;           // rows per thread
constexpr int KM = 4;           // bins per thread
constexpr int THREADS = (TR / RM) * (TK / KM);  // 256
constexpr int FS_LD = TR + 4;   // transposed frames chunk, padded against bank conflicts
constexpr int MAG_LD = TK + 1;  // magnitude tile, padded against bank conflicts
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB of dynamic shared memory per block

size_t smem_bytes(int m) {
  return sizeof(float) * (size_t(TS) * FS_LD + 2 * size_t(TS) * TK + size_t(TR) * MAG_LD +
                          size_t(TK) * m + size_t(TR) * m);
}

template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
dft_mel_kernel(const float* __restrict__ frames, const float* __restrict__ w_re,
               const float* __restrict__ w_im, const float* __restrict__ fb,
               float* __restrict__ out, int64_t n, int span, int k_total, int m) {
  extern __shared__ __align__(16) float smem[];
  float* fs = smem;                // [TS][FS_LD]  frames chunk, transposed
  float* wrs = fs + TS * FS_LD;    // [TS][TK]
  float* wis = wrs + TS * TK;      // [TS][TK]
  float* mag = wis + TS * TK;      // [TR][MAG_LD]
  float* fbs = mag + TR * MAG_LD;  // [TK][m]
  float* acc = fbs + TK * m;       // [TR][m]     mel accumulator

  const int tid = threadIdx.x;
  const int tx = tid % (TK / KM);  // bin group: bins tx*KM .. +KM-1 of the tile
  const int ty = tid / (TK / KM);  // row group: rows ty*RM .. +RM-1 of the tile
  const int64_t row0 = int64_t(blockIdx.x) * TR;

  for (int e = tid; e < TR * m; e += THREADS) acc[e] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += TK) {
    float re[RM][KM], im[RM][KM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KM; ++j) re[i][j] = im[i][j] = 0.f;

    for (int s0 = 0; s0 < span; s0 += TS) {
      // stage the (TR, TS) frames chunk transposed: consecutive threads read
      // consecutive samples of one row (coalesced)
      for (int e = tid; e < TR * TS; e += THREADS) {
        const int r = e / TS, s = e % TS;
        const int64_t row = row0 + r;
        const int col = s0 + s;
        const float v = (row < n && col < span) ? frames[row * span + col] : 0.f;
        fs[s * FS_LD + r] = operand<BF16>(v);
      }
      // stage the (TS, TK) w_re / w_im chunks: consecutive threads read
      // consecutive bins of one sample row (coalesced, L2-resident)
      for (int e = tid; e < TS * TK; e += THREADS) {
        const int s = e / TK, k = e % TK;
        const int srow = s0 + s, kcol = k0 + k;
        const bool ok = srow < span && kcol < k_total;
        const int64_t g = int64_t(srow) * k_total + kcol;
        wrs[e] = operand<BF16>(ok ? w_re[g] : 0.f);
        wis[e] = operand<BF16>(ok ? w_im[g] : 0.f);
      }
      __syncthreads();

#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(&fs[s * FS_LD + ty * RM]);
        const float4 br = *reinterpret_cast<const float4*>(&wrs[s * TK + tx * KM]);
        const float4 bi = *reinterpret_cast<const float4*>(&wis[s * TK + tx * KM]);
        const float av[RM] = {a.x, a.y, a.z, a.w};
        const float brv[KM] = {br.x, br.y, br.z, br.w};
        const float biv[KM] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < KM; ++j) {
            re[i][j] = fmaf(av[i], brv[j], re[i][j]);
            im[i][j] = fmaf(av[i], biv[j], im[i][j]);
          }
      }
      __syncthreads();
    }

    // |re + i im| for this K tile; masked bins are exactly 0
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KM; ++j)
        mag[(ty * RM + i) * MAG_LD + tx * KM + j] =
            sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
    for (int e = tid; e < TK * m; e += THREADS) {
      const int kcol = k0 + e / m;
      fbs[e] = kcol < k_total ? fb[int64_t(kcol) * m + e % m] : 0.f;
    }
    __syncthreads();

    // mel += mag @ fb_tile; each accumulator element has one owner thread
    for (int e = tid; e < TR * m; e += THREADS) {
      const int r = e / m, mm = e % m;
      float sum = acc[e];
      for (int k = 0; k < TK; ++k) sum = fmaf(mag[r * MAG_LD + k], fbs[k * m + mm], sum);
      acc[e] = sum;
    }
    __syncthreads();
  }

  for (int e = tid; e < TR * m; e += THREADS) {
    const int64_t row = row0 + e / m;
    if (row < n) out[row * m + e % m] = acc[e];
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` without synchronising. Returns a
// cudaError_t code (0 = launched).
int nisqa_dft_mel(const void* frames, const void* w_re, const void* w_im, const void* fb,
                  void* out, int64_t n, int span, int k_total, int m, int bf16,
                  void* stream) {
  if (n <= 0 || span <= 0 || k_total <= 0 || m <= 0) return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(m);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  const int64_t blocks = (n + TR - 1) / TR;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);

  void (*kernel)(const float*, const float*, const float*, const float*, float*, int64_t,
                 int, int, int) = bf16 ? dft_mel_kernel<true> : dft_mel_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(unsigned(blocks)), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(w_re),
      static_cast<const float*>(w_im), static_cast<const float*>(fb),
      static_cast<float*>(out), n, span, k_total, m);
  return int(cudaGetLastError());
}

const char* nisqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
