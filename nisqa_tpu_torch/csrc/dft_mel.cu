// Fused windowed-DFT magnitude -> mel projection on Hopper's tensor cores
// (sm_90a): TMA + mbarrier ring, warp-specialised wgmma, fused epilogue.
//
// Replaces the TPU kernel nisqa_tpu/ops/pallas_mel.py::fused_dft_mel
// (body _mel_kernel). Same contract:
//
//   out[n, m] = sum_k |sum_s frames[n, s] * (w_re[s, k] + i * w_im[s, k])| * fb[k, m]
//
// The host lays the constants out for this kernel once per constant set
// (nisqa_tpu_torch/ops/dft_mel.py::prepare_consts):
//   * w (2*Kp, Sp): K-major and re/im interleaved, row 2j = w_re[:, j],
//     row 2j+1 = w_im[:, j]; K padded to Kp (a multiple of 64 bins) and span
//     to Sp (a multiple of 64) with zeros, which contribute exactly 0;
//   * fast mode: w in bf16; exact mode: w_hi / w_lo in float32, the TF32
//     split of w (hi = rna_tf32(w), lo = rna_tf32(w - hi));
//   * fb (Kp, M) float32, zero rows for the padding;
//   * the chunked plan: the mel bands in chunks of MEL_CHUNK = 64, chunk c
//     holding bands [64c, min(64c + 64, M)); chunk_tiles (T', 4) int32 rows
//     (K tile, m_lo, m_hi, t), chunk c's at chunk_start[c] .. chunk_start[c+1]:
//     every 64-bin K tile whose filterbank rows are nonzero somewhere in
//     the chunk, in K order, [m_lo, m_hi) its band range clipped to the
//     chunk, t its index in the one-chunk list of such tiles. Up to 64
//     bands there is one chunk and the plan is that list.
//
// What bounds it on an H100: each block re-reads its frame rows once per K
// tile, and every w tile is read once per row tile. At 48 kHz (span 960,
// 1,792 kept bins, N 166,752) that is 17 GB (fast) and 51 GB (exact) of
// L2 -> SM traffic against 1.15 TFLOP of bf16 (3.4 of TF32). A copy of the
// main loop with the wgmmas taken out ran in about 70% (fast) and 63%
// (exact) of the kernel's time, so that traffic bounds it first, and the
// partial overlap of loads and wgmmas (each warpgroup waits for its chunk's
// wgmmas before the next) second. Next levers: frames read by TMA
// straight from the strided i16 audio buffer, cluster TMA multicast of w,
// a persistent grid.
//
// Design:
//   * DFT as one GEMM, frames (N, span) x w^T, on wgmma m64n128: each block
//     owns BM = 128 frame rows (two consumer warpgroups of 64) and loops over
//     its K tiles; each K tile is 128 interleaved columns = 64 bins, so a
//     thread's accumulator pairs (d[2i], d[2i+1]) are the re / im of one bin;
//   * fast mode: bf16 x bf16 -> f32 (the twin's bf16 operands: products are
//     exact in f32, only the summation order differs);
//   * the tensor cores' float32 accumulation rounds more coarsely than IEEE
//     (on an H100, exact mode was 6e-6 of max off when one accumulator
//     ran over the whole span); so each span chunk's wgmmas start from zero
//     and the chunk's partial is added into a second register accumulator
//     with IEEE float32 adds;
//   * exact mode: 3xTF32, d += a_hi*w_lo + a_lo*w_hi + a_hi*w_hi. The
//     frames tile arrives in float32; each consumer warpgroup splits its own
//     64 rows in shared memory (hi in place, lo beside it) with
//     cvt.rna.tf32.f32 before its wgmmas. A single TF32 pass is 2e-4 off
//     (relative to max) and is never used;
//   * one producer warp streams (frames, w) span chunks of 128 bytes per row
//     through a ring of STAGES shared-memory slots with TMA (128-byte
//     swizzle, the wgmma descriptors' layout) and full / empty mbarriers;
//   * epilogue per K tile, on the accumulators: |re + i im| in registers,
//     then the mel step in float32 FFMA over the tile's band range
//     [m_lo, m_hi) only (fb is zero elsewhere, so this is exact); a quad of
//     lanes holding one row reduces with two xor shuffles in a fixed order,
//     and one owner lane per (row, m) adds into a (BM, min(M, 64)) shared
//     tile of the block's mel chunk. The tile is no wider than M needs: on
//     an H100, a tile kept at 64 columns for M = 48 (row stride 64 or 65)
//     made exact mode 4-12% slower at the main shape (PERF.md, section 6);
//   * any number of mel bands M: a block owns (row tile, mel chunk), so the
//     shared tile and the ring stop growing at 64 bands. The chunk is
//     folded into blockIdx.x beside the row tile (x = row tile * chunks +
//     chunk) rather than given a grid dimension of its own: the chunks of
//     one row tile then run side by side and read the same frame rows
//     while they are in L2. A chunk re-runs the DFT of the K tiles whose
//     band crosses its edge (at 48 kHz and 80 bands, 29 tile runs a row
//     tile against 27). Every (row, band) sums the same bins in the same
//     tile and quad order as one chunk would, so the bits do not depend on
//     the chunking;
//   * K tiles with an empty band are not in the tile list: skipped, DFT
//     included;
//   * small N: the grid is (row tiles x chunks, splits); split s takes the
//     tiles t in a contiguous run [s * per, s * per + per) of the one-chunk
//     list (each chunk those of its rows, possibly none) and writes its
//     partial mel to scratch[s], and sum_splits_kernel adds the splits in
//     order. No atomics anywhere: the output is the same bits run to run.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

constexpr int BM = 128;                    // frame rows per block
constexpr int BN = 128;                    // interleaved re / im columns per K tile
constexpr int BINS = BN / 2;               // DFT bins per K tile
constexpr int CONSUMERS = 2;               // consumer warpgroups, 64 rows each
constexpr int PRODUCER_WARP = CONSUMERS * 4;
constexpr int THREADS = CONSUMERS * 128 + 32;
constexpr int ROW_BYTES = 128;             // one 128-byte swizzle row per tile row
constexpr int A_BYTES = BM * ROW_BYTES;    // 16 KB
constexpr int B_BYTES = BN * ROW_BYTES;    // 16 KB
constexpr int WG_A_BYTES = 64 * ROW_BYTES; // one consumer warpgroup's rows
constexpr int MEL_CHUNK = 64;              // mel bands per block
constexpr size_t kMaxSmem = 232448;        // H100: 227 KB of dynamic shared memory per block

// Fast mode: bf16, 64 span samples per chunk; slot = A | B.
// Exact mode: float32 (TF32), 32 samples per chunk; slot = A (hi in place) | A lo | B hi | B lo.
template <bool EXACT>
struct Mode {
  static constexpr int BK = EXACT ? 32 : 64;
  static constexpr int STAGES = EXACT ? 3 : 6;
  static constexpr int SLOT_BYTES = EXACT ? 2 * A_BYTES + 2 * B_BYTES : A_BYTES + B_BYTES;
  static constexpr int TX_BYTES = EXACT ? A_BYTES + 2 * B_BYTES : A_BYTES + B_BYTES;
  static constexpr int K_STEPS = ROW_BYTES / 32;  // wgmma k16 (bf16) or k8 (tf32): 32 bytes each
};

// The ring, the (BM, mel_ld) mel tile (mel_ld = min(M, MEL_CHUNK)) and the barriers.
template <bool EXACT>
constexpr size_t smem_bytes(int mel_ld) {
  return 1024 + size_t(Mode<EXACT>::STAGES) * Mode<EXACT>::SLOT_BYTES + size_t(BM) * mel_ld * 4 +
         2 * Mode<EXACT>::STAGES * 8;
}
static_assert(smem_bytes<true>(MEL_CHUNK) <= kMaxSmem && smem_bytes<false>(MEL_CHUNK) <= kMaxSmem,
              "the ring and the widest mel tile must fit one block's shared memory");

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor: K-major tile of 128-byte rows with the
// 128-byte swizzle (8-row atoms of 1,024 bytes; LBO unused for this layout).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins the accumulators in place around the asynchronous wgmmas, so the
// compiler moves no read or write of them across a fence or a wait.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D_LIST                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define D8(o)                                                                                 \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])
#define D64 D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)

// d (64 x 128 f32, 64 registers a thread) += A (64 x 16 bf16) * B (128 x 16 bf16)^T
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D_LIST
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : D64
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 8 tf32) * B (128 x 8 tf32)^T
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WGMMA_D_LIST
      ", %64, %65, p, 1, 1;\n"
      "}\n"
      : D64
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// ---- kernels ----------------------------------------------------------------

template <bool EXACT>
__global__ void __launch_bounds__(THREADS, 1)
dft_mel_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_w_lo, const int* __restrict__ tiles,
               const int* __restrict__ chunk_start, int chunks, int tiles_per_split,
               const float* __restrict__ fb, float* __restrict__ out, int64_t n, int span,
               int m) {
  using C = Mode<EXACT>;
  const int mel_ld = min(m, MEL_CHUNK);  // the mel tile's width and row stride
  extern __shared__ uint8_t smem_raw[];
  // 1,024-byte alignment for the swizzled tiles
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* slots = smem;
  float* mel = reinterpret_cast<float*>(slots + C::STAGES * C::SLOT_BYTES);  // [BM][mel_ld]
  uint64_t* bars = reinterpret_cast<uint64_t*>(mel + BM * mel_ld);           // full | empty
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + C::STAGES);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = int(blockIdx.x % unsigned(chunks));
  const int row0 = int(blockIdx.x / unsigned(chunks)) * BM;
  const int c0 = chunk * MEL_CHUNK;               // the chunk's first band
  const int cw = min(MEL_CHUNK, m - c0);          // and its width
  int t_begin = chunk_start[chunk], t_end = chunk_start[chunk + 1];
  if (gridDim.y > 1) {
    // split K: this split's rows are those with t in [g0, g0 + tiles_per_split)
    const int g0 = int(blockIdx.y) * tiles_per_split, g1 = g0 + tiles_per_split;
    while (t_begin < t_end && tiles[4 * t_begin + 3] < g0) ++t_begin;
    int e = t_begin;
    while (e < t_end && tiles[4 * e + 3] < g1) ++e;
    t_end = e;
  }
  const int span_chunks = (span + C::BK - 1) / C::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                  // the producer's expect_tx arrival
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = threadIdx.x; e < BM * mel_ld; e += THREADS) mel[e] = 0.f;
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    // ---- producer: one lane keeps the TMA ring full --------------------------
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        const int col0 = tiles[4 * t] * BN;
        for (int c = 0; c < span_chunks; ++c) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t slot = smem_u32(slots + stage * C::SLOT_BYTES);
          mbar_expect_tx(full, C::TX_BYTES);
          tma_load_2d(slot, &map_a, c * C::BK, row0, full);
          if constexpr (EXACT) {
            tma_load_2d(slot + 2 * A_BYTES, &map_w, c * C::BK, col0, full);
            tma_load_2d(slot + 2 * A_BYTES + B_BYTES, &map_w_lo, c * C::BK, col0, full);
          } else {
            tma_load_2d(slot + A_BYTES, &map_w, c * C::BK, col0, full);
          }
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns block rows wg*64 .. wg*64+63 -----------
    const int wg = warp / 4;
    const int tid_wg = threadIdx.x % 128;
    const int q = lane % 4;                                 // bin 4j + q of each n8 column group
    const int r_lo = wg * 64 + (warp % 4) * 16 + lane / 4;  // block rows r_lo and r_lo + 8
    float d[64];    // wgmma accumulators: one span chunk's partial DFT
    float acc[64];  // the K tile's DFT, summed over chunks in IEEE float32
    int stage = 0;
    uint32_t phase = 0;

    for (int t = t_begin; t < t_end; ++t) {
      const int kt = tiles[4 * t], m_lo = tiles[4 * t + 1], m_hi = tiles[4 * t + 2];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;

      for (int c = 0; c < span_chunks; ++c) {
#pragma unroll
        for (int i = 0; i < 64; ++i) d[i] = 0.f;
        fence_acc(d);
        mbar_wait(full0 + 8 * stage, phase);
        uint8_t* slot = slots + stage * C::SLOT_BYTES;
        const uint32_t a = smem_u32(slot + wg * WG_A_BYTES);
        if constexpr (EXACT) {
          // split this warpgroup's float32 rows: hi in place, lo beside them
          // (elementwise, so the swizzled layout carries over)
          float4* hi4 = reinterpret_cast<float4*>(slot + wg * WG_A_BYTES);
          float4* lo4 = reinterpret_cast<float4*>(slot + A_BYTES + wg * WG_A_BYTES);
#pragma unroll
          for (int i = 0; i < WG_A_BYTES / 16 / 128; ++i) {
            const int e = tid_wg + i * 128;
            const float4 v = hi4[e];
            const float4 h = make_float4(rna_tf32(v.x), rna_tf32(v.y), rna_tf32(v.z), rna_tf32(v.w));
            hi4[e] = h;
            lo4[e] = make_float4(rna_tf32(v.x - h.x), rna_tf32(v.y - h.y), rna_tf32(v.z - h.z),
                                 rna_tf32(v.w - h.w));
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          named_barrier(1 + wg, 128);
          const uint32_t a_lo = a + A_BYTES;
          const uint32_t w_hi = smem_u32(slot + 2 * A_BYTES), w_lo = w_hi + B_BYTES;
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < C::K_STEPS; ++k) {
            const uint64_t step = uint64_t(k * 32 >> 4);
            wgmma_tf32(d, smem_desc(a) + step, smem_desc(w_lo) + step);
            wgmma_tf32(d, smem_desc(a_lo) + step, smem_desc(w_hi) + step);
            wgmma_tf32(d, smem_desc(a) + step, smem_desc(w_hi) + step);
          }
        } else {
          const uint32_t w = smem_u32(slot + A_BYTES);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < C::K_STEPS; ++k) {
            const uint64_t step = uint64_t(k * 32 >> 4);
            wgmma_bf16(d, smem_desc(a) + step, smem_desc(w) + step);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(d);
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += d[i];
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // |re + i im| of rows r_lo (h = 0) and r_lo + 8 (h = 1), bins 4j + q
      float mag[2][16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float re = acc[4 * j + 2 * h], im = acc[4 * j + 2 * h + 1];
          mag[h][j] = sqrtf(re * re + im * im);
        }
      // mel[r, mm] += sum_bins mag[r, bin] * fb[bin, mm] over the tile's band
      const float* fbq = fb + (int64_t(kt) * BINS + q) * m;
      for (int mm = m_lo; mm < m_hi; ++mm) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float f = __ldg(fbq + int64_t(4 * j) * m + mm);
          p0 = fmaf(mag[0][j], f, p0);
          p1 = fmaf(mag[1][j], f, p1);
        }
        p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
        p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
        p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
        p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
        if (q == (mm & 3)) {
          mel[r_lo * mel_ld + mm - c0] += p0;
          mel[(r_lo + 8) * mel_ld + mm - c0] += p1;
        }
      }
    }

    named_barrier(1 + wg, 128);
    float* dst = out + int64_t(blockIdx.y) * n * m + c0;
    for (int e = tid_wg; e < 64 * cw; e += 128) {
      const int r = wg * 64 + e / cw, col = e % cw;
      const int64_t row = row0 + r;
      if (row < n) dst[row * m + col] = mel[r * mel_ld + col];
    }
  }
}

// out[i] = scratch[0][i] + scratch[1][i] + ... in split order (deterministic)
__global__ void sum_splits_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                                  int64_t count, int splits) {
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += int64_t(gridDim.x) * blockDim.x) {
    float s = scratch[i];
    for (int p = 1; p < splits; ++p) s += scratch[p * count + i];
    out[i] = s;
  }
}

// ---- host side --------------------------------------------------------------

constexpr int kErrNoEncoder = -1;  // cuTensorMapEncodeTiled not found in libcuda
constexpr int kErrEncode = -2;     // cuTensorMapEncodeTiled refused a map

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda.so.1 (the copy the process
// has loaded, else loaded here; no -lcuda at build time).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// 2-D row-major (rows, cols) tensor with a row stride of `ld` elements, read
// in (box_rows, box_cols) tiles with the 128-byte swizzle; out-of-bounds
// elements read as zero.
int make_map(CUtensorMap* map, const void* ptr, bool bf16, uint64_t rows, uint64_t cols,
             uint64_t ld, uint32_t box_rows, uint32_t box_cols) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return kErrNoEncoder;
  const uint64_t elem = bf16 ? 2 : 4;
  cuuint64_t dims[2] = {cols, rows};
  cuuint64_t strides[1] = {ld * elem};
  cuuint32_t box[2] = {box_cols, box_rows};
  cuuint32_t elem_strides[2] = {1, 1};
  CUresult r = encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                      2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <bool EXACT>
int launch(const void* frames, int64_t frames_ld, const void* w, const void* w_lo, int w_ld,
           const int* tiles, const int* chunk_start, int chunks, int tiles_per_split, int splits,
           const void* fb, void* out, void* scratch, int64_t n, int span, int k_pad, int m,
           cudaStream_t stream) {
  using C = Mode<EXACT>;
  const size_t smem = smem_bytes<EXACT>(m < MEL_CHUNK ? m : MEL_CHUNK);
  const int64_t blocks_x = (n + BM - 1) / BM * chunks;
  if (blocks_x > 0x7fffffff || splits > 65535 || n > 0x7fffffff) return int(cudaErrorInvalidValue);
  CUtensorMap map_a, map_w, map_w_lo;
  int err = make_map(&map_a, frames, !EXACT, uint64_t(n), uint64_t(span), uint64_t(frames_ld), BM,
                     C::BK);
  if (!err) err = make_map(&map_w, w, !EXACT, 2 * uint64_t(k_pad), uint64_t(w_ld), uint64_t(w_ld),
                           BN, C::BK);
  if (!err)
    err = make_map(&map_w_lo, EXACT ? w_lo : w, !EXACT, 2 * uint64_t(k_pad), uint64_t(w_ld),
                   uint64_t(w_ld), BN, C::BK);
  if (err) return err;

  cudaError_t e = cudaFuncSetAttribute(dft_mel_kernel<EXACT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  float* dst = static_cast<float*>(splits > 1 ? scratch : out);
  dft_mel_kernel<EXACT><<<dim3(unsigned(blocks_x), unsigned(splits)), THREADS, smem, stream>>>(
      map_a, map_w, map_w_lo, tiles, chunk_start, chunks, tiles_per_split,
      static_cast<const float*>(fb), dst, n, span, m);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return int(e);
  const int64_t count = n * m;
  const int64_t blocks = (count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096;
  sum_splits_kernel<<<unsigned(blocks), 256, 0, stream>>>(dst, static_cast<float*>(out), count,
                                                         splits);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel (and, for splits > 1, the split sum) on `stream`
// without synchronising. frames: (n, span) with row stride frames_ld, bf16
// in fast mode and float32 in exact mode; w / w_lo: (2 * k_pad, w_ld); fb:
// (k_pad, m) float32; chunk_tiles: (T', 4) int32 and chunk_start: (chunks + 1)
// int32, the chunked plan, chunks = ceil(m / 64); out: (n, m) float32;
// scratch: (splits, n, m) float32 when splits > 1, split s taking the rows
// whose t lies in [s * tiles_per_split, (s + 1) * tiles_per_split). Returns
// 0, a cudaError_t code, or a negative code of this library
// (nisqa_cuda_error_string names each).
int nisqa_dft_mel(const void* frames, int64_t frames_ld, const void* w, const void* w_lo,
                  int w_ld, const void* chunk_tiles, const void* chunk_start, int chunks,
                  int tiles_per_split, int splits, const void* fb, void* out, void* scratch,
                  int64_t n, int span, int k_pad, int m, int exact, void* stream) {
  if (n <= 0 || span <= 0 || span > w_ld || k_pad <= 0 || k_pad % BINS || m <= 0 ||
      chunks != (m + MEL_CHUNK - 1) / MEL_CHUNK || splits < 1 ||
      (splits > 1 && (!scratch || tiles_per_split < 1)) || (exact && !w_lo))
    return int(cudaErrorInvalidValue);
  const int* t = static_cast<const int*>(chunk_tiles);
  const int* cs = static_cast<const int*>(chunk_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return exact ? launch<true>(frames, frames_ld, w, w_lo, w_ld, t, cs, chunks, tiles_per_split,
                              splits, fb, out, scratch, n, span, k_pad, m, s)
               : launch<false>(frames, frames_ld, w, w_lo, w_ld, t, cs, chunks, tiles_per_split,
                               splits, fb, out, scratch, n, span, k_pad, m, s);
}

const char* nisqa_cuda_error_string(int code) {
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map (alignment?)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
