// The epilogue of AdaptCNN's convolutions when it serves: the convolution's
// bias, eval-mode batch norm and ReLU in one pass over the output of a
// convolution run without its bias, with the adaptive max-pool as well at
// blocks 1, 2 and 4 (bn_relu_pool_kernel) and without it at blocks 3, 5 and 6
// (bias_bn_relu_kernel, after the first kernel's notes).
//
// Replaces no TPU kernel: nisqa_tpu's convolutions, batch norms and adaptive
// pools are plain XLA (nisqa_tpu/models/framewise.py, modules.py). It
// replaces the chain the port ran in eval,
//
//   F.adaptive_max_pool2d(F.relu(F.batch_norm(conv(x) + b, running stats)), (oh, ow))
//
// four library kernels that each read and write the whole activation (cuDNN
// adds no bias: ATen adds it after the convolution, a broadcast add_), the
// pool also writing int64 indices that nothing reads.
//
// Contract, x (N, C, H, W) float32 contiguous, the convolution's output
// without its bias b (C,) -> out (N, C, oh, ow):
//
//   alpha[c] = rsqrt(var[c] + eps) * weight[c]        the sum and product rounded to float32
//   beta[c]  = fma(-mean[c], alpha[c], bias[c])
//   out[n, c, i, j] = relu(max over bin (i, j) of fma(x[n, c, h, w] + b[c], alpha[c], beta[c]))
//
// with bin (i, j) the rows [floor(i H / oh), ceil((i + 1) H / oh)) and the
// columns [floor(j W / ow), ceil((j + 1) W / ow)), as ATen's adaptive pool
// (bins may overlap: 80 or 128 mel bands pooled to 24 rows). This is the
// plain version's formula (ops/bn_relu_pool.py), which is ATen's CPU eval
// batch norm to the bit; rsqrt is the card's rsqrtf, as torch.rsqrt on the
// card, so the kernel equals the plain version run on the card. cuDNN's
// bn_fw_inf rounds in another order, a few ulps away.
//
// Rounding is non-decreasing, so x + b[c] rounded is non-decreasing in x,
// and fma(x, a, beta), correctly rounded, is non-decreasing in x for a >= 0
// and non-increasing for a < 0; so is relu's composition with them. The max
// over a bin of relu(fma(x + b, a, beta)) is therefore relu(fma(m + b, a,
// beta)), m the bin's max for a >= 0 and its min for a < 0: the kernel takes
// both extremes and adds the bias and applies the affine once per output,
// bit-equal to doing so per element. A NaN in a bin gives NaN, as in ATen.
//
// What bounds it on an H100: bytes. At 48 mel bands an AdaptCNN segment row
// reads 83 KB over the three blocks (16 x 48 x 15, 32 x 24 x 7 and 64 x 12 x 5
// floats) and writes 23 KB; a few compares an element are far under the
// bytes' time. The design keeps the copies in flight:
//   * a (n, c) plane is H * W contiguous floats, so a tile of consecutive
//     planes is one contiguous run; the block copies it into shared memory
//     with 16-byte cp.async (4-byte where a run is not 16-byte aligned): no
//     registers held, every copy of a tile in flight at once;
//   * a persistent grid (as many blocks as fit on the card) walks the tiles
//     with stride gridDim, two tile buffers a block: the next tile's copies
//     fly while the block pools the current one;
//   * a tile's outputs are one contiguous run too: thread q of the block
//     takes outputs q, q + 256, ..., so every lane works and the stores
//     coalesce whatever the pool's size (an 18-output plane at block 4);
//     the output's plane comes from a multiply-high by a reciprocal, not a
//     division; each output's bin (its first element, rows and columns) and
//     each plane's alpha and beta (laid out from the tile's first channel
//     on, so no modulo) are shared-memory tables made once a block;
//   * no indices are written.
// On an H100 it runs at 70-84% of the bytes bound at the serving shapes,
// where a copy-only variant of the same pipeline ran at 88-91% (PERF.md,
// section 6).
//
// bias_bn_relu_kernel, blocks 3, 5 and 6 (no pool): the same formula per
// element, out[n, c, h, w] = relu(fma(x[n, c, h, w] + b[c], alpha[c], beta[c])),
// into a new (N, C, H, W) tensor. It replaces ATen's bias add_, cuDNN's
// bn_fw_inf (slow on these small planes: 60, 18 and 6 floats) and the ReLU,
// three passes over the activation. Bound by bytes, x read and out written
// once, so it is a flat walk that keeps loads in flight:
//   * 16-byte loads and stores (4-byte where a row of C * H * W floats is not
//     a multiple of 4 or x is not 16-byte aligned), two a thread before
//     either is used, thread t of a block at vectors t and t + 256, so a
//     warp's accesses coalesce;
//   * one block a run of 512 vectors, as many blocks as runs, so the card's
//     scheduler balances the tail (a persistent grid walking the vectors ran
//     6-9% slower at a NISQA_DE batch, PERF.md section 6): one 64-bit
//     remainder a block (its first float's offset within a row, the channel
//     pattern's period), then an element's offset and channel by
//     multiply-highs;
//   * the C-entry table (b, alpha, beta) is made once a block in shared
//     memory, one 16-byte entry a channel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB of dynamic shared memory per block

struct Geometry {
  int64_t planes;   // N * C
  int channels;     // C
  int h, w, oh, ow;
  int tile_planes;  // planes per tile
  int tile_ld;      // floats per tile buffer: tile_planes * h * w rounded up to 4
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all but the most recent group of this thread's copies.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// max / min that return NaN when either operand is NaN (sm_80 on), as ATen's pool
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Starts the copies of tile t into dst; vec: x is 16-byte aligned and every
// tile starts on a multiple of 4 floats.
__device__ __forceinline__ void load_tile(const Geometry& g, const float* __restrict__ x,
                                          int64_t t, float* dst, bool vec) {
  const int64_t plane = int64_t(g.h) * g.w;
  const int64_t p0 = t * g.tile_planes;
  const int64_t left = g.planes - p0;
  const int n = int(left < g.tile_planes ? left : g.tile_planes) * int(plane);
  const float* src = x + p0 * plane;
  int k = 0;
  if (vec) {
    const int n4 = n >> 2;
    for (int q = threadIdx.x; q < n4; q += kThreads) cp_async16(dst + 4 * q, src + 4 * q);
    k = n4 << 2;
  }
  for (int q = k + threadIdx.x; q < n; q += kThreads) cp_async4(dst + q, src + q);
}

__global__ void __launch_bounds__(kThreads)
    bn_relu_pool_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const float* __restrict__ conv_bias, const float* __restrict__ mean,
                        const float* __restrict__ var, const float* __restrict__ weight,
                        const float* __restrict__ bias, float eps, Geometry g, uint32_t magic,
                        bool vec) {
  extern __shared__ __align__(16) float smem[];
  // conv bias, alpha and beta of plane k of a tile that starts at channel c0 sit at c0 + k
  float* shift = smem + 2 * g.tile_ld;
  float* alpha = shift + g.channels + g.tile_planes;
  float* beta = alpha + g.channels + g.tile_planes;
  // output r of a plane: its bin's first element and (rows << 16 | columns)
  int* bin_start = reinterpret_cast<int*>(beta + g.channels + g.tile_planes);
  int* bin_size = bin_start + g.oh * g.ow;

  const int64_t n_tiles = (g.planes + g.tile_planes - 1) / g.tile_planes;
  int64_t t = blockIdx.x;
  if (t >= n_tiles) return;
  load_tile(g, x, t, smem, vec);
  cp_async_commit();

  for (int k = threadIdx.x; k < g.channels + g.tile_planes; k += kThreads) {
    const int c = k % g.channels;
    const float a = __fmul_rn(rsqrtf(__fadd_rn(var[c], eps)), weight[c]);
    shift[k] = conv_bias[c];
    alpha[k] = a;
    beta[k] = __fmaf_rn(-mean[c], a, bias[c]);
  }
  const int plane = g.h * g.w, oplane = g.oh * g.ow;
  for (int r = threadIdx.x; r < oplane; r += kThreads) {
    const int i = r / g.ow, j = r - i * g.ow;
    const int h0 = int(int64_t(i) * g.h / g.oh), h1 = int((int64_t(i + 1) * g.h + g.oh - 1) / g.oh);
    const int w0 = int(int64_t(j) * g.w / g.ow), w1 = int((int64_t(j + 1) * g.w + g.ow - 1) / g.ow);
    bin_start[r] = h0 * g.w + w0;
    bin_size[r] = (h1 - h0) << 16 | (w1 - w0);
  }

  for (int buf = 0; t < n_tiles; t += gridDim.x, buf ^= 1) {
    const int64_t next = t + gridDim.x;
    if (next < n_tiles) load_tile(g, x, next, smem + (buf ^ 1) * g.tile_ld, vec);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait_prior();
    __syncthreads();

    const int64_t p0 = t * g.tile_planes;
    const int64_t left = g.planes - p0;
    const int np = int(left < g.tile_planes ? left : g.tile_planes);
    const int c0 = int(p0 % g.channels);
    const float* tile = smem + buf * g.tile_ld;
    float* o = out + p0 * oplane;  // the tile's outputs are one contiguous run
    for (int q = threadIdx.x; q < np * oplane; q += kThreads) {
      const int lp = magic ? int(__umulhi(uint32_t(q), magic)) : q / oplane;
      const int r = q - lp * oplane;
      const float* row = tile + lp * plane + bin_start[r];
      const int rows = bin_size[r] >> 16, cols = bin_size[r] & 0xffff;
      float mx = row[0], mn = mx;
      for (int hh = 0; hh < rows; ++hh, row += g.w) {
        for (int ww = 0; ww < cols; ++ww) {
          mx = max_nan(mx, row[ww]);
          mn = min_nan(mn, row[ww]);
        }
      }
      const float a = alpha[c0 + lp];
      const float m = __fadd_rn(a < 0.0f ? mn : mx, shift[c0 + lp]);
      const float y = __fmaf_rn(m, a, beta[c0 + lp]);
      o[q] = y < 0.0f ? 0.0f : y;  // NaN stays NaN
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }
}

// One thread's vector of V floats: float4 (16-byte accesses) or float.
template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float get(const T& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
  __device__ static void set(T& v, int k, float f) {
    if (k == 0)
      v.x = f;
    else if (k == 1)
      v.y = f;
    else if (k == 2)
      v.z = f;
    else
      v.w = f;
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static float get(const T& v, int) { return v; }
  __device__ static void set(T& v, int, float f) { v = f; }
};

constexpr int kUnroll = 2;  // vectors a thread loads before it uses any

struct FlatGeometry {
  int64_t vecs;        // numel / V
  uint32_t row;        // C * H * W floats: the period of the channel pattern
  uint32_t row_magic;  // s / row as __umulhi(s, row_magic) for s < row + V * kThreads * kUnroll;
                       // 0: divide
  uint32_t plane;      // H * W
  uint32_t magic;      // o / plane as __umulhi(o, magic) for o < row; 0: divide
  int channels;
};

template <int V>
__global__ void __launch_bounds__(kThreads)
    bias_bn_relu_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const float* __restrict__ conv_bias, const float* __restrict__ mean,
                        const float* __restrict__ var, const float* __restrict__ weight,
                        const float* __restrict__ bias, float eps, FlatGeometry g) {
  using T = typename Vec<V>::T;
  extern __shared__ __align__(16) float4 table[];  // channel c: (b, alpha, beta, 0)
  __shared__ uint32_t first;  // offset of the block's first float within its row
  const int64_t v0 = int64_t(blockIdx.x) * kThreads * kUnroll;
  if (threadIdx.x == 0) first = uint32_t(v0 * V % g.row);
  for (int c = threadIdx.x; c < g.channels; c += kThreads) {
    const float a = __fmul_rn(rsqrtf(__fadd_rn(var[c], eps)), weight[c]);
    table[c] = make_float4(conv_bias[c], a, __fmaf_rn(-mean[c], a, bias[c]), 0.0f);
  }
  __syncthreads();

  // the block's vectors v0 + q, q < kThreads * kUnroll; thread t takes q = t + u * kThreads
  const T* xv = reinterpret_cast<const T*>(x) + v0;
  T* ov = reinterpret_cast<T*>(out) + v0;
  const int64_t left = g.vecs - v0;
  T in[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int q = u * kThreads + threadIdx.x;
    if (q < left) in[u] = __ldg(xv + q);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int q = u * kThreads + threadIdx.x;
    if (q < left) {
      uint32_t o = first + uint32_t(q) * V;
      o -= (g.row_magic ? __umulhi(o, g.row_magic) : o / g.row) * g.row;  // within its row
      T y;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const uint32_t e = o + k;  // < row: a vector never crosses a row
        const float4 t = table[g.magic ? __umulhi(e, g.magic) : e / g.plane];
        const float f = __fmaf_rn(__fadd_rn(Vec<V>::get(in[u], k), t.x), t.y, t.z);
        Vec<V>::set(y, k, f < 0.0f ? 0.0f : f);  // NaN stays NaN
      }
      ov[q] = y;
    }
  }
}

// ceil(2^32 / d): x / d is __umulhi(x, it) for every x with x * d <= 2^32; 0
// (divide) where d is 1 or `below` * d exceeds 2^32
uint32_t magic_for(int64_t d, int64_t below) {
  return d > 1 && below * d <= (int64_t(1) << 32)
             ? uint32_t(((int64_t(1) << 32) + d - 1) / d)
             : 0u;
}

size_t smem_bytes(const Geometry& g) {
  return (2 * size_t(g.tile_ld) + 3 * (size_t(g.channels) + g.tile_planes) +
          2 * size_t(g.oh) * g.ow) * 4;
}

}  // namespace

extern "C" {

// Launches bn_relu_pool_kernel on `stream` without synchronising. x: (planes /
// channels, channels, h, w) float32 contiguous; out: (planes / channels,
// channels, oh, ow) float32 contiguous; conv_bias, mean, var, weight, bias:
// (channels,) float32. A tile holds tile_planes planes (the
// wrapper's tile_planes()). Returns 0 or a cudaError_t code
// (nisqa_cuda_error_string names it).
int nisqa_bn_relu_pool(const void* x, void* out, const void* conv_bias, const void* mean,
                       const void* var, const void* weight, const void* bias, float eps,
                       int64_t planes, int channels, int h, int w, int oh, int ow,
                       int tile_planes, void* stream) {
  if (planes <= 0 || channels <= 0 || planes % channels || h <= 0 || w <= 0 || oh <= 0 ||
      ow <= 0 || tile_planes <= 0 || int64_t(tile_planes) * h * w > (int64_t(1) << 30) ||
      int64_t(tile_planes) * oh * ow > (int64_t(1) << 30))
    return int(cudaErrorInvalidValue);
  Geometry g{planes, channels, h, w, oh, ow, tile_planes, 0};
  g.tile_ld = (tile_planes * h * w + 3) / 4 * 4;
  const size_t smem = smem_bytes(g);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  const bool vec =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && (int64_t(tile_planes) * h * w) % 4 == 0;
  // q / oplane as __umulhi(q, ceil(2^32 / oplane)), exact while q * oplane < 2^32:
  // q < tile_planes * oplane; 0 selects the division
  const int64_t oplane = int64_t(oh) * ow;
  const uint32_t magic = oplane > 1 && tile_planes * oplane * oplane < (int64_t(1) << 32)
                             ? uint32_t(((int64_t(1) << 32) + oplane - 1) / oplane)
                             : 0u;

  cudaError_t e = cudaFuncSetAttribute(bn_relu_pool_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return int(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return int(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bn_relu_pool_kernel, kThreads,
                                                         smem)) != cudaSuccess)
    return int(e);
  const int64_t n_tiles = (planes + tile_planes - 1) / tile_planes;
  const int64_t resident = int64_t(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = n_tiles < resident ? n_tiles : resident;
  bn_relu_pool_kernel<<<unsigned(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const float*>(conv_bias), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<const float*>(weight),
      static_cast<const float*>(bias), eps, g, magic, vec);
  return int(cudaGetLastError());
}

// Launches bias_bn_relu_kernel on `stream` without synchronising. x and out:
// (numel / (channels * plane), channels, plane) float32 contiguous, out not
// overlapping x; conv_bias, mean, var, weight, bias: (channels,) float32.
// Returns 0 or a cudaError_t code.
int nisqa_bias_bn_relu(const void* x, void* out, const void* conv_bias, const void* mean,
                       const void* var, const void* weight, const void* bias, float eps,
                       int64_t numel, int channels, int plane, void* stream) {
  const int64_t row = int64_t(channels) * plane;
  const size_t smem = sizeof(float4) * size_t(channels > 0 ? channels : 0);
  // 48 KB: a block's dynamic shared memory without cudaFuncSetAttribute
  if (numel <= 0 || channels <= 0 || plane <= 0 || row >= (int64_t(1) << 31) || numel % row ||
      smem > 49152)
    return int(cudaErrorInvalidValue);
  const bool vec = row % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int V = vec ? 4 : 1;
  const int64_t per_block = int64_t(kThreads) * kUnroll;
  const FlatGeometry g{numel / V, uint32_t(row), magic_for(row, row + V * per_block),
                       uint32_t(plane), magic_for(plane, row), channels};
  const int64_t blocks = (g.vecs + per_block - 1) / per_block;
  if (blocks >= (int64_t(1) << 31)) return int(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  const auto *cb = static_cast<const float*>(conv_bias), *m = static_cast<const float*>(mean),
             *va = static_cast<const float*>(var), *wt = static_cast<const float*>(weight),
             *bi = static_cast<const float*>(bias);
  auto* st = static_cast<cudaStream_t>(stream);
  if (vec)
    bias_bn_relu_kernel<4><<<unsigned(blocks), kThreads, smem, st>>>(xf, of, cb, m, va, wt, bi,
                                                                     eps, g);
  else
    bias_bn_relu_kernel<1><<<unsigned(blocks), kThreads, smem, st>>>(xf, of, cb, m, va, wt, bi,
                                                                     eps, g);
  return int(cudaGetLastError());
}

}  // extern "C"
