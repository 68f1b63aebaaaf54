// GroupNorm(+ReLU) forward over NHWC for Hopper (sm_90a): f32 statistics
// with a centred variance, output in the input type.
//
// Replaces mmlspark_tpu/ops/group_norm.py:_group_norm_fwd_pallas (the
// Pallas kernel _gn_kernel). Same function: x [N, H*W, C] (bf16 or f32),
// groups of cg = C/G neighbouring channels; per (sample, group) the mean
// and the centred variance over H*W*cg values in f32, eps, then
// ((x - mean) * rstd) * scale[c] + bias[c], an optional ReLU, and a
// round-to-nearest cast to the input type.
//
// The Pallas kernel holds a whole sample's (H*W, C) block in VMEM (up to
// 1.6 MB at 112x112x64 or 56x56x256 in bf16). A Hopper block has at most
// 227 KB of shared memory, and blocks run in parallel, so the work is cut
// in three launches on one stream:
//
//   1. gn_tile_stats: grid (tile, sample). A block reads its tile of rows
//      [r0, r0 + tile_rows) x C coalesced, neighbouring threads on
//      neighbouring channels, and forms per-group (mean, M2) of the tile
//      in two passes: the sums, then the squares centred on the tile's
//      mean (the second pass re-reads the tile, mostly from L1/L2).
//   2. gn_merge: one warp per (sample, group) merges the tiles' partials
//      with Chan's formula, lanes over tiles in a fixed order and then a
//      fixed shuffle tree, into (mean, rstd). No float atomics: the
//      result is the same on every run.
//   3. gn_apply: grid (block, sample); a block builds a table of
//      (mean, rstd, scale, bias) per channel in shared memory and
//      normalises its strided share of the sample's elements.
//
// The variance stays centred: the one-pass E[x^2] - E[x]^2 is pure noise
// at mean 200 and spread 0.02 (ops/group_norm.py:68-75 of the JAX
// package); a tile's partial is centred on its own mean and Chan's merge
// keeps it so.
//
// What bounds it on an H100: one read of x and one write of the output
// (4 bytes an element in bf16), memory at 3.35 TB/s; the arithmetic is a
// few operations an element. This design reads x two or three times
// (the statistics' two passes, the second often from L2, and the
// normalise pass), with 2- or 4-byte loads a thread, so it is expected
// at 1.5 to 2.5 times its bound.
//
// The kernel allocates nothing: the caller passes the output, the
// partials [N, ntiles, G, 2] and the statistics [N, G, 2] (f32 scratch)
// and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Per-channel sums of the tile into buf[0..C) (row threads folded in
// order), then per-group sums of those into out[g] (channels in order).
// Called by every thread of the block; buf holds rt x C floats.
__device__ __forceinline__ void fold_groups(float* buf, float* out, int C,
                                            int G, int cg, int rt) {
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  __syncthreads();
  for (int c = tid; c < C; c += nthreads) {
    float s = buf[c];
    for (int j = 1; j < rt; ++j) s += buf[j * C + c];
    buf[c] = s;
  }
  __syncthreads();
  for (int g = tid; g < G; g += nthreads) {
    float s = 0.f;
    for (int j = 0; j < cg; ++j) s += buf[g * cg + j];
    out[g] = s;
  }
  __syncthreads();
}

// dynamic shared memory: buf [rt][C], gsum [G], gmean [G] (floats)
template <typename T>
__global__ void gn_tile_stats(const T* __restrict__ x,
                              float2* __restrict__ part, int HW, int C,
                              int G, int tile_rows, int ntiles) {
  extern __shared__ float smem[];
  const int ct = blockDim.x, rt = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tile = blockIdx.x, n = blockIdx.y;
  const int cg = C / G;
  const int r0 = tile * tile_rows;
  const int rows = min(tile_rows, HW - r0);
  float* buf = smem;
  float* gsum = buf + rt * C;
  float* gmean = gsum + G;
  const T* xs = x + ((size_t)n * HW + r0) * C;

  // pass 1: sums
  for (int c = tx; c < C; c += ct) {
    float s = 0.f;
    for (int r = ty; r < rows; r += rt) s += to_f32(xs[(size_t)r * C + c]);
    buf[ty * C + c] = s;
  }
  fold_groups(buf, gsum, C, G, cg, rt);
  const float count = (float)rows * (float)cg;
  const int tid = ty * ct + tx;
  for (int g = tid; g < G; g += ct * rt) gmean[g] = gsum[g] / count;
  __syncthreads();

  // pass 2: squares centred on the tile's group means
  for (int c = tx; c < C; c += ct) {
    const float m = gmean[c / cg];
    float s = 0.f;
    for (int r = ty; r < rows; r += rt) {
      const float d = to_f32(xs[(size_t)r * C + c]) - m;
      s += d * d;
    }
    buf[ty * C + c] = s;
  }
  fold_groups(buf, gsum, C, G, cg, rt);
  for (int g = tid; g < G; g += ct * rt)
    part[((size_t)n * ntiles + tile) * G + g] = make_float2(gmean[g],
                                                            gsum[g]);
}

// (count, mean, M2) of a absorbs b (Chan et al.); empty sides pass through
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& qa,
                                           float nb, float mb, float qb) {
  if (nb == 0.f) return;
  if (na == 0.f) {
    na = nb;
    ma = mb;
    qa = qb;
    return;
  }
  const float nab = na + nb;
  const float d = mb - ma;
  ma += d * (nb / nab);
  qa += qb + d * d * (na * nb / nab);
  na = nab;
}

// one warp per (sample, group); blockDim.x a multiple of 32
__global__ void gn_merge(const float2* __restrict__ part,
                         float2* __restrict__ stats, int NG, int G, int HW,
                         int cg, int tile_rows, int ntiles, float eps) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= NG) return;  // uniform across the warp
  const int n = warp / G, g = warp - n * G;
  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  for (int t = lane; t < ntiles; t += 32) {
    const float2 p = part[((size_t)n * ntiles + t) * G + g];
    const float rows = (float)min(tile_rows, HW - t * tile_rows);
    chan_merge(cnt, mean, m2, rows * (float)cg, p.x, p.y);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, cnt, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float qb = __shfl_down_sync(0xffffffffu, m2, off);
    chan_merge(cnt, mean, m2, nb, mb, qb);
  }
  if (lane == 0) {
    const float var = fmaxf(m2 / cnt, 0.f);
    stats[warp] = make_float2(mean, 1.0f / sqrtf(var + eps));
  }
}

// dynamic shared memory: tab [C] float4 (mean, rstd, scale, bias)
template <typename T>
__global__ void gn_apply(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         const float2* __restrict__ stats,
                         T* __restrict__ y, int HW, int C, int G,
                         int relu) {
  extern __shared__ float4 tab[];
  const int n = blockIdx.y;
  const int cg = C / G;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float2 s = stats[n * G + c / cg];
    tab[c] = make_float4(s.x, s.y, scale[c], bias[c]);
  }
  __syncthreads();
  const int per = HW * C;  // < 2^30, checked by the caller
  const size_t base = (size_t)n * per;
  const int stride = gridDim.x * blockDim.x;
  const int cstep = stride % C;
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  int c = e % C;
  for (; e < per; e += stride) {
    const float4 p = tab[c];
    float v = (to_f32(x[base + e]) - p.x) * p.y;
    v = v * p.z + p.w;
    if (relu) v = fmaxf(v, 0.f);
    store(y + base + e, v);
    c += cstep;
    if (c >= C) c -= C;
  }
}

constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
int launch(const void* x, const float* scale, const float* bias, void* y,
           float* part, float* stats, int N, int HW, int C, int G,
           int tile_rows, int ntiles, int ct, int rt, int apply_blocks,
           int threads, int relu, float eps, cudaStream_t stream) {
  const int cg = C / G;
  const size_t stats_smem = ((size_t)rt * C + 2 * (size_t)G) * sizeof(float);
  if (stats_smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        gn_tile_stats<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)stats_smem);
    if (e != cudaSuccess) return (int)e;
  }
  gn_tile_stats<T><<<dim3(ntiles, N), dim3(ct, rt), stats_smem, stream>>>(
      static_cast<const T*>(x), reinterpret_cast<float2*>(part), HW, C, G,
      tile_rows, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int NG = N * G;
  const int merge_threads = 256;
  const int merge_blocks = (NG * 32 + merge_threads - 1) / merge_threads;
  gn_merge<<<merge_blocks, merge_threads, 0, stream>>>(
      reinterpret_cast<const float2*>(part), reinterpret_cast<float2*>(stats),
      NG, G, HW, cg, tile_rows, ntiles, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t apply_smem = (size_t)C * sizeof(float4);
  if (apply_smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        gn_apply<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)apply_smem);
    if (e != cudaSuccess) return (int)e;
  }
  gn_apply<T><<<dim3(apply_blocks, N), threads, apply_smem, stream>>>(
      static_cast<const T*>(x), scale, bias,
      reinterpret_cast<const float2*>(stats), static_cast<T*>(y), HW, C, G,
      relu);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int group_norm_fwd(const void* x, const float* scale,
                              const float* bias, void* y, float* part,
                              float* stats, int dtype, int N, int HW, int C,
                              int G, int tile_rows, int ntiles, int ct,
                              int rt, int apply_blocks, int threads,
                              int relu, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, bias, y, part, stats, N, HW, C, G,
                                 tile_rows, ntiles, ct, rt, apply_blocks,
                                 threads, relu, eps, s);
  return launch<float>(x, scale, bias, y, part, stats, N, HW, C, G,
                       tile_rows, ntiles, ct, rt, apply_blocks, threads,
                       relu, eps, s);
}
