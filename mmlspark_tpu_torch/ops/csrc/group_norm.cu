// GroupNorm(+ReLU) forward and backward over NHWC for Hopper (sm_90a): f32
// statistics with a centred variance, output in the input type.
//
// Replaces mmlspark_tpu/ops/group_norm.py:_group_norm_fwd_pallas (the
// Pallas kernel _gn_kernel). Same function: x [N, H*W, C] (bf16 or f32),
// groups of cg = C/G neighbouring channels; per (sample, group) the mean
// and the centred variance over H*W*cg values in f32, eps, then
// ((x - mean) * rstd) * scale[c] + bias[c], an optional ReLU, and a
// round-to-nearest cast to the input type.
//
// What bounds it on an H100: one read of x and one write of the output
// (4 bytes an element in bf16), memory at 3.35 TB/s; the arithmetic is a
// few operations an element.
//
// Two bodies, chosen by shape in ops/group_norm.py (cluster_plan):
//
// gn_cluster: one launch per call, one thread-block cluster per sample.
//   The Pallas kernel holds a whole sample's (H*W, C) block in VMEM and
//   reads it from HBM once. A Hopper block has at most 227 KB of shared
//   memory, but a cluster of k CTAs on neighbouring SMs (k <= 8
//   portable, 16 where the card's occupancy query holds such clusters)
//   can hold a sample of up to k * 227 KB and read each other's shared
//   memory: that is the counterpart here. CTA q of a cluster
//   holds rows [q*R, min((q+1)*R, H*W)) of its sample (the last slab
//   ragged), copied from device memory once with cp.async in four chunks
//   of rows (16-byte copies where C*elt and the data pointers allow, else
//   8, 4 or 2 bytes); the first pass over a chunk overlaps the copies of
//   the next. Every later pass reads shared memory, and the output is
//   stored in vectors of the same width.
//   The order of every sum is fixed, with no atomics, so a launch gives
//   the same bits every time:
//     1. each thread keeps the same vector of VEC channels (8 bf16 or 4
//        f32 at 16 bytes) and sums its rows (row stride rt) in row order,
//        folding its channels into the group segments its vector holds
//        (a whole vector of one group, cg channels of one group, or
//        single channels), then the row threads in order, then a group's
//        segments in order: the CTA's partial sum per group;
//     2. cluster.sync(); every CTA reads all k partials over distributed
//        shared memory in rank order, so every CTA holds the same group
//        means m;
//     3. the same order gives sum(x - m) and sum((x - m)^2), exchanged
//        the same way: mean = m + sum(x - m)/n and
//        var = sum((x - m)^2)/n - (sum(x - m)/n)^2. This is the JAX
//        kernel's order (the mean, then the centred squares) with the
//        mean's own rounding corrected in the second pass, which keeps
//        mean 200 / spread 0.02 at the f32 step of the mean;
//     4. normalise from shared memory, store, and a last cluster.sync()
//        so that no CTA exits while another still reads its partials.
//   The wrapper picks k from the card's occupancy query (the fewest
//   waves of clusters, then enough CTAs to reach most SMs, then slabs
//   small enough for two CTAs an SM); 256 threads a CTA. The launch goes
//   through cudaLaunchKernelEx with the cluster dimension, after
//   cudaOccupancyMaxActiveClusters has shown that at least one such
//   cluster fits on the card.
//
// The tiled body, three launches (gn_tile_stats, gn_merge, gn_apply), taken
//   where one sample does not fit the largest cluster's shared memory
//   (past 16 * 227 KB, such as f32 at 112x112x128: 6.4 MB a sample):
//   1. gn_tile_stats: grid (tile, sample). A block reads its tile of rows
//      [r0, r0 + tile_rows) x C coalesced, neighbouring threads on
//      neighbouring channels, and forms per-group (mean, M2) of the tile
//      in two passes: the sums, then the squares centred on the tile's
//      mean (the second pass re-reads the tile, mostly from L1/L2).
//   2. gn_merge: one warp per (sample, group) merges the tiles' partials
//      with Chan's formula, lanes over tiles in a fixed order and then a
//      fixed shuffle tree, into (mean, rstd). No float atomics.
//   3. gn_apply: grid (block, sample); a block builds a table of
//      (mean, rstd, scale, bias) per channel in shared memory and
//      normalises its strided share of the sample's elements.
//   It reads x two or three times with 2- or 4-byte loads a thread; the
//   caller passes f32 scratch for the partials [N, ntiles, G, 2] and the
//   statistics [N, G, 2].
//
// The variance stays centred in both bodies: the one-pass
// E[x^2] - E[x]^2 is pure noise at mean 200 and spread 0.02
// (ops/group_norm.py:68-75 of the JAX package).
//
// Neither body allocates: the caller passes the output (and the scratch
// of the three-launch body) and the stream. Every entry point returns a
// cudaError_t (0 = launched).
//
// The backward replaces the backward of mmlspark_tpu/ops/group_norm.py:
// _gn_bwd, a jax.vjp of the reference, in closed form. Per (sample n,
// group g) of M = H*W*cg values, with the forward's statistics (mean,
// r = rsqrt(var + eps)):
//   xhat = (x - mean) * r, y = xhat * scale + bias,
//   gy = dy * relu'(y) (0.5 at y == 0, as jnp.maximum gives),
//   A[n,c] = sum_hw gy, B[n,c] = sum_hw gy * xhat,
//   c1 = sum_{c in g} scale[c] * A[n,c] / M, c2 likewise with B,
//   dx = r * (gy * scale - c1 - xhat * c2), dbias = sum_n A, dscale = sum_n B.
// What bounds it on an H100: x and dy read once and dx written once (6
// bytes an element in bf16), memory at 3.35 TB/s; about 15 f32 operations
// an element. Two bodies, chosen by shape in ops/group_norm.py
// (backward_cluster_plan); both recompute the statistics from x, and
// neither uses float atomics, so two launches on one input give the same
// bits:
//
// group_norm_bwd_cluster, two launches: gn_bwd_cluster, one thread-block
//   cluster of k CTAs a sample (k a power of two up to 16, as gn_cluster),
//   CTA q holding rows [q*R, min((q+1)*R, H*W)) of both x and dy in
//   shared memory, copied from device memory once with cp.async (x in
//   four chunks of rows whose first pass overlaps the later copies, then
//   dy). The statistics are gn_cluster's (cluster_statistics, the same
//   code and order of sums). Then per channel sum gy and sum gy * xhat:
//   each thread over its rows in row order, the row threads in order;
//   per group sum_c scale[c] * those, channels in order, exchanged over
//   distributed shared memory in rank order into c1 and c2; each channel's
//   sums over the CTAs in rank order go to f32 scratch part [N, C, 2]; dx
//   from shared memory, stored in words of the copy's width, and a last
//   cluster.sync(). The ReLU is a compile-time branch of the sums and dx
//   loops, both through bwd_element, so both see one mask. gn_bwd_fold
//   then sums part over the samples in sample order into dscale and dbias
//   (a second launch, one thread a channel). It reads x and dy once and
//   writes dx once. Where x and dy of a sample pass 16 * 227 KB (f32 at
//   112x112x64, 56x56x256 or 112x112x128) there is no plan and the
//   five-launch body runs.
//
// group_norm_bwd, five launches, every pass over the same tiles of rows
//   (grid: tiles x samples), reading x three times and dy twice (about 12
//   bytes an element): gn_bwd_stats takes each tile's moments per group
//   in one pass (sums shifted by a value of the tile, so that a large
//   mean costs no precision) and the tiled body's gn_merge merges them
//   into (mean, rstd); gn_bwd_reduce sums gy and gy*xhat per channel in
//   registers over its rows in row order, then its row threads in order,
//   into float2 partials [N, tiles, C]; gn_bwd_merge (one block a group)
//   folds the tiles in tile order into A and B, forms c1 and c2 per
//   sample in channel order and dscale and dbias in sample order;
//   gn_bwd_apply reads x and dy again and writes dx. Loads and stores
//   move words of 16 bytes where C * elt and the pointers allow (else 8,
//   4 or 2).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

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

namespace {

// ---------------------------------------------------------------------
// The cluster body
// ---------------------------------------------------------------------

namespace cgrp = cooperative_groups;

// 227 KB, the most dynamic shared memory a block may take on sm_90
constexpr int kMaxSmem = 232448;
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kChunks = 4;

template <int B> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

__device__ __forceinline__ unsigned lane32(uint4 w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}
__device__ __forceinline__ unsigned lane32(uint2 w, int i) {
  return i == 0 ? w.x : w.y;
}
__device__ __forceinline__ unsigned lane32(unsigned w, int) { return w; }

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// the B / sizeof(T) elements of one word, as floats
template <typename T, int B>
__device__ __forceinline__ void unpack(typename Word<B>::type w, float* f) {
  constexpr int VEC = B / (int)sizeof(T);
  if constexpr (B == 2) {
    f[0] = __uint_as_float((unsigned)w << 16);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if constexpr (sizeof(T) == 4) {
        f[j] = __uint_as_float(lane32(w, j));
      } else {
        const unsigned u = lane32(w, j >> 1);
        f[j] = __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
      }
    }
  }
}

// B / sizeof(T) floats rounded to nearest into one word of T
template <typename T, int B>
__device__ __forceinline__ typename Word<B>::type pack(const float* f) {
  if constexpr (B == 2) {
    return (unsigned short)bf16_bits(f[0]);
  } else {
    constexpr int L = B / 4;
    unsigned u[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if constexpr (sizeof(T) == 4)
        u[i] = __float_as_uint(f[i]);
      else
        u[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
    }
    if constexpr (L == 4) return make_uint4(u[0], u[1], u[2], u[3]);
    else if constexpr (L == 2) return make_uint2(u[0], u[1]);
    else return u[0];
  }
}

// one B-byte word from device to shared memory: cp.async for 4, 8 and 16
// bytes (both addresses aligned to B), a plain copy for 2
template <int B>
__device__ __forceinline__ void copy_word(typename Word<B>::type* dst,
                                          const typename Word<B>::type* src) {
  if constexpr (B == 2) {
    *dst = *src;
  } else {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (B == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                   "l"(src), "n"(B)
                   : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}

// words [e0, e1) of src into dst, a word a thread in turn
template <int B>
__device__ __forceinline__ void copy_words(typename Word<B>::type* dst,
                                           const typename Word<B>::type* src,
                                           int e0, int e1) {
  for (int e = e0 + (int)threadIdx.x; e < e1; e += (int)blockDim.x)
    copy_word<B>(dst + e, src + e);
}

// A thread's VEC per-channel sums folded into the group segments of its
// vector (seg channels each, in channel order), written to out[0..VEC/seg)
// or added to what is there
template <int VEC>
__device__ __forceinline__ void fold_segments(const float* acc, float* out,
                                              int seg, bool add) {
  float run = 0.f;
  int s = 0;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    run += acc[j];
    if ((j + 1) % seg == 0) {
      out[s] = add ? out[s] + run : run;
      run = 0.f;
      ++s;
    }
  }
}

// The shared memory gn_cluster carves: the slab (rounded up to 16
// bytes), part2 and gstat [G] float2, part1 [G] float, and two buffers
// of [rt][C/seg] floats. ops/group_norm.py:cluster_smem mirrors it.
long cluster_smem(long R, long C, long G, long elt, long vec, long threads,
                  long seg) {
  const long cv = C / vec;
  const long rt = threads / (cv < threads ? cv : threads);
  return ((R * C * elt + 15) & ~15L) + 20 * G + 8 * rt * (C / seg);
}

// Passes 1 and 2 of a cluster body (steps 1-3 above) over the CTA's
// `rows` rows of x in `slab`, whose kChunks copy groups were committed
// before `later` more: every CTA of the cluster ends with the same (mean,
// rstd) per group in gstat. part1 [G] and part2 [G] are read by the other
// CTAs, buf and buf2 hold [rt][C/seg] floats each. Ends with
// __syncthreads().
template <typename T, int B>
__device__ __forceinline__ void cluster_statistics(
    cgrp::cluster_group& cluster, const typename Word<B>::type* slab,
    int rows, int later, int HW, int C, int G, int seg, float eps,
    float* part1, float2* part2, float2* gstat, float* buf, float* buf2) {
  constexpr int VEC = B / (int)sizeof(T);
  const int k = (int)cluster.num_blocks();
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int CV = C / VEC;  // vectors a row
  const int ct = min(CV, nthreads), rt = nthreads / ct;
  const int tx = tid % ct, ty = tid / ct;
  const bool active = ty < rt;
  const int cg = C / G;
  const int NS = C / seg;      // segments a row
  const int segv = VEC / seg;  // segments a vector
  const int spg = cg / seg;    // segments a group
  const float count = (float)HW * (float)cg;

  // pass 1: sums, a chunk as soon as it has landed
  for (int j = 0; j < kChunks; ++j) {
    cp_async_wait(kChunks - 1 - j + later);
    __syncthreads();
    if (active) {
      const int c1 = rows * (j + 1) / kChunks;
      for (int cv = tx; cv < CV; cv += ct) {
        float acc[VEC] = {};
#pragma unroll 4
        for (int r = rows * j / kChunks + ty; r < c1; r += rt) {
          float f[VEC];
          unpack<T, B>(slab[(size_t)r * CV + cv], f);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += f[i];
        }
        fold_segments<VEC>(acc, buf + ty * NS + cv * segv, seg, j > 0);
      }
    }
  }
  __syncthreads();
  for (int s = tid; s < NS; s += nthreads) {
    float v = buf[s];
    for (int t = 1; t < rt; ++t) v += buf[t * NS + s];
    buf[s] = v;
  }
  __syncthreads();
  for (int g = tid; g < G; g += nthreads) {
    float v = 0.f;
    for (int i = 0; i < spg; ++i) v += buf[g * spg + i];
    part1[g] = v;
  }
  cluster.sync();
  for (int g = tid; g < G; g += nthreads) {
    float tot = 0.f;
    for (int r = 0; r < k; ++r) tot += cluster.map_shared_rank(part1, r)[g];
    gstat[g].x = tot / count;
  }
  __syncthreads();

  // pass 2: sum(x - m) and sum((x - m)^2) in the same order
  if (active) {
    for (int cv = tx; cv < CV; cv += ct) {
      float m[VEC], sd[VEC] = {}, sq[VEC] = {};
#pragma unroll
      for (int i = 0; i < VEC; ++i) m[i] = gstat[(cv * VEC + i) / cg].x;
#pragma unroll 4
      for (int r = ty; r < rows; r += rt) {
        float f[VEC];
        unpack<T, B>(slab[(size_t)r * CV + cv], f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = f[i] - m[i];
          sd[i] += d;
          sq[i] = fmaf(d, d, sq[i]);
        }
      }
      fold_segments<VEC>(sd, buf + ty * NS + cv * segv, seg, false);
      fold_segments<VEC>(sq, buf2 + ty * NS + cv * segv, seg, false);
    }
  }
  __syncthreads();
  for (int s = tid; s < NS; s += nthreads) {
    float v = buf[s], w = buf2[s];
    for (int t = 1; t < rt; ++t) {
      v += buf[t * NS + s];
      w += buf2[t * NS + s];
    }
    buf[s] = v;
    buf2[s] = w;
  }
  __syncthreads();
  for (int g = tid; g < G; g += nthreads) {
    float v = 0.f, w = 0.f;
    for (int i = 0; i < spg; ++i) {
      v += buf[g * spg + i];
      w += buf2[g * spg + i];
    }
    part2[g] = make_float2(v, w);
  }
  cluster.sync();
  for (int g = tid; g < G; g += nthreads) {
    float d = 0.f, s2 = 0.f;
    for (int r = 0; r < k; ++r) {
      const float2 p = cluster.map_shared_rank(part2, r)[g];
      d += p.x;
      s2 += p.y;
    }
    const float dm = d / count;
    const float var = fmaxf(s2 / count - dm * dm, 0.f);
    gstat[g] = make_float2(gstat[g].x + dm, 1.0f / sqrtf(var + eps));
  }
  __syncthreads();
}

// grid: N * k CTAs in clusters of k along x, one cluster per sample;
// blockDim.x threads (a multiple of 32, at most 512).
template <typename T, int B>
__global__ void __launch_bounds__(kMaxThreads)
    gn_cluster(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y, int HW,
               int C, int G, int R, int seg, int relu, float eps) {
  constexpr int VEC = B / (int)sizeof(T);
  using W = typename Word<B>::type;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int n = blockIdx.x / k;
  const int r0 = q * R;
  const int rows = max(0, min(R, HW - r0));
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int CV = C / VEC;  // vectors a row
  const int ct = min(CV, nthreads), rt = nthreads / ct;
  const int tx = tid % ct, ty = tid / ct;
  const bool active = ty < rt;
  const int cg = C / G;
  const int NS = C / seg;  // segments a row

  extern __shared__ __align__(16) unsigned char shm[];
  W* slab = reinterpret_cast<W*>(shm);
  const size_t slab_bytes =
      ((size_t)R * C * sizeof(T) + 15) & ~(size_t)15;
  float2* part2 = reinterpret_cast<float2*>(shm + slab_bytes);
  float2* gstat = part2 + G;
  float* part1 = reinterpret_cast<float*>(gstat + G);
  float* buf = part1 + G;
  float* buf2 = buf + rt * NS;

  // the slab, from device memory once, in kChunks groups of rows
  const size_t base = ((size_t)n * HW + r0) * C;
  const W* src = reinterpret_cast<const W*>(x + base);
  for (int j = 0; j < kChunks; ++j) {
    copy_words<B>(slab, src, rows * j / kChunks * CV,
                  rows * (j + 1) / kChunks * CV);
    cp_async_commit();
  }
  cluster_statistics<T, B>(cluster, slab, rows, 0, HW, C, G, seg, eps,
                           part1, part2, gstat, buf, buf2);

  // normalise from shared memory; one store a word
  if (active) {
    W* dst = reinterpret_cast<W*>(y + base);
    for (int cv = tx; cv < CV; cv += ct) {
      float m[VEC], a[VEC], b[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int c = cv * VEC + i;
        const float2 st = gstat[c / cg];
        m[i] = st.x;
        a[i] = st.y * scale[c];
        b[i] = bias[c];
      }
#pragma unroll 4
      for (int r = ty; r < rows; r += rt) {
        float f[VEC];
        unpack<T, B>(slab[(size_t)r * CV + cv], f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float v = fmaf(f[i] - m[i], a[i], b[i]);
          f[i] = relu ? fmaxf(v, 0.f) : v;
        }
        dst[(size_t)r * CV + cv] = pack<T, B>(f);
      }
    }
  }
  // no CTA leaves while another may still read its part2
  cluster.sync();
}

template <typename T, int B>
struct Instance {
  using type = T;
  static constexpr int bytes = B;
};

// calls f(Instance<T, B>{}) for the kernel of (dtype, vector bytes)
template <typename F>
int with_instance(int dtype, int vec_bytes, F&& f) {
  if (dtype == 1) {
    switch (vec_bytes) {
      case 16: return f(Instance<__nv_bfloat16, 16>{});
      case 8: return f(Instance<__nv_bfloat16, 8>{});
      case 4: return f(Instance<__nv_bfloat16, 4>{});
      case 2: return f(Instance<__nv_bfloat16, 2>{});
    }
  } else if (dtype == 0) {
    switch (vec_bytes) {
      case 16: return f(Instance<float, 16>{});
      case 8: return f(Instance<float, 8>{});
      case 4: return f(Instance<float, 4>{});
    }
  }
  return (int)cudaErrorInvalidValue;
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int N, int k,
                                  int threads, int smem,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)N * (unsigned)k);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// (kernel, device, k, threads, smem) whose attributes are set and whose
// clusters were seen to fit, so that later launches skip the queries
struct Checked {
  const void* fn;
  int device, k, threads, smem, clusters;
};
std::mutex checked_mu;
std::vector<Checked> checked;

// Sets a cluster kernel's shared-memory limit (and the non-portable
// cluster size above 8) and asks how many clusters of (k, threads, smem)
// fit on the card at once; *clusters = 0 means none can run.
template <typename... A>
int occupancy(void (*kernel)(A...), int k, int threads, int smem,
              int* clusters) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  {
    std::lock_guard<std::mutex> lock(checked_mu);
    for (const Checked& c : checked)
      if (c.fn == fn && c.device == device && c.k == k &&
          c.threads == threads && c.smem == smem) {
        *clusters = c.clusters;
        return 0;
      }
  }
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  if (k > 8) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, 1, k, threads, smem, 0);
  e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(checked_mu);
  checked.push_back({fn, device, k, threads, smem, *clusters});
  return 0;
}

template <typename T, int B>
int cluster_occupancy(int k, int threads, int smem, int* clusters) {
  return occupancy(gn_cluster<T, B>, k, threads, smem, clusters);
}

template <typename T, int B>
int launch_cluster(const void* x, const float* scale, const float* bias,
                   void* y, int N, int HW, int C, int G, int k, int R,
                   int threads, int seg, int smem, int relu, float eps,
                   cudaStream_t stream) {
  constexpr int VEC = B / (int)sizeof(T);
  // the plan must cover every row and give the kernel the shared memory
  // it carves
  if (N < 1 || HW < 1 || G < 1 || C % G || C % VEC || seg < 1 ||
      VEC % seg || (C / G) % seg || k < 1 || k > kMaxCluster || R < 1 ||
      (long)R * k < HW || threads < 32 || threads > kMaxThreads ||
      threads % 32 || smem > kMaxSmem ||
      cluster_smem(R, C, G, sizeof(T), VEC, threads, seg) > smem)
    return (int)cudaErrorInvalidValue;
  int clusters = 0;
  int e = cluster_occupancy<T, B>(k, threads, smem, &clusters);
  if (e != 0) return e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, N, k, threads, smem, stream);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_cluster<T, B>, static_cast<const T*>(x), scale, bias,
      static_cast<T*>(y), HW, C, G, R, seg, relu, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vec_bytes: the width of every copy,
// load and store (16, 8, 4, or 2 for bfloat16), which C * elt and the
// x and y pointers must be multiples of. One launch of N * k CTAs.
extern "C" int group_norm_fwd_cluster(const void* x, const float* scale,
                                      const float* bias, void* y, int dtype,
                                      int vec_bytes, int N, int HW, int C,
                                      int G, int k, int rows, int threads,
                                      int seg, int smem, int relu, float eps,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_instance(dtype, vec_bytes, [&](auto inst) {
    using I = decltype(inst);
    return launch_cluster<typename I::type, I::bytes>(
        x, scale, bias, y, N, HW, C, G, k, rows, threads, seg, smem, relu,
        eps, s);
  });
}

// How many clusters of k CTAs of (threads, smem) the card holds at once
// (into *clusters); the same query the launch makes.
extern "C" int group_norm_cluster_occupancy(int dtype, int vec_bytes, int k,
                                            int threads, int smem,
                                            int* clusters) {
  if (k < 1 || k > kMaxCluster || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return with_instance(dtype, vec_bytes, [&](auto inst) {
    using I = decltype(inst);
    return cluster_occupancy<typename I::type, I::bytes>(k, threads, smem,
                                                         clusters);
  });
}

namespace {

// ---------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdMergeThreads = 512;

// the ReLU's derivative at y, as jnp.maximum(y, 0) gives it: 0.5 at a tie
__device__ __forceinline__ float relu_grad(float y) {
  return y > 0.f ? 1.f : (y == 0.f ? 0.5f : 0.f);
}

// the sum over a warp's lanes by a fixed shuffle tree, in every lane
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// xhat and the masked gradient of one element; the reduce and apply
// passes call this same code, so both see the same mask
__device__ __forceinline__ void bwd_element(float xv, float g, float m,
                                            float r, float s, float b,
                                            int relu, float& xh,
                                            float& gy) {
  xh = (xv - m) * r;
  gy = relu ? g * relu_grad(fmaf(xh, s, b)) : g;
}

// The statistics of one tile of rows, per group: (mean, M2) as gn_merge
// takes them, in one pass of word loads. Each channel's values are summed
// shifted by the tile's first value of that channel, K_c (near the mean,
// so x - K_c is exact and small at any offset): S1 = sum(x - K_c),
// S2 = sum((x - K_c)^2) per thread over its rows in row order, then the
// row threads in order. A warp then takes a group, lane l its channels
// l, l + 32, ... in order and then a fixed shuffle tree: with
// d_c = (K_c - K_0) + S1/n and M2_c = S2 - S1^2/n over the tile's n rows,
// mean = K_0 + mean_c(d_c) and M2 = sum_c(M2_c + n (d_c - mean_c(d))^2).
// grid (row tiles, samples); kBwdThreads threads as ct vector threads x
// rt row threads. Dynamic shared memory: [rt][C] float2, then K [C].
template <typename T, int B>
__global__ void __launch_bounds__(kBwdThreads)
    gn_bwd_stats(const T* __restrict__ x, float2* __restrict__ part, int HW,
                 int C, int G, int tile_rows, int ntiles) {
  constexpr int VEC = B / (int)sizeof(T);
  using W = typename Word<B>::type;
  extern __shared__ float2 sbuf[];
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int CV = C / VEC;
  const int ct = min(CV, nthreads), rt = nthreads / ct;
  float* kbuf = reinterpret_cast<float*>(sbuf + (size_t)rt * C);
  const int tx = tid % ct, ty = tid / ct;
  const int tile = blockIdx.x, n = blockIdx.y;
  const int cg = C / G;
  const int r0 = tile * tile_rows;
  const int rows = min(tile_rows, HW - r0);
  const size_t base = ((size_t)n * HW + r0) * C;
  const W* xs = reinterpret_cast<const W*>(x + base);
  if (ty < rt) {
    for (int cv = tx; cv < CV; cv += ct) {
      float k[VEC], s1[VEC] = {}, s2[VEC] = {};
      unpack<T, B>(xs[cv], k);
      if (ty == 0) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kbuf[cv * VEC + i] = k[i];
      }
#pragma unroll 4
      for (int row = ty; row < rows; row += rt) {
        float f[VEC];
        unpack<T, B>(xs[(size_t)row * CV + cv], f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = f[i] - k[i];
          s1[i] += d;
          s2[i] = fmaf(d, d, s2[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        sbuf[ty * C + cv * VEC + i] = make_float2(s1[i], s2[i]);
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += nthreads) {
    float2 v = sbuf[c];
    for (int j = 1; j < rt; ++j) {
      const float2 w = sbuf[j * C + c];
      v.x += w.x;
      v.y += w.y;
    }
    sbuf[c] = v;
  }
  __syncthreads();
  const float nr = (float)rows;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  for (int g = warp; g < G; g += nwarps) {
    const int c0 = g * cg;
    const float k0 = kbuf[c0];
    float d = 0.f;
    for (int j = lane; j < cg; j += 32)
      d += (kbuf[c0 + j] - k0) + sbuf[c0 + j].x / nr;
    const float dbar = warp_sum(d) / (float)cg;
    float m2 = 0.f;
    for (int j = lane; j < cg; j += 32) {
      const float2 v = sbuf[c0 + j];
      const float e = (kbuf[c0 + j] - k0) + v.x / nr - dbar;
      m2 += (v.y - v.x * (v.x / nr)) + nr * e * e;
    }
    m2 = warp_sum(m2);
    if (lane == 0)
      part[((size_t)n * ntiles + tile) * G + g] = make_float2(k0 + dbar, m2);
  }
}

// grid (row tiles, samples); kBwdThreads threads as ct vector threads x
// rt row threads. Dynamic shared memory: [rt][C] float2.
template <typename T, int B>
__global__ void __launch_bounds__(kBwdThreads)
    gn_bwd_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float2* __restrict__ stats,
                  float2* __restrict__ part, int HW, int C, int G,
                  int tile_rows, int ntiles, int relu) {
  constexpr int VEC = B / (int)sizeof(T);
  using W = typename Word<B>::type;
  extern __shared__ float2 sbuf[];
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int CV = C / VEC;
  const int ct = min(CV, nthreads), rt = nthreads / ct;
  const int tx = tid % ct, ty = tid / ct;
  const int tile = blockIdx.x, n = blockIdx.y;
  const int cg = C / G;
  const int r0 = tile * tile_rows;
  const int rows = min(tile_rows, HW - r0);
  const size_t base = ((size_t)n * HW + r0) * C;
  const W* xs = reinterpret_cast<const W*>(x + base);
  const W* gs = reinterpret_cast<const W*>(dy + base);
  if (ty < rt) {
    for (int cv = tx; cv < CV; cv += ct) {
      float m[VEC], r[VEC], s[VEC], b[VEC], a[VEC] = {}, q[VEC] = {};
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int c = cv * VEC + i;
        const float2 st = stats[n * G + c / cg];
        m[i] = st.x;
        r[i] = st.y;
        s[i] = scale[c];
        b[i] = bias[c];
      }
#pragma unroll 2
      for (int row = ty; row < rows; row += rt) {
        float f[VEC], g[VEC];
        unpack<T, B>(xs[(size_t)row * CV + cv], f);
        unpack<T, B>(gs[(size_t)row * CV + cv], g);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float xh, gy;
          bwd_element(f[i], g[i], m[i], r[i], s[i], b[i], relu, xh, gy);
          a[i] += gy;
          q[i] = fmaf(gy, xh, q[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        sbuf[ty * C + cv * VEC + i] = make_float2(a[i], q[i]);
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += nthreads) {
    float2 v = sbuf[c];
    for (int j = 1; j < rt; ++j) {
      const float2 w = sbuf[j * C + c];
      v.x += w.x;
      v.y += w.y;
    }
    part[((size_t)n * ntiles + tile) * C + c] = v;
  }
}

// grid: one block a group. Folds each (n, c) of the group over its tiles
// in tile order into A, B (left in tile 0's slot of part), then c1, c2
// per sample (channels in order) and dbias, dscale per channel (samples
// in order).
__global__ void __launch_bounds__(kBwdMergeThreads)
    gn_bwd_merge(float2* __restrict__ part, const float* __restrict__ scale,
                 float2* __restrict__ coef, float* __restrict__ dscale,
                 float* __restrict__ dbias, int N, int HW, int C, int G,
                 int ntiles) {
  const int g = blockIdx.x, cg = C / G, c0 = g * cg;
  const size_t nstride = (size_t)ntiles * C;
  for (int p = threadIdx.x; p < N * cg; p += blockDim.x) {
    float2* pp = part + (p / cg) * nstride + c0 + p % cg;
    float2 v = pp[0];
#pragma unroll 4
    for (int t = 1; t < ntiles; ++t) {
      const float2 w = pp[(size_t)t * C];
      v.x += w.x;
      v.y += w.y;
    }
    pp[0] = v;
  }
  __syncthreads();
  const float count = (float)HW * (float)cg;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float2* pp = part + n * nstride + c0;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 16
    for (int j = 0; j < cg; ++j) {
      const float s = scale[c0 + j];
      const float2 v = pp[j];
      s1 = fmaf(s, v.x, s1);
      s2 = fmaf(s, v.y, s2);
    }
    coef[n * G + g] = make_float2(s1 / count, s2 / count);
  }
  for (int j = threadIdx.x; j < cg; j += blockDim.x) {
    float a = 0.f, b = 0.f;
#pragma unroll 16
    for (int n = 0; n < N; ++n) {
      const float2 v = part[n * nstride + c0 + j];
      a += v.x;
      b += v.y;
    }
    dbias[c0 + j] = a;
    dscale[c0 + j] = b;
  }
}

// grid (row tiles, samples), the threads as in gn_bwd_reduce
template <typename T, int B>
__global__ void __launch_bounds__(kBwdThreads)
    gn_bwd_apply(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float2* __restrict__ stats,
                 const float2* __restrict__ coef, T* __restrict__ dx,
                 int HW, int C, int G, int tile_rows, int relu) {
  constexpr int VEC = B / (int)sizeof(T);
  using W = typename Word<B>::type;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int CV = C / VEC;
  const int ct = min(CV, nthreads), rt = nthreads / ct;
  const int tx = tid % ct, ty = tid / ct;
  if (ty >= rt) return;
  const int tile = blockIdx.x, n = blockIdx.y;
  const int cg = C / G;
  const int r0 = tile * tile_rows;
  const int rows = min(tile_rows, HW - r0);
  const size_t base = ((size_t)n * HW + r0) * C;
  const W* xs = reinterpret_cast<const W*>(x + base);
  const W* gs = reinterpret_cast<const W*>(dy + base);
  W* out = reinterpret_cast<W*>(dx + base);
  for (int cv = tx; cv < CV; cv += ct) {
    float m[VEC], r[VEC], s[VEC], b[VEC], c1[VEC], c2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = cv * VEC + i;
      const float2 st = stats[n * G + c / cg];
      const float2 k = coef[n * G + c / cg];
      m[i] = st.x;
      r[i] = st.y;
      s[i] = scale[c];
      b[i] = bias[c];
      c1[i] = k.x;
      c2[i] = k.y;
    }
#pragma unroll 2
    for (int row = ty; row < rows; row += rt) {
      float f[VEC], g[VEC];
      unpack<T, B>(xs[(size_t)row * CV + cv], f);
      unpack<T, B>(gs[(size_t)row * CV + cv], g);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float xh, gy;
        bwd_element(f[i], g[i], m[i], r[i], s[i], b[i], relu, xh, gy);
        f[i] = r[i] * fmaf(-xh, c2[i], fmaf(gy, s[i], -c1[i]));
      }
      out[(size_t)row * CV + cv] = pack<T, B>(f);
    }
  }
}

// The shared memory of the backward's tile kernels at C channels, with
// their limits set where it passes the default 48 KB: [rt][C] float2 for
// gn_bwd_reduce (*smem), and K [C] after it for gn_bwd_stats
// (*stats_smem).
template <typename T, int B>
int bwd_smem(int C, size_t* smem, size_t* stats_smem) {
  constexpr int VEC = B / (int)sizeof(T);
  if (C < VEC || C % VEC) return (int)cudaErrorInvalidValue;
  const int CV = C / VEC;
  const int brt = kBwdThreads / (CV < kBwdThreads ? CV : kBwdThreads);
  *smem = (size_t)brt * C * sizeof(float2);
  *stats_smem = *smem + (size_t)C * sizeof(float);
  if (*stats_smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (*stats_smem > kDefaultSmem)
    e = cudaFuncSetAttribute(gn_bwd_stats<T, B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*stats_smem);
  if (e == cudaSuccess && *smem > kDefaultSmem)
    e = cudaFuncSetAttribute(gn_bwd_reduce<T, B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
  return (int)e;
}

// CTAs of the backward's tile kernels the card holds at once: its SMs
// times the fewest of gn_bwd_stats, gn_bwd_reduce and gn_bwd_apply an SM
// holds at C channels
template <typename T, int B>
int bwd_resident(int C, int* ctas) {
  size_t smem, stats_smem;
  int e = bwd_smem<T, B>(C, &smem, &stats_smem);
  if (e != 0) return e;
  int device = 0, sms = 0, a = 0, b = 0, c = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &a, gn_bwd_stats<T, B>, kBwdThreads, stats_smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, gn_bwd_reduce<T, B>, kBwdThreads, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c, gn_bwd_apply<T, B>, kBwdThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *ctas = sms * min(a, min(b, c));
  return 0;
}

template <typename T, int B>
int launch_bwd(const void* x, const void* dy, const float* scale,
               const float* bias, void* dx, float* dscale, float* dbias,
               float* part, float* stats, float* bpart, float* coef, int N,
               int HW, int C, int G, int tile_rows, int ntiles, int relu,
               float eps, cudaStream_t stream) {
  // the tiling must cover every row, none with an empty tile
  if (N < 1 || HW < 1 || G < 1 || C % G || tile_rows < 1 ||
      (long)tile_rows * ntiles < HW || (long)tile_rows * (ntiles - 1) >= HW)
    return (int)cudaErrorInvalidValue;
  const int cg = C / G;
  size_t smem, stats_smem;
  int e = bwd_smem<T, B>(C, &smem, &stats_smem);
  if (e != 0) return e;
  const dim3 grid(ntiles, N);

  // 1-2: (mean, rstd) per (sample, group): the tiles' moments, merged
  gn_bwd_stats<T, B><<<grid, kBwdThreads, stats_smem, stream>>>(
      static_cast<const T*>(x), reinterpret_cast<float2*>(part), HW, C, G,
      tile_rows, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NG = N * G;
  const int merge_threads = 256;
  gn_merge<<<(NG * 32 + merge_threads - 1) / merge_threads, merge_threads, 0,
             stream>>>(reinterpret_cast<const float2*>(part),
                       reinterpret_cast<float2*>(stats), NG, G, HW, cg,
                       tile_rows, ntiles, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 3: per-tile, per-channel sums of gy and gy * xhat
  const float2* st = reinterpret_cast<const float2*>(stats);
  gn_bwd_reduce<T, B><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), scale, bias, st,
      reinterpret_cast<float2*>(bpart), HW, C, G, tile_rows, ntiles, relu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 4: A, B, c1, c2, dscale, dbias
  gn_bwd_merge<<<G, kBwdMergeThreads, 0, stream>>>(
      reinterpret_cast<float2*>(bpart), scale,
      reinterpret_cast<float2*>(coef), dscale, dbias, N, HW, C, G, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 5: dx
  gn_bwd_apply<T, B><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), scale, bias, st,
      reinterpret_cast<const float2*>(coef), static_cast<T*>(dx), HW, C, G,
      tile_rows, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward of GroupNorm(+ReLU): dx (x's type) and float32 dscale,
// dbias [C]. dtype: 0 = float32, 1 = bfloat16; vec_bytes: the width of
// every load and store of x, dy and dx (16, 8, 4, or 2 for bfloat16),
// which C * elt and the three pointers must be multiples of. Every pass
// cuts each sample into ntiles tiles of tile_rows rows. Scratch from the
// caller, all float32: part [N, ntiles, G, 2] and stats [N, G, 2] of the
// statistics, bpart [N, ntiles, C, 2] of the sums and coef [N, G, 2].
// Five launches on `stream`.
extern "C" int group_norm_bwd(const void* x, const void* dy,
                              const float* scale, const float* bias,
                              void* dx, float* dscale, float* dbias,
                              float* part, float* stats, float* bpart,
                              float* coef, int dtype, int vec_bytes, int N,
                              int HW, int C, int G, int tile_rows,
                              int ntiles, int relu, float eps,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_instance(dtype, vec_bytes, [&](auto inst) {
    using I = decltype(inst);
    return launch_bwd<typename I::type, I::bytes>(
        x, dy, scale, bias, dx, dscale, dbias, part, stats, bpart, coef, N,
        HW, C, G, tile_rows, ntiles, relu, eps, s);
  });
}

// CTAs of the backward's tile kernels the current card holds at once
// (into *ctas), for C channels of dtype in words of vec_bytes
extern "C" int group_norm_bwd_resident(int dtype, int vec_bytes, int C,
                                       int* ctas) {
  return with_instance(dtype, vec_bytes, [&](auto inst) {
    using I = decltype(inst);
    return bwd_resident<typename I::type, I::bytes>(C, ctas);
  });
}

namespace {

// ---------------------------------------------------------------------
// The backward's cluster body
// ---------------------------------------------------------------------

// The shared memory gn_bwd_cluster carves: the slabs of x and of dy
// (each rounded up to 16 bytes); part2,
// gstat, part3 and coef [G] float2; cpart [C] float2; a work area of
// rt * max(ct * VEC, 2 * C/seg) floats (the row threads' sums a channel,
// or the statistics' two buffers); part1 [G] float.
// ops/group_norm.py:backward_cluster_smem mirrors it.
long bwd_cluster_smem(long R, long C, long G, long elt, long vec,
                      long threads, long seg) {
  const long cv = C / vec;
  const long ct = cv < threads ? cv : threads;
  const long rt = threads / ct;
  const long cw = ct * vec, sw = 2 * (C / seg);
  const long slab = (R * C * elt + 15) & ~15L;
  return 2 * slab + 36 * G + 8 * C +
         4 * rt * (cw > sw ? cw : sw);
}

// The per-channel sums of the CTA's rows for one vector of channels cv:
// a[i] += gy, bq[i] += gy * xhat over rows ty, ty + rt, ... in row order
template <typename T, int B, bool RELU>
__device__ __forceinline__ void bwd_row_sums(
    const typename Word<B>::type* xslab, const typename Word<B>::type* gslab,
    const float2* gstat, const float* scale, const float* bias, int cv,
    int CV, int cg, int rows, int ty, int rt, float* a, float* bq) {
  constexpr int VEC = B / (int)sizeof(T);
  float m[VEC], r[VEC], s[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = cv * VEC + i;
    const float2 st = gstat[c / cg];
    m[i] = st.x;
    r[i] = st.y;
    s[i] = scale[c];
    b[i] = bias[c];
  }
#pragma unroll 4
  for (int row = ty; row < rows; row += rt) {
    float f[VEC], g[VEC];
    unpack<T, B>(xslab[(size_t)row * CV + cv], f);
    unpack<T, B>(gslab[(size_t)row * CV + cv], g);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float xh, gy;
      bwd_element(f[i], g[i], m[i], r[i], s[i], b[i], RELU, xh, gy);
      a[i] += gy;
      bq[i] = fmaf(gy, xh, bq[i]);
    }
  }
}

// dx of the CTA's rows for the vectors of channels tx, tx + ct, ...
template <typename T, int B, bool RELU>
__device__ __forceinline__ void bwd_rows_dx(
    const typename Word<B>::type* xslab, const typename Word<B>::type* gslab,
    typename Word<B>::type* out, const float2* gstat, const float2* coef,
    const float* scale, const float* bias, int CV, int cg, int rows, int tx,
    int ct, int ty, int rt) {
  constexpr int VEC = B / (int)sizeof(T);
  for (int cv = tx; cv < CV; cv += ct) {
    float m[VEC], r[VEC], s[VEC], b[VEC], c1[VEC], c2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = cv * VEC + i;
      const float2 st = gstat[c / cg];
      const float2 kf = coef[c / cg];
      m[i] = st.x;
      r[i] = st.y;
      s[i] = scale[c];
      b[i] = bias[c];
      c1[i] = kf.x;
      c2[i] = kf.y;
    }
#pragma unroll 4
    for (int row = ty; row < rows; row += rt) {
      float f[VEC], g[VEC];
      unpack<T, B>(xslab[(size_t)row * CV + cv], f);
      unpack<T, B>(gslab[(size_t)row * CV + cv], g);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float xh, gy;
        bwd_element(f[i], g[i], m[i], r[i], s[i], b[i], RELU, xh, gy);
        f[i] = r[i] * fmaf(-xh, c2[i], fmaf(gy, s[i], -c1[i]));
      }
      out[(size_t)row * CV + cv] = pack<T, B>(f);
    }
  }
}

// grid: N * k CTAs in clusters of k along x, one cluster per sample; at
// most kBwdThreads threads (a multiple of 32). Writes dx and the sample's
// per-channel (sum gy * xhat, sum gy) to part [N, C].
template <typename T, int B>
__global__ void __launch_bounds__(kBwdThreads, 2)
    gn_bwd_cluster(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ dx,
                   float2* __restrict__ part, int HW, int C, int G, int R,
                   int seg, int relu, float eps) {
  constexpr int VEC = B / (int)sizeof(T);
  using W = typename Word<B>::type;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int n = blockIdx.x / k;
  const int r0 = q * R;
  const int rows = max(0, min(R, HW - r0));
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int CV = C / VEC;
  const int ct = min(CV, nthreads), rt = nthreads / ct;
  const int tx = tid % ct, ty = tid / ct;
  const bool active = ty < rt;
  const int cg = C / G;
  const int NS = C / seg;
  const int cw = ct * VEC;  // channels of one round of the sums
  const float count = (float)HW * (float)cg;

  extern __shared__ __align__(16) unsigned char shm[];
  const size_t slab_bytes =
      ((size_t)R * C * sizeof(T) + 15) & ~(size_t)15;
  W* xslab = reinterpret_cast<W*>(shm);
  W* gslab = reinterpret_cast<W*>(shm + slab_bytes);
  float2* part2 = reinterpret_cast<float2*>(shm + 2 * slab_bytes);
  float2* gstat = part2 + G;
  float2* part3 = gstat + G;
  float2* coef = part3 + G;
  float2* cpart = coef + G;
  float* work = reinterpret_cast<float*>(cpart + C);
  float* part1 = work + rt * max(cw, 2 * NS);

  // x in kChunks groups of rows, then dy in one group
  const size_t base = ((size_t)n * HW + r0) * C;
  const W* xs = reinterpret_cast<const W*>(x + base);
  const W* gs = reinterpret_cast<const W*>(dy + base);
  for (int j = 0; j < kChunks; ++j) {
    copy_words<B>(xslab, xs, rows * j / kChunks * CV,
                  rows * (j + 1) / kChunks * CV);
    cp_async_commit();
  }
  copy_words<B>(gslab, gs, 0, rows * CV);
  cp_async_commit();
  cluster_statistics<T, B>(cluster, xslab, rows, 1, HW, C, G, seg, eps,
                           part1, part2, gstat, work, work + rt * NS);
  cp_async_wait(0);
  __syncthreads();

  // per channel, sum gy and sum gy * xhat over the CTA's rows: each
  // thread over its rows in row order, then the row threads in order (the
  // first sum, then the second), cw channels a round
  for (int cv0 = 0; cv0 < CV; cv0 += ct) {
    const int cv = cv0 + tx;
    const bool mine = active && cv < CV;
    float a[VEC] = {}, bq[VEC] = {};
    if (mine) {
      if (relu)
        bwd_row_sums<T, B, true>(xslab, gslab, gstat, scale, bias, cv, CV,
                                 cg, rows, ty, rt, a, bq);
      else
        bwd_row_sums<T, B, false>(xslab, gslab, gstat, scale, bias, cv, CV,
                                  cg, rows, ty, rt, a, bq);
    }
    for (int h = 0; h < 2; ++h) {
      if (mine) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          work[ty * cw + tx * VEC + i] = h ? bq[i] : a[i];
      }
      __syncthreads();
      for (int j = tid; j < cw && cv0 * VEC + j < C; j += nthreads) {
        float v = work[j];
        for (int t = 1; t < rt; ++t) v += work[t * cw + j];
        float2& p = cpart[cv0 * VEC + j];
        if (h) p.y = v;
        else p.x = v;
      }
      __syncthreads();
    }
  }

  // per group, sum_c scale * (those sums), channels in order; exchanged
  // in rank order into c1 and c2
  for (int g = tid; g < G; g += nthreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      const float s = scale[g * cg + j];
      const float2 v = cpart[g * cg + j];
      s1 = fmaf(s, v.x, s1);
      s2 = fmaf(s, v.y, s2);
    }
    part3[g] = make_float2(s1, s2);
  }
  cluster.sync();
  for (int g = tid; g < G; g += nthreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < k; ++r) {
      const float2 p = cluster.map_shared_rank(part3, r)[g];
      s1 += p.x;
      s2 += p.y;
    }
    coef[g] = make_float2(s1 / count, s2 / count);
  }
  // the sample's sums per channel, the CTAs in rank order; CTA q writes
  // channels q, q + k, ...
  for (int c = q + k * tid; c < C; c += k * nthreads) {
    float sa = 0.f, sb = 0.f;
    for (int r = 0; r < k; ++r) {
      const float2 p = cluster.map_shared_rank(cpart, r)[c];
      sa += p.x;
      sb += p.y;
    }
    part[(size_t)n * C + c] = make_float2(sb, sa);
  }
  __syncthreads();

  // dx from shared memory; one store a word
  if (active) {
    W* out = reinterpret_cast<W*>(dx + base);
    if (relu)
      bwd_rows_dx<T, B, true>(xslab, gslab, out, gstat, coef, scale, bias,
                              CV, cg, rows, tx, ct, ty, rt);
    else
      bwd_rows_dx<T, B, false>(xslab, gslab, out, gstat, coef, scale, bias,
                               CV, cg, rows, tx, ct, ty, rt);
  }
  // no CTA leaves while another may still read its part3 or cpart
  cluster.sync();
}

// dscale and dbias: part [N, C] folded over the samples in sample order,
// a thread a channel (32 samples' loads in flight at once: the kernel is
// a few load latencies long)
__global__ void gn_bwd_fold(const float2* __restrict__ part,
                            float* __restrict__ dscale,
                            float* __restrict__ dbias, int N, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sb = 0.f, sa = 0.f;
#pragma unroll 32
  for (int n = 0; n < N; ++n) {
    const float2 v = part[(size_t)n * C + c];
    sb += v.x;
    sa += v.y;
  }
  dscale[c] = sb;
  dbias[c] = sa;
}

constexpr int kFoldThreads = 128;

template <typename T, int B>
int launch_bwd_cluster(const void* x, const void* dy, const float* scale,
                       const float* bias, void* dx, float* dscale,
                       float* dbias, float* part, int N, int HW, int C,
                       int G, int k, int R, int threads, int seg, int smem,
                       int relu, float eps, cudaStream_t stream) {
  constexpr int VEC = B / (int)sizeof(T);
  // the plan must cover every row and give the kernel the shared memory
  // it carves
  if (N < 1 || HW < 1 || G < 1 || C % G || C % VEC || seg < 1 ||
      VEC % seg || (C / G) % seg || k < 1 || k > kMaxCluster || R < 1 ||
      (long)R * k < HW || threads < 32 || threads > kBwdThreads ||
      threads % 32 || smem > kMaxSmem ||
      bwd_cluster_smem(R, C, G, sizeof(T), VEC, threads, seg) > smem)
    return (int)cudaErrorInvalidValue;
  int clusters = 0;
  int e = occupancy(gn_bwd_cluster<T, B>, k, threads, smem, &clusters);
  if (e != 0) return e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, N, k, threads, smem, stream);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_bwd_cluster<T, B>, static_cast<const T*>(x),
      static_cast<const T*>(dy), scale, bias, static_cast<T*>(dx),
      reinterpret_cast<float2*>(part), HW, C, G, R, seg, relu, eps);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_fold<<<(C + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0,
                stream>>>(reinterpret_cast<const float2*>(part), dscale,
                          dbias, N, C);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward's cluster body: dx (x's type) and float32 dscale, dbias
// [C] in two launches on `stream`, gn_bwd_cluster (one cluster of k CTAs
// a sample, each holding `rows` rows of x and of dy) and gn_bwd_fold.
// dtype and vec_bytes as for group_norm_bwd; part is float32 scratch
// [N, C, 2] from the caller.
extern "C" int group_norm_bwd_cluster(const void* x, const void* dy,
                                      const float* scale, const float* bias,
                                      void* dx, float* dscale, float* dbias,
                                      float* part, int dtype, int vec_bytes,
                                      int N, int HW, int C, int G, int k,
                                      int rows, int threads, int seg,
                                      int smem, int relu, float eps,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_instance(dtype, vec_bytes, [&](auto inst) {
    using I = decltype(inst);
    using T = typename I::type;
    return launch_bwd_cluster<T, I::bytes>(
        x, dy, scale, bias, dx, dscale, dbias, part, N, HW, C, G, k, rows,
        threads, seg, smem, relu, eps, s);
  });
}

// How many clusters of the backward's cluster body the current card holds
// at once (into *clusters); the same query its launch makes.
extern "C" int group_norm_bwd_cluster_occupancy(int dtype, int vec_bytes,
                                                int k, int threads,
                                                int smem, int* clusters) {
  if (k < 1 || k > kMaxCluster || smem > kMaxSmem || threads > kBwdThreads)
    return (int)cudaErrorInvalidValue;
  return with_instance(dtype, vec_bytes, [&](auto inst) {
    using I = decltype(inst);
    using T = typename I::type;
    return occupancy(gn_bwd_cluster<T, I::bytes>, k, threads, smem,
                     clusters);
  });
}
