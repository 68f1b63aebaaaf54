// Decode attention for Hopper (sm_90a): one query row per (slot, head)
// against the slot-major KV cache, online softmax over key tiles, f32
// throughout.
//
// Replaces mmlspark_tpu/ops/pallas/attention.py:_decode_call (the Pallas
// kernel behind decode_attention, body _decode_tile). Same function: q
// [S,H,D], k/v [S,H,Tk,D] (the f32 cache), one [S,Tk] int8 keep-mask
// shared by every head; scores = sum_d(q * k) * scale, masked scores at
// -inf, a running max guarded while it is still -inf, and a final division
// by max(denom, 1e-30), so that a fully masked slot (an inactive one) gives
// exact zeros. The Pallas grid steps over (slot, head) in order, each with
// the whole [Tk, D] cache tile in VMEM; that is not carried over.
//
// Design: one block per (slot, head) and WARPS warps. The keys are cut into
// tiles of 32, one key per lane, and tile j goes to warp j % WARPS. Each
// lane computes its key's score from the K row (16-byte loads, q from
// shared memory); the warp takes the tile's max and sum with shuffles and
// adds p . v to its own (m, denom, acc), each lane holding the output
// dimensions lane + 32 i. At the end the warps' partial states are merged
// in the fixed order w = 0 .. WARPS-1, with no float atomics, so a slot's
// output depends only on its own q, K, V and mask row: not on its index,
// and not on its neighbours. The engine's bit-identity of batched and
// one-shot decoding rests on that.
//
// Skipping: a warp skips a tile whose 32 mask bytes are all zero. This is
// exact. A fully masked tile has a block max of -inf, so the update keeps
// m; while m is finite the correction is exp(0) = 1 and p is 0, leaving
// m, denom and acc as they were; while no key has been seen (m = -inf) the
// correction is 0, which multiplies denom = 0 and acc = 0 by 0. Skipping
// matters because the cache horizon is mostly empty at real prompt
// lengths: the kernel reads only the K/V rows of tiles with a valid key.
//
// What bounds it on an H100 (S=32, H=12, Tk=1024, D=64): over the full
// horizon it must read k and v (201.3 MB) plus q, the mask and the output,
// about 60 us at 3.35 TB/s, against 4*S*H*Tk*D = 0.1 GFLOP, 1.5 us at the
// f32 rate: memory. Over the valid keys only, the bytes shrink with them.
// The loads are 16-byte for K and 128-byte coalesced per key for V; no
// shared-memory staging, no tensor cores (a q row of one is too thin for
// them to pay).
//
// Layout: the kernel takes strides for the slot and head axes of q and for
// the slot, head and token axes of k and v (the innermost D axis must be
// contiguous; K rows 16-byte aligned), so the layer slice ck[:, i] of the
// [S, layers, H, T, D] cache and the q view of the fused qkv projection
// need no copy. The mask and the output are contiguous. The kernel
// allocates nothing; the caller passes the output and the stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;  // keys per tile: one per lane
constexpr int MAX_D = 128;
constexpr int DPL = MAX_D / 32;  // output dimensions per lane, at most
constexpr float DENOM_FLOOR = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;

// finite: neither +-inf nor NaN (the JAX body's isfinite)
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

__global__ void __launch_bounds__(THREADS)
decode_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const int8_t* __restrict__ mask, float* __restrict__ out,
                  int H, int Tk, int D, long long qss, long long qsh,
                  long long kss, long long ksh, long long kst, long long vss,
                  long long vsh, long long vst, float scale) {
  __shared__ __align__(16) float q_s[MAX_D];
  __shared__ float m_w[WARPS];
  __shared__ float l_w[WARPS];
  __shared__ float acc_w[WARPS][MAX_D];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const float* qp = q + s * qss + h * qsh;
  const float* kp = k + s * kss + h * ksh;
  const float* vp = v + s * vss + h * vsh;
  const int8_t* mp = mask + (size_t)s * Tk;

  for (int d = tid; d < D; d += THREADS) q_s[d] = qp[d];
  __syncthreads();

  float m = -INFINITY;
  float l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  const int d4 = D / 4;
  for (int t0 = warp * TILE; t0 < Tk; t0 += WARPS * TILE) {
    const int t = t0 + lane;
    const bool keep = t < Tk && mp[t] != 0;
    if (__ballot_sync(FULL, keep) == 0u) continue;  // exact: see the note

    float sc = -INFINITY;
    if (keep) {
      const float4* kr = reinterpret_cast<const float4*>(kp + t * kst);
      float dot = 0.f;
      for (int j = 0; j < d4; ++j) {
        const float4 a = __ldg(kr + j);
        const float4 b = q4[j];
        dot = fmaf(b.x, a.x, dot);
        dot = fmaf(b.y, a.y, dot);
        dot = fmaf(b.z, a.z, dot);
        dot = fmaf(b.w, a.w, dot);
      }
      sc = dot * scale;
    }
    float mx = sc;
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    const float m_new = fmaxf(m, mx);
    // guard -inf - -inf: no key seen before this tile
    const float corr = finite(m) ? expf(m - m_new) : 0.f;
    const float p = keep ? expf(sc - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int o = 16; o; o >>= 1) psum += __shfl_xor_sync(FULL, psum, o);
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;

    // acc += sum over the tile's keys of p_c * v_c (masked keys have p = 0)
    const int kn = min(TILE, Tk - t0);
#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      const float pc = __shfl_sync(FULL, p, c);
      const float* vr = vp + (t0 + c) * vst;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(pc, __ldg(vr + d), acc[i]);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    m_w[warp] = m;
    l_w[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) acc_w[warp][d] = acc[i];
  }
  __syncthreads();

  // merge the warps in a fixed order; a warp that saw no valid key has
  // m = -inf and weighs 0, so a fully masked slot gives 0 / 1e-30 = 0
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_w[w]);
  float* op = out + ((size_t)s * H + h) * D;
  for (int d = tid; d < D; d += THREADS) {
    float a = 0.f;
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = finite(m_w[w]) ? expf(m_w[w] - mx) : 0.f;
      a = fmaf(acc_w[w][d], c, a);
      den = fmaf(l_w[w], c, den);
    }
    op[d] = a / fmaxf(den, DENOM_FLOOR);
  }
}

}  // namespace

extern "C" {

// q/k/v/out float32, mask int8. Strides are in elements: q's slot and head
// axes, k's and v's slot, head and token axes. Returns a cudaError_t.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* out, int S, int H, int Tk,
                         int D, long long q_ss, long long q_sh, long long k_ss,
                         long long k_sh, long long k_st, long long v_ss,
                         long long v_sh, long long v_st, float scale,
                         void* stream) {
  if (D < 8 || D > MAX_D || D % 8 != 0 || S < 1 || H < 1 || Tk < 1 ||
      S > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(H, S);
  decode_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int8_t*>(mask),
      static_cast<float*>(out), H, Tk, D, q_ss, q_sh, k_ss, k_sh, k_st, v_ss,
      v_sh, v_st, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
