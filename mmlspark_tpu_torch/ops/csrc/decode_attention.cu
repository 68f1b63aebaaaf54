// Decode attention for Hopper (sm_90a): one query row per (slot, head)
// against the slot-major KV cache, online softmax over key stages, f32
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
// Design: one block of WARPS warps per (slot, head), one launch a call.
// 1. Every warp scans the slot's mask row for its first and last valid key
//    [lo, hi) and takes chunk w of WARPS equal chunks of that range, so no
//    warp idles while another walks two tiles. The chunks come from the
//    slot's own mask row alone.
// 2. A warp walks its chunk in stages of KPS keys. The K rows and the V
//    rows of a stage are copied into the warp's own shared memory by
//    16-byte cp.async (whole rows, coalesced across lanes), two stages in
//    flight: K of stage s+2 is issued as soon as the scores of stage s are
//    taken, V of stage s+2 as soon as its p.v is. Each copy is a group of
//    its own, so the scores wait for K alone.
// 3. Scores from shared memory: LPK lanes a key, lane part p summing the
//    16-byte chunks p, p + 4, ... of the row against q (held in registers),
//    then two shuffles. K rows are padded to k_row_chunks(D/4) chunks (4
//    mod 8), so the two keys of a quarter-warp read opposite halves of the
//    banks. p.v from shared memory: each lane owns the output columns
//    (2e, 2e + 1) for e = lane + 32u, read as float2 from V rows that lie
//    contiguous.
// 4. The warps' (m, denom, acc) are merged in the fixed order w = 0 ..
//    WARPS-1, with no float atomics. Every sum above is taken in an order
//    fixed by D and by the slot's own mask row, so a slot's output depends
//    only on its own q, K, V and mask row, bit for bit: not on its index,
//    its neighbours or Tk. The engine's bit-identity of batched and
//    one-shot decoding rests on that.
//
// Skipping: nothing outside [lo, hi) is read, and a stage whose KPS mask
// bytes are all zero is neither copied nor computed. This is exact. A
// fully masked stage has a block max of -inf, so the update keeps m; while
// m is finite the correction is exp(0) = 1 and p is 0, leaving m, denom
// and acc as they were; while no key has been seen (m = -inf) the
// correction is 0, which multiplies denom = 0 and acc = 0 by 0. Skipping
// matters because the cache horizon is mostly empty at real prompt
// lengths: the kernel reads only the K/V rows of stages with a valid key.
// A stage with a valid key copies every row in it; masked keys get p = 0.
//
// What bounds it on an H100 (S=32, H=12, Tk=1024, D=64): over the full
// horizon it must read k and v (201.3 MB) plus q, the mask and the output,
// about 60 us at 3.35 TB/s, against 4*S*H*Tk*D = 0.1 GFLOP, 1.5 us at the
// f32 rate: memory. Over the valid keys only, the bytes shrink with them
// (10.0 us at valid lengths 16-320). No tensor cores: a q row of one is
// too thin for them to pay. Shared memory per block at D = 64 is 72 KB of
// stages and 2 KB for the merge, so the 384 blocks of the decode geometry
// are resident at once, 3 an SM on every SM. Of the variants tried on
// H100s (two to eight warps a block, two to four stages in flight, stages
// of 4 to 16 keys) none was faster on every card, and none by much: the
// keys' bytes set the time.
//
// Layout: the kernel takes strides for the slot and head axes of q and for
// the slot, head and token axes of k and v (the innermost D axis must be
// contiguous; K and V rows 16-byte aligned), so the layer slice ck[:, i]
// of the [S, layers, H, T, D] cache and the q view of the fused qkv
// projection need no copy. The mask and the output are contiguous. The
// kernel allocates nothing; the caller passes the output and the stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KPS = 8;          // keys a stage
constexpr int LPK = 32 / KPS;   // lanes a key in the scores
constexpr int NSTAGE = 2;       // stages in flight a warp
constexpr int MAX_D = 128;
constexpr float DENOM_FLOOR = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;

// 16-byte chunks a K row takes in shared memory: D/4 (even) rounded up to
// 4 mod 8, so that rows c and c + 1 start half the banks apart
__host__ __device__ constexpr int k_row_chunks(int d4) {
  return d4 + (12 - d4 % 8) % 8;
}

// 16-byte chunks of one stage buffer: KPS padded K rows, KPS V rows
__host__ __device__ constexpr int stage_chunks(int d4) {
  return KPS * (k_row_chunks(d4) + d4);
}

size_t smem_bytes(int D) {
  return (size_t)WARPS * NSTAGE * stage_chunks(D / 4) * 16;
}

// finite: neither +-inf nor NaN (the JAX body's isfinite)
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest N has landed (this lane's copies)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the rows of keys t0 .. t0 + kn - 1 (kn <= KPS, possibly <= 0) into
// dst, row c at chunk c * row_chunks; then commit the group, empty or not.
// rc[r] holds chunk lane + 32 r of a full stage as (key << 8) | chunk.
template <int R>
__device__ __forceinline__ void issue_rows(float4* dst, int row_chunks,
                                           const float* src, long long st,
                                           int t0, int kn, const int* rc,
                                           bool any) {
  if (any) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = rc[r] >> 8;
      const int j = rc[r] & 0xff;
      if (rc[r] >= 0 && c < kn)
        cp_async16(dst + c * row_chunks + j, src + (t0 + c) * st + 4 * j);
    }
  }
  cp_async_commit();
}

// the keep bit of this lane's key in the stage at t0 with kn keys
__device__ __forceinline__ unsigned stage_bits(const int8_t* mp, int t0,
                                               int kn, int key) {
  const bool keep = key < kn && mp[t0 + key] != 0;
  return __ballot_sync(FULL, keep);
}

template <int DMAX, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
decode_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const int8_t* __restrict__ mask, float* __restrict__ out,
                  int H, int Tk, int D, long long qss, long long qsh,
                  long long kss, long long ksh, long long kst, long long vss,
                  long long vsh, long long vst, float scale) {
  constexpr int QI = DMAX / (4 * LPK);  // q chunks a lane holds, at most
  constexpr int R = KPS * DMAX / 128;    // chunks a lane copies a stage
  constexpr int U = DMAX / 64;   // output column pairs a lane owns
  extern __shared__ float4 stages[];
  __shared__ float m_w[WARPS];
  __shared__ float l_w[WARPS];
  __shared__ __align__(16) float acc_w[WARPS][DMAX];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int key = lane / LPK;   // this lane's key in a stage (scores)
  const int part = lane % LPK;  // and its part of the row
  const int d4 = D >> 2;
  const int kr = k_row_chunks(d4);

  const float* qp = q + s * qss + h * qsh;
  const float* kp = k + s * kss + h * ksh;
  const float* vp = v + s * vss + h * vsh;
  const int8_t* mp = mask + (size_t)s * Tk;

  // q chunks part + LPK i in registers
  float4 qr[QI];
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    const int j = part + LPK * i;
    qr[i] = j < d4 ? make_float4(__ldg(qp + 4 * j), __ldg(qp + 4 * j + 1),
                                 __ldg(qp + 4 * j + 2), __ldg(qp + 4 * j + 3))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // the slot's valid range [lo, hi): each warp scans the whole mask row
  int first = Tk;
  int last = -1;
  if (Tk % 4 == 0 && reinterpret_cast<uintptr_t>(mp) % 4 == 0) {
    const unsigned* mw = reinterpret_cast<const unsigned*>(mp);
#pragma unroll 8
    for (int i = lane; i < Tk / 4; i += 32) {
      const unsigned nz = __vcmpne4(__ldg(mw + i), 0u);
      if (nz) {
        first = min(first, 4 * i + (__ffs(nz) - 1) / 8);
        last = max(last, 4 * i + (31 - __clz(nz)) / 8);
      }
    }
  } else {
#pragma unroll 8
    for (int t = lane; t < Tk; t += 32) {
      if (__ldg(mp + t) != 0) {
        first = min(first, t);
        last = max(last, t);
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    first = min(first, __shfl_xor_sync(FULL, first, o));
    last = max(last, __shfl_xor_sync(FULL, last, o));
  }

  float m = -INFINITY;
  float l = 0.f;
  float2 acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = make_float2(0.f, 0.f);

  const int n = last + 1 - first;  // <= 0: no valid key
  const int cw = n > 0 ? (n + WARPS - 1) / WARPS : 0;
  const int beg = first + warp * cw;
  const int end = min(beg + cw, first + max(n, 0));
  const int nst = end > beg ? (end - beg + KPS - 1) / KPS : 0;
  if (nst > 0) {
    // this lane's chunks of a full stage, as (key << 8) | chunk, -1 past it
    int rc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = lane + 32 * r;
      rc[r] = t < KPS * d4 ? ((t / d4) << 8) | (t % d4) : -1;
    }
    // this warp's NSTAGE buffers, each KPS K rows then KPS V rows
    float4* const bufs = stages + warp * NSTAGE * stage_chunks(d4);
    unsigned bits[NSTAGE];
#pragma unroll
    for (int b = 0; b < NSTAGE; ++b) {
      const int t0 = beg + b * KPS;
      const int kn = min(KPS, end - t0);
      float4* const kb = bufs + b * stage_chunks(d4);
      bits[b] = stage_bits(mp, t0, kn, key);
      issue_rows<R>(kb, kr, kp, kst, t0, kn, rc, bits[b] != 0u);
      issue_rows<R>(kb + KPS * kr, d4, vp, vst, t0, kn, rc, bits[b] != 0u);
    }
    for (int st = 0; st < nst; ++st) {
      const int t0 = beg + st * KPS;
      const int kn = min(KPS, end - t0);
      const unsigned cur = bits[0];
      float4* const kb = bufs + (st % NSTAGE) * stage_chunks(d4);
      const float2* vb = reinterpret_cast<const float2*>(kb + KPS * kr);
      // stage st + NSTAGE, into this buffer once it is read
      const int t2 = t0 + NSTAGE * KPS;
      const int kn2 = min(KPS, end - t2);
      const unsigned next = stage_bits(mp, t2, kn2, key);

      cp_async_wait<2 * NSTAGE - 1>();  // K of this stage
      __syncwarp();
      float p = 0.f;
      float corr = 1.f;
      float m_new = m;
      if (cur) {
        const float4* row = kb + key * kr;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < QI; ++i) {
          const int j = part + LPK * i;
          if (j < d4) {
            const float4 a = row[j];
            dot = fmaf(qr[i].x, a.x, dot);
            dot = fmaf(qr[i].y, a.y, dot);
            dot = fmaf(qr[i].z, a.z, dot);
            dot = fmaf(qr[i].w, a.w, dot);
          }
        }
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1)
          dot += __shfl_xor_sync(FULL, dot, o);
        const bool keep = (cur >> lane) & 1u;
        const float sc = keep ? dot * scale : -INFINITY;
        float mx = sc;
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        m_new = fmaxf(m, mx);
        // guard -inf - -inf: no key seen before this stage
        corr = finite(m) ? expf(m - m_new) : 0.f;
        p = keep ? expf(sc - m_new) : 0.f;
        float psum = p;
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          psum += __shfl_xor_sync(FULL, psum, o);
        l = fmaf(l, corr, psum);
      }
      __syncwarp();  // every lane has read this stage's K rows
      issue_rows<R>(kb, kr, kp, kst, t2, kn2, rc, next != 0u);

      cp_async_wait<2 * NSTAGE - 1>();  // V of this stage
      __syncwarp();
      if (cur) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          acc[u].x *= corr;
          acc[u].y *= corr;
        }
        // acc += sum over the stage's keys of p_c * v_c (masked: p = 0)
#pragma unroll
        for (int c = 0; c < KPS; ++c) {
          if (c < kn) {
            const float pc = __shfl_sync(FULL, p, c * LPK);
            const float2* vr = vb + c * (d4 * 2);
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int e = lane + 32 * u;
              if (2 * e < D) {
                const float2 x = vr[e];
                acc[u].x = fmaf(pc, x.x, acc[u].x);
                acc[u].y = fmaf(pc, x.y, acc[u].y);
              }
            }
          }
        }
        m = m_new;
      }
      __syncwarp();  // every lane has read this stage's V rows
      issue_rows<R>(kb + KPS * kr, d4, vp, vst, t2, kn2, rc, next != 0u);
#pragma unroll
      for (int b = 0; b + 1 < NSTAGE; ++b) bits[b] = bits[b + 1];
      bits[NSTAGE - 1] = next;
    }
    cp_async_wait<0>();
  }

  if (lane == 0) {
    m_w[warp] = m;
    l_w[warp] = l;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = lane + 32 * u;
    if (2 * e < D) reinterpret_cast<float2*>(acc_w[warp])[e] = acc[u];
  }
  __syncthreads();

  // merge the warps in a fixed order; a warp that saw no valid key has
  // m = -inf and weighs 0, so a fully masked slot gives 0 / 1e-30 = 0
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_w[w]);
  float c_w[WARPS];
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    c_w[w] = finite(m_w[w]) ? expf(m_w[w] - mx) : 0.f;
  float* op = out + ((size_t)s * H + h) * D;
  for (int d = tid; d < D; d += THREADS) {
    float a = 0.f;
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a = fmaf(acc_w[w][d], c_w[w], a);
      den = fmaf(l_w[w], c_w[w], den);
    }
    op[d] = a / fmaxf(den, DENOM_FLOOR);
  }
}

template <int DMAX, int MIN_BLOCKS>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int8_t* mask, float* out, int S, int H, int Tk,
                   int D, long long q_ss, long long q_sh, long long k_ss,
                   long long k_sh, long long k_st, long long v_ss,
                   long long v_sh, long long v_st, float scale,
                   cudaStream_t stream) {
  auto kernel = decode_fwd_kernel<DMAX, MIN_BLOCKS>;
  const size_t bytes = smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(H, S), THREADS, bytes, stream>>>(
      q, k, v, mask, out, H, Tk, D, q_ss, q_sh, k_ss, k_sh, k_st, v_ss, v_sh,
      v_st, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/out float32, mask int8. Strides are in elements: q's slot and head
// axes, k's and v's slot, head and token axes; k and v start on 16 bytes
// with strides that are multiples of 4. Returns a cudaError_t.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* out, int S, int H, int Tk,
                         int D, long long q_ss, long long q_sh, long long k_ss,
                         long long k_sh, long long k_st, long long v_ss,
                         long long v_sh, long long v_st, float scale,
                         void* stream) {
  if (D < 8 || D > MAX_D || D % 8 != 0 || S < 1 || H < 1 || Tk < 1 ||
      S > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 ||
      (k_ss | k_sh | k_st | v_ss | v_sh | v_st) % 4)
    return (int)cudaErrorMisalignedAddress;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int8_t* mk = static_cast<const int8_t*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // D <= 64 keeps 3 blocks an SM (384 blocks in one wave at 32 x 12)
  return (int)(D <= 64
                   ? launch<64, 3>(f(q), f(k), f(v), mk, o, S, H, Tk, D, q_ss,
                                   q_sh, k_ss, k_sh, k_st, v_ss, v_sh, v_st,
                                   scale, st)
                   : launch<128, 1>(f(q), f(k), f(v), mk, o, S, H, Tk, D,
                                    q_ss, q_sh, k_ss, k_sh, k_st, v_ss, v_sh,
                                    v_st, scale, st));
}

}  // extern "C"
