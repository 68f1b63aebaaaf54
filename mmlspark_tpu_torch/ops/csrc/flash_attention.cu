// Flash attention forward for Hopper (sm_90a): online softmax over key
// stripes, f32 accumulation, f32 output.
//
// Replaces mmlspark_tpu/ops/pallas/attention.py:_flash_call (the Pallas
// kernel behind flash_attention, body _flash_tile -> _online_update).
// Same function: q/k/v [B,H,T,D] (bf16 or f32), one [B,Tq,Tk] int8
// keep-mask shared by every head, scores = (q . k) * scale with masked
// scores at -inf, a running max guarded while it is still -inf, and a
// final division by max(denom, 1e-30) so that fully masked rows are
// exact zeros. The Pallas blocks are not carried over: one CUDA block
// takes BQ query rows of one (batch, head) and walks the keys in stripes
// of BK, so the [Tq,Tk] score matrix never reaches device memory.
//
// What bounds it on an H100 (ViT-B/16 at B=32: H=12, T=196, D=64, bf16):
// it must read q/k/v (28.9 MB), write the f32 output (19.3 MB) and read
// the mask (1.2 MB), about 49 MB or 15 us at 3.35 TB/s, while it does
// 4*B*H*T*T*D = 3.8 GFLOP, 3.8 us at the bf16 tensor-core rate. So the
// floor is memory. This first design does not reach it: both products
// run in f32 on the CUDA cores from shared memory (the per-thread 4x4
// and 4x(D/16) register tiles below), which makes it bound by shared
// memory and FMA issue, not by device memory. Staging through shared
// memory does keep device traffic near the floor: each q row is read
// once per block and each K/V stripe once per query tile (196/64 -> 4
// tiles). wgmma on bf16 tiles fed by TMA is the later step.
//
// Layout: the kernel takes strides for the batch, head and token axes of
// q, k and v (the innermost D axis must be contiguous), so the
// [B,T,H,D] -> [B,H,T,D] transpose of the projections needs no copy. The
// mask and the output are contiguous. The kernel allocates nothing; the
// caller passes the output and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per stripe
constexpr int THREADS = 256;  // 16 row groups of 4 rows x 16 lanes
constexpr int MAX_D = 128;
constexpr int DPT = MAX_D / 16;  // output columns per thread, at most
constexpr float DENOM_FLOOR = 1e-30f;

// finite: neither +-inf nor NaN (the JAX body's isfinite)
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// dynamic shared memory, in floats:
//   qs [BQ][D+1], ks [BK][D+1], vs [BK][D], ss [BQ][BK+1],
//   m [BQ], l [BQ], corr [BQ]
// (the +1 pads keep the strided row reads free of bank conflicts)
__host__ __device__ inline size_t smem_floats(int d) {
  return (size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * d +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int8_t* __restrict__ mask,
                 float* __restrict__ out, int H, int Tq, int Tk, int D,
                 long long qsb, long long qsh, long long qst,
                 long long ksb, long long ksh, long long kst,
                 long long vsb, long long vsh, long long vst, float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* qs = smem;
  float* ks = qs + BQ * dp;
  float* vs = ks + BK * dp;
  float* ss = vs + BK * D;
  float* m_s = ss + BQ * (BK + 1);
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
  const int8_t* mp = mask + (size_t)b * Tq * Tk;

  // q tile, upcast to f32; rows past Tq are zeros (never written out)
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int t = q0 + r;
    qs[r * dp + d] = t < Tq ? to_f32(qp[t * qst + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // thread -> 4 rows (rg*4 .. rg*4+3) and columns lane + 16*i
  const int rg = tid >> 4;
  const int lane = tid & 15;
  float acc[4][DPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[j][i] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the previous stripe's readers are done
    // K/V stripe, upcast; keys past Tk are zeros so that 0 * v stays 0
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i - c * D;
      const int t = k0 + c;
      const bool in = t < Tk;
      ks[c * dp + d] = in ? to_f32(kp[t * kst + d]) : 0.f;
      vs[c * D + d] = in ? to_f32(vp[t * vst + d]) : 0.f;
    }
    __syncthreads();

    // scores: a 4x4 tile per thread, rows rg*4+j, keys lane+16*i
    {
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) qv[j] = qs[(rg * 4 + j) * dp + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) kv[i] = ks[(lane + 16 * i) * dp + d];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] = fmaf(qv[j], kv[i], s[j][i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg * 4 + j;
        const int tq = q0 + r;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = lane + 16 * i;
          const int tk = k0 + c;
          const bool keep = tq < Tq && tk < Tk && mp[(size_t)tq * Tk + tk] != 0;
          ss[r * (BK + 1) + c] = keep ? s[j][i] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax update: 4 threads per row, 16 keys each
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float* row = ss + r * (BK + 1) + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      // guard -inf - -inf: a row with every key masked so far
      const float corr = finite(m_old) ? expf(m_old - m_new) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float sc = row[c];
        const float p = finite(sc) ? expf(sc - m_new) : 0.f;
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v_stripe (keys past Tk have p = 0)
    {
      const int kn = min(BK, Tk - k0);
      float corr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) corr[j] = c_s[rg * 4 + j];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[j][i] *= corr[j];
      for (int c = 0; c < kn; ++c) {
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] = ss[(rg * 4 + j) * (BK + 1) + c];
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          const int d = lane + 16 * i;
          if (d < D) {
            const float vv = vs[c * D + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j][i] = fmaf(p[j], vv, acc[j][i]);
          }
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = rg * 4 + j;
    const int tq = q0 + r;
    if (tq >= Tq) continue;
    const float den = fmaxf(l_s[r], DENOM_FLOOR);
    float* op = out + (((size_t)b * H + h) * Tq + tq) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane + 16 * i;
      if (d < D) op[d] = acc[j][i] / den;
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int B, int H, int Tq, int Tk,
                   int D, const long long* qs, const long long* ks,
                   const long long* vs, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int8_t*>(mask),
      static_cast<float*>(out), H, Tq, Tk, D, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// batch, head and token axes of each operand. Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* mask, void* out, int dtype, int B, int H,
                        int Tq, int Tk, int D, long long q_sb, long long q_sh,
                        long long q_st, long long k_sb, long long k_sh,
                        long long k_st, long long v_sb, long long v_sh,
                        long long v_st, float scale, void* stream) {
  if (D < 8 || D > MAX_D || D % 8 != 0 || B < 1 || H < 1 || Tq < 1 ||
      Tk < 1)
    return (int)cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_sh, q_st};
  const long long ks[3] = {k_sb, k_sh, k_st};
  const long long vs[3] = {v_sb, v_sh, v_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, mask, out, B, H, Tq, Tk, D, qs, ks,
                              vs, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, mask, out, B, H, Tq, Tk, D,
                                      qs, ks, vs, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
