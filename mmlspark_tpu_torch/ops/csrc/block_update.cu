// The ring-hop block update for Hopper (sm_90a): one online-softmax update
// of a carried (m, denom, acc) over a whole K/V block, f32 throughout.
//
// Replaces mmlspark_tpu/ops/pallas/attention.py:_update_call (the Pallas
// kernel behind attention_block_update, body _update_kernel ->
// _online_update). Same function: q [N,H,Tq,D], k/v [N,H,Tk,D] f32, one
// [N,Tq,Tk] int8 keep-mask shared by every head, and the carry m/denom
// [N,H,Tq,1] and acc [N,H,Tq,D] f32; scores = (q . k) * scale with masked
// scores at -inf, m' = max(m, rowmax), corr = exp(m - m') guarded to 0 while
// m is still -inf, p = exp(s - m') (0 where masked), denom' = denom * corr +
// sum p, acc' = acc * corr + p . v. No final division: the ring divides
// once, after its last hop. In the ring every hop of every layer is one
// call, over all (rank, batch) pairs at once (N = sp * B).
//
// Design: one block per (n, h, 64-row query tile). It loads the tile's
// carried m, denom and acc, walks the keys in stripes of 64 staged in
// shared memory (the score stripe never reaches device memory), merges
// each stripe into the carry with f32 FMAs on CUDA cores, always in the
// same stripe order, and writes fresh m, denom and acc (not in place:
// autograd keeps the inputs for the backward). The arithmetic layout is
// that of flash_attention.cu: a 4x4 score tile and a 4 x (D/16) output
// tile per thread.
//
// Skipping: a stripe in which no row of the tile keeps any key is skipped.
// This is exact. For a row with a finite m the stripe's row max is -inf, so
// m' = m, corr = exp(0) = 1 and every p = 0: denom * 1 + 0 and acc * 1 + 0
// are denom and acc, bit for bit. For a row whose m is -inf the plain
// update multiplies denom and acc by corr = 0; so after the last stripe a
// row whose m is still -inf gets that factor 0 applied once (idempotent when
// a stripe already applied it), and the initial carry (-inf, 0, 0) leaves as
// (-inf, 0, 0). On the ring this skips every hop whose key block lies wholly
// after the query block under the causal mask, and every pad-only block.
//
// What bounds it on an H100 (N=32, H=12, Tq=Tk=256, D=64): it must read
// q/k/v (75.5 MB), the carry (25.9 MB) and the mask (2.1 MB) and write the
// carry (25.9 MB), about 129 MB or 39 us at 3.35 TB/s, while it does
// 4*N*H*Tq*Tk*D = 6.44 GFLOP, 96 us at the f32 rate of 67 TFLOP/s: so the
// floor is the f32 operations (the inputs are f32, as in the reference's
// kernel). This first design runs both products on the CUDA cores from
// shared memory, so FMA issue and shared-memory bandwidth bound it; the
// skip cuts the operations to the kept tiles. Tensor cores (TF32 or bf16
// wgmma fed by TMA) are later work.
//
// Layout: every operand is contiguous (the wrapper makes it so: the ring
// folds [B,L,H,D] into the rank-major [sp*B,H,l,D] with one copy, which is
// contiguous). The kernel allocates nothing; the caller passes the outputs
// and the stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per stripe
constexpr int THREADS = 256;  // 16 row groups of 4 rows x 16 lanes
constexpr int MAX_D = 128;
constexpr int DPT = MAX_D / 16;  // output columns per thread, at most

// finite: neither +-inf nor NaN (the JAX body's isfinite)
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

// dynamic shared memory: floats qs [BQ][D+1], ks [BK][D+1], vs [BK][D],
// ss [BQ][BK+1], m [BQ], l [BQ], corr [BQ], then the int8 keep stripe
// [BQ][BK] (the +1 pads keep the strided row reads free of bank conflicts)
__host__ __device__ inline size_t smem_floats(int d) {
  return (size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * d +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}
__host__ __device__ inline size_t smem_bytes(int d) {
  return smem_floats(d) * sizeof(float) + (size_t)BQ * BK;
}

__global__ void __launch_bounds__(THREADS)
block_update_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int8_t* __restrict__ mask,
                    const float* __restrict__ m_in,
                    const float* __restrict__ d_in,
                    const float* __restrict__ a_in, float* __restrict__ m_out,
                    float* __restrict__ d_out, float* __restrict__ a_out,
                    int H, int Tq, int Tk, int D, float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* qs = smem;
  float* ks = qs + BQ * dp;
  float* vs = ks + BK * dp;
  float* ss = vs + BK * D;
  float* m_s = ss + BQ * (BK + 1);
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;
  int8_t* keep_s = reinterpret_cast<int8_t*>(c_s + BQ);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const size_t nh = (size_t)n * H + h;

  const float* qp = q + nh * Tq * D;
  const float* kp = k + nh * Tk * D;
  const float* vp = v + nh * Tk * D;
  const int8_t* mp = mask + (size_t)n * Tq * Tk;

  // q tile; rows past Tq are zeros (never written out)
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int t = q0 + r;
    qs[r * dp + d] = t < Tq ? qp[(size_t)t * D + d] : 0.f;
  }
  // the carried running max and denominator
  if (tid < BQ) {
    const int t = q0 + tid;
    m_s[tid] = t < Tq ? m_in[nh * Tq + t] : -INFINITY;
    l_s[tid] = t < Tq ? d_in[nh * Tq + t] : 0.f;
  }

  // thread -> 4 rows (rg*4 .. rg*4+3) and columns lane + 16*i
  const int rg = tid >> 4;
  const int lane = tid & 15;
  float acc[4][DPT];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = q0 + rg * 4 + j;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane + 16 * i;
      acc[j][i] = (t < Tq && d < D) ? a_in[(nh * Tq + t) * D + d] : 0.f;
    }
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the previous stripe's readers are done
    bool any = false;
    for (int i = tid; i < BQ * BK; i += THREADS) {
      const int r = i / BK, c = i - r * BK;
      const int tq = q0 + r, tk = k0 + c;
      const int8_t kk =
          (tq < Tq && tk < Tk) ? mp[(size_t)tq * Tk + tk] : (int8_t)0;
      keep_s[i] = kk;
      any |= kk != 0;
    }
    // exact: see the note at the head of this file
    if (!__syncthreads_or(any)) continue;

    // K/V stripe; keys past Tk are zeros so that 0 * v stays 0
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i - c * D;
      const int t = k0 + c;
      const bool in = t < Tk;
      ks[c * dp + d] = in ? kp[(size_t)t * D + d] : 0.f;
      vs[c * D + d] = in ? vp[(size_t)t * D + d] : 0.f;
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
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = lane + 16 * i;
          ss[r * (BK + 1) + c] =
              keep_s[r * BK + c] != 0 ? s[j][i] * scale : -INFINITY;
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
      // every lane of the row group has read m_s[r] before it changes
      __syncwarp();
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

  // the fresh carry; a row whose max is still -inf takes the plain
  // update's corr = 0 (see the note at the head of this file)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = rg * 4 + j;
    const int t = q0 + r;
    if (t >= Tq) continue;
    const float m = m_s[r];
    const float zero_if_unseen = finite(m) ? 1.f : 0.f;
    if (lane == 0) {
      m_out[nh * Tq + t] = m;
      d_out[nh * Tq + t] = l_s[r] * zero_if_unseen;
    }
    float* op = a_out + (nh * Tq + t) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane + 16 * i;
      if (d < D) op[d] = acc[j][i] * zero_if_unseen;
    }
  }
}

}  // namespace

extern "C" {

// Every operand float32 and contiguous, the mask int8. m/denom are
// [N,H,Tq,1], acc [N,H,Tq,D]; the outputs have the carry's shapes.
// Returns a cudaError_t.
int block_update_fwd(const void* q, const void* k, const void* v,
                     const void* mask, const void* m_in, const void* d_in,
                     const void* a_in, void* m_out, void* d_out, void* a_out,
                     int N, int H, int Tq, int Tk, int D, float scale,
                     void* stream) {
  if (D < 8 || D > MAX_D || D % 8 != 0 || N < 1 || N > 65535 || H < 1 ||
      H > 65535 || Tq < 1 || Tk < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Tq + BQ - 1) / BQ, H, N);
  block_update_kernel<<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int8_t*>(mask),
      static_cast<const float*>(m_in), static_cast<const float*>(d_in),
      static_cast<const float*>(a_in), static_cast<float*>(m_out),
      static_cast<float*>(d_out), static_cast<float*>(a_out), H, Tq, Tk, D,
      scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
