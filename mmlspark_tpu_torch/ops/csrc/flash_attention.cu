// Flash attention forward for Hopper (sm_90a): online softmax over key
// stripes, f32 accumulation, f32 output.
//
// Replaces mmlspark_tpu/ops/pallas/attention.py:_flash_call (the Pallas
// kernel behind flash_attention, body _flash_tile -> _online_update).
// Same function: q/k/v [B,H,T,D] (bf16 or f32), one [B,Tq,Tk] int8
// keep-mask shared by every head, scores = (q . k) * scale with the f32
// scale applied to the f32 dot product, masked scores at -inf, a running
// max guarded while it is still -inf, and a final division by
// max(denom, 1e-30) so that fully masked rows are exact zeros. The
// Pallas blocks are not carried over: one CUDA block takes 64 query rows
// of one (batch, head) and walks the keys in stripes of 64, so the
// [Tq,Tk] score matrix never reaches device memory.
//
// What bounds it on an H100 (ViT-B/16 at B=32: H=12, T=196, D=64, bf16):
// it must read q/k/v in bf16 (28.9 MB), write the f32 output (19.3 MB)
// and read the mask (1.2 MB): 49.4 MB, 14.75 us at 3.35 TB/s. It does
// 4*B*H*T*T*D = 3.8 GFLOP, 3.8 us at the bf16 tensor-core rate. So the
// floor is memory, and the design has to keep the products, the softmax
// and the copies from becoming the limit in its place.
//
// The bf16 instance (the one the ViT serving path runs):
// * Both products on the tensor cores, as mma.sync.m16n8k16 bf16 with
//   f32 accumulation, fed by ldmatrix (.trans for V in P.V). Four warps,
//   each owning 16 query rows whose Q fragments stay in registers for the
//   whole key loop; the scores, the probabilities and the output
//   accumulator never leave registers (the accumulator fragments of q.k
//   are re-packed in place as the A operand of P.V). mma.sync and not
//   wgmma: the products are 3.8 us against a 14.75 us bytes floor, so
//   wgmma's asynchrony buys little here, and its 64-row granularity would
//   waste more of T=196 (= 12*16 + 4) than mma's 16 rows: a warp whose 16
//   rows lie wholly past Tq issues no mma.
// * Precision. q.k on bf16 tensor cores is exact per product (a product
//   of two bf16 values fits in f32); only the order of the f32 sums
//   differs from the plain version. P.V is not: rounding the f32
//   probabilities to bf16 once (2^-9 relative) puts outputs about 1e-3
//   from the f32 reference. So each probability is split in registers,
//   p_hi = bf16(p), p_lo = bf16(p - p_hi) (p - p_hi is exact in f32), and
//   each P.V tile issues two mma, p_hi.V + p_lo.V, into the same f32
//   accumulator: P is carried to about 2^-17, the output stays within
//   1e-4 of the plain version, and the extra P.V work still fits under
//   the bytes bound. The denominator sums the f32 p themselves. The
//   exponentials are ex2.approx (about 2^-22 relative) of x log2 e - m
//   log2 e, and the final division is a multiply by the correctly rounded
//   reciprocal: each a few f32 steps, far inside 1e-4.
// * Copies. Q once and K/V in 64-key stripes reach shared memory through
//   16-byte cp.async.cg copies, double-buffered so that the next stripe
//   loads while this one is multiplied. Rows are padded by 16 bytes, so
//   the eight 16-byte rows of every ldmatrix phase land in eight
//   distinct bank groups. Keys past Tk, query rows past Tq and columns
//   past D are zero-filled by the copy (src-size 0), and keys past Tk
//   are masked, so 0 * garbage never makes a NaN.
// * The mask is read straight from global memory in the layout of the
//   mma accumulator (each thread two adjacent keys of two rows, as one
//   16-bit load when Tk is even), kept as packed bytes and tested where
//   each score is scaled; each head re-reads it through L2.
// * Once the products are on the tensor cores, the limit is instruction
//   issue along each warp's stripe: 96 mma and several hundred dependent
//   instructions (the mask, the softmax, the P split) in a chain that
//   the SM's few resident warps cannot hide. Copies, L2 and device memory
//   are not the limit (an L2-cold launch takes about as long as a warm
//   one). So the stripe body is one branch-free block the compiler can
//   schedule whole, and a stripe is cut to its 16-key chunks that hold a
//   key below Tk (a template on the chunk count, chosen per stripe): at
//   T=196 the last stripe has 4 keys and costs a quarter of a full one.
//   At about 155 registers a thread (D=64), three blocks share an SM.
//   Measured on an H100, more warps did not help: capping the registers
//   for a fourth block spills, and splitting each stripe's keys between
//   two warps (shorter chains, 16 warps an SM) ran slower; wgmma with
//   producer and consumer warps is the step after this one.
//
// The f32 instance is not on the serving path and keeps the first
// design: both products in f32 FMAs on the CUDA cores from shared
// memory. Instances are chosen by dtype alone, never by size.
//
// Layout: the kernel takes strides for the batch, head and token axes of
// q, k and v (the innermost D axis must be contiguous), so the
// [B,T,H,D] -> [B,H,T,D] transpose of the projections needs no copy. The
// bf16 instance copies in 16-byte pieces: every base pointer must be
// 16-byte aligned and every stride a multiple of 8 elements (the wrapper
// raises otherwise, and so does the entry point below). The mask and the
// output are contiguous. The kernel allocates nothing; the caller passes
// the output and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 128;
constexpr float DENOM_FLOOR = 1e-30f;

// finite: neither +-inf nor NaN (the JAX body's isfinite)
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

// ---- the bf16 instance: tensor cores ----

namespace tc {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per stripe
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BK == 64, "a stripe is four 16-key chunks");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// two f32 probabilities (adjacent keys) -> their bf16 high and low parts
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(p0 - __low2float(h),
                                  p1 - __high2float(h)));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// DP: the head width rounded up to 32, 64 or 128 (columns past D are
// zero-filled and never written out)
template <int DP>
struct Geometry {
  static constexpr int RS = DP + 8;   // shared row stride, elements
  static constexpr int CH = DP / 8;   // 16-byte pieces per row
  static constexpr int PASS = THREADS / CH;  // rows one pass of copies covers
  static constexpr size_t SMEM =
      (size_t)(BQ + 4 * BK) * RS * sizeof(__nv_bfloat16);
};

// One stripe of keys for one warp's 16 query rows: the online-softmax
// update of (m, l, o) with the keys k0 .. k0 + 16*KC - 1 of the stripe in
// shared memory (kb, vb). KC is the number of 16-key chunks that hold a
// key below Tk: a stripe's work is cut to them, and the rest of the
// stripe (zeros, all masked) is never multiplied.
template <int DP, int KC>
__device__ __forceinline__ void stripe(
    const uint32_t (&qf)[DP / 16][4], float (&o)[DP / 8][4], float (&m)[2],
    float (&l)[2], const __nv_bfloat16* kb, const __nv_bfloat16* vb, int k0,
    int Tk, const int8_t* mrow0, const int8_t* mrow1, bool in0, bool in1,
    float scale) {
  constexpr int RS = DP + 8;
  constexpr int NT = 2 * KC;  // score tiles of 8 keys
  const int lane = threadIdx.x & 31, tig = lane & 3;

  // the keep bytes, in the accumulator layout: byte 2r + c of w[j] is
  // key col + c of row g + 8r (col = k0 + 8j + 2 tig); keys past Tk read
  // as 0. The loads go out first, so their latency hides behind the
  // products
  uint32_t w[NT];
  if ((Tk & 1) == 0) {  // two keys as one aligned 16-bit load
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = k0 + j * 8 + tig * 2;
      const uint32_t w0 =
          in0 && col < Tk
              ? __ldg(reinterpret_cast<const unsigned short*>(mrow0 + col))
              : 0u;
      const uint32_t w1 =
          in1 && col < Tk
              ? __ldg(reinterpret_cast<const unsigned short*>(mrow1 + col))
              : 0u;
      w[j] = w0 | w1 << 16;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      w[j] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + tig * 2 + (e & 1);
        const bool ok = ((e >> 1) ? in1 : in0) && col < Tk;
        const uint32_t x =
            ok ? (uint8_t)__ldg(((e >> 1) ? mrow1 : mrow0) + col) : 0u;
        w[j] |= x << (8 * e);
      }
    }
  }

  // scores: 16 rows x 16*KC keys, as NT accumulator tiles of 8 keys
  float sc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, kb + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * RS +
                          kc * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(sc[j], qf[kc], bf[0], bf[1]);
      mma_bf16(sc[j + 1], qf[kc], bf[2], bf[3]);
    }

  // scale, mask, and this stripe's row max
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x =
          (w[j] >> (8 * e)) & 0xffu ? sc[j][e] * scale : -INFINITY;
      sc[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2], ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // guard -inf - -inf: a row with every key masked so far
    corr[r] = finite(m[r]) ? ex2((m[r] - m_new) * LOG2E) : 0.f;
    m[r] = m_new;
    ml[r] = m_new * LOG2E;
  }
  // probabilities, in place of the scores: exp(x - m) as
  // 2^(x log2 e - m log2 e), masked scores exact zeros
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sc[j][e];
      const float p = finite(x) ? ex2(fmaf(x, LOG2E, -ml[e >> 1])) : 0.f;
      sc[j][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    o[n][0] *= corr[0];
    o[n][1] *= corr[0];
    o[n][2] *= corr[1];
    o[n][3] *= corr[1];
  }

  // o += p_hi . v + p_lo . v, 16 keys at a time; the score tiles
  // 2kk and 2kk+1 are the A fragment of keys 16kk .. 16kk+15
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    uint32_t ahi[4], alo[4];
    split(sc[2 * kk][0], sc[2 * kk][1], ahi[0], alo[0]);
    split(sc[2 * kk][2], sc[2 * kk][3], ahi[1], alo[1]);
    split(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ahi[2], alo[2]);
    split(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ahi[3], alo[3]);
#pragma unroll
    for (int n = 0; n < DP / 8; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(
          bf, vb + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RS +
                  n * 8 + (lane >> 4) * 8);
      mma_bf16(o[n], ahi, bf[0], bf[1]);
      mma_bf16(o[n + 1], ahi, bf[2], bf[3]);
      mma_bf16(o[n], alo, bf[0], bf[1]);
      mma_bf16(o[n + 1], alo, bf[2], bf[3]);
    }
  }
}

// The minimum of one block an SM is stated on purpose: with it ptxas keeps
// about 155 registers a thread at D=64 (three blocks an SM either way);
// without it, it packs the same code into 135 and the kernel ran 4% slower
// on an H100.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int8_t* __restrict__ mask, float* __restrict__ out,
               int H, int Tq, int Tk, int D, long long qsb, long long qsh,
               long long qst, long long ksb, long long ksh, long long kst,
               long long vsb, long long vsh, long long vst, float scale) {
  using G = Geometry<DP>;
  constexpr int RS = G::RS, CH = G::CH, PASS = G::PASS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][RS]
  __nv_bfloat16* ks = qs + BQ * RS;                     // [2][BK][RS]
  __nv_bfloat16* vs = ks + 2 * BK * RS;                 // [2][BK][RS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* qp = q + b * qsb + h * qsh;
  const __nv_bfloat16* kp = k + b * ksb + h * ksh;
  const __nv_bfloat16* vp = v + b * vsb + h * vsh;
  const int8_t* mp = mask + (size_t)b * Tq * Tk;

  // copies: this thread moves 16-byte piece cc of rows cr + i * PASS;
  // rows past Tq or Tk and columns past D are zero-filled
  const int cr = tid / CH, cc = tid % CH;
  const bool col_in = cc * 8 < D;
#pragma unroll
  for (int i = 0; i < BQ / PASS; ++i) {
    const int t = q0 + cr + i * PASS;
    const bool in = col_in && t < Tq;
    cp_async16(qs + (cr + i * PASS) * RS + cc * 8,
               in ? qp + t * qst + cc * 8 : qp, in ? 16 : 0);
  }
  cp_async_commit();
  auto load_stripe = [&](int k0, int buf) {
#pragma unroll
    for (int i = 0; i < BK / PASS; ++i) {
      const int r = cr + i * PASS;
      const int t = k0 + r;
      const bool in = col_in && t < Tk;
      cp_async16(ks + (buf * BK + r) * RS + cc * 8,
                 in ? kp + t * kst + cc * 8 : kp, in ? 16 : 0);
      cp_async16(vs + (buf * BK + r) * RS + cc * 8,
                 in ? vp + t * vst + cc * 8 : vp, in ? 16 : 0);
    }
  };
  load_stripe(0, 0);
  cp_async_commit();

  // this thread's rows in the mma layout: g and g + 8 of the warp's 16
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  const bool in0 = row0 < Tq, in1 = row0 + 8 < Tq;
  const bool active = q0 + warp * 16 < Tq;
  const int8_t* mrow0 = mp + (size_t)row0 * Tk;
  const int8_t* mrow1 = mrow0 + (size_t)8 * Tk;

  // the q fragments, in registers for the whole key loop
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[DP / 16][4];
  if (active) {
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc)
      ldmatrix_x4(qf[kc], qs + (warp * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * RS +
                              kc * 16 + (lane >> 4) * 8);
  }

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's denominator

  const int stripes = (Tk + BK - 1) / BK;
  for (int s = 0; s < stripes; ++s) {
    const int buf = s & 1;
    // the next stripe's copy overlaps this stripe's products; an empty
    // group at the end keeps wait_group 1 meaning "stripe s has landed"
    if (s + 1 < stripes) load_stripe((s + 1) * BK, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (active) {
      const __nv_bfloat16* kb = ks + buf * BK * RS;
      const __nv_bfloat16* vb = vs + buf * BK * RS;
      const int k0 = s * BK;
      // warp-uniform: the 16-key chunks of this stripe below Tk
      switch ((min(BK, Tk - k0) + 15) / 16) {
        case 1:
          stripe<DP, 1>(qf, o, m, l, kb, vb, k0, Tk, mrow0, mrow1, in0, in1,
                        scale);
          break;
        case 2:
          stripe<DP, 2>(qf, o, m, l, kb, vb, k0, Tk, mrow0, mrow1, in0, in1,
                        scale);
          break;
        case 3:
          stripe<DP, 3>(qf, o, m, l, kb, vb, k0, Tk, mrow0, mrow1, in0, in1,
                        scale);
          break;
        default:
          stripe<DP, 4>(qf, o, m, l, kb, vb, k0, Tk, mrow0, mrow1, in0, in1,
                        scale);
      }
    }
    __syncthreads();  // this buffer's readers are done before it refills
  }

  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = l[r];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    // 1 / max(denom, 1e-30), correctly rounded; a fully masked row has
    // acc = 0 and stays exact zeros
    inv[r] = __frcp_rn(fmaxf(t, DENOM_FLOOR));
  }
  float* op = out + (((size_t)b * H + h) * Tq + row0) * D + tig * 2;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    if (n * 8 >= D) break;
    if (in0)
      *reinterpret_cast<float2*>(op + n * 8) =
          make_float2(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (in1)
      *reinterpret_cast<float2*>(op + (size_t)8 * D + n * 8) =
          make_float2(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int B, int H, int Tq, int Tk,
                   int D, const long long* qs, const long long* ks,
                   const long long* vs, float scale, cudaStream_t stream) {
  constexpr size_t smem = Geometry<DP>::SMEM;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_bf16<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int8_t*>(mask),
      static_cast<float*>(out), H, Tq, Tk, D, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return cudaGetLastError();
}

}  // namespace tc

// ---- the f32 instance: the first design, on the CUDA cores ----

namespace simt {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per stripe
constexpr int THREADS = 256;  // 16 row groups of 4 rows x 16 lanes
constexpr int DPT = MAX_D / 16;  // output columns per thread, at most

// dynamic shared memory, in floats:
//   qs [BQ][D+1], ks [BK][D+1], vs [BK][D], ss [BQ][BK+1],
//   m [BQ], l [BQ], corr [BQ]
// (the +1 pads keep the strided row reads free of bank conflicts)
__host__ __device__ inline size_t smem_floats(int d) {
  return (size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * d +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int8_t* __restrict__ mask,
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

  const float* qp = q + b * qsb + h * qsh;
  const float* kp = k + b * ksb + h * ksh;
  const float* vp = v + b * vsb + h * vsh;
  const int8_t* mp = mask + (size_t)b * Tq * Tk;

  // q tile; rows past Tq are zeros (never written out)
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int t = q0 + r;
    qs[r * dp + d] = t < Tq ? qp[t * qst + d] : 0.f;
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
    // K/V stripe; keys past Tk are zeros so that 0 * v stays 0
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i - c * D;
      const int t = k0 + c;
      const bool in = t < Tk;
      ks[c * dp + d] = in ? kp[t * kst + d] : 0.f;
      vs[c * D + d] = in ? vp[t * vst + d] : 0.f;
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

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int B, int H, int Tq, int Tk,
                   int D, const long long* qs, const long long* ks,
                   const long long* vs, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_f32<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int8_t*>(mask),
      static_cast<float*>(out), H, Tq, Tk, D, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return cudaGetLastError();
}

}  // namespace simt

// the bf16 instance copies 16 bytes at a time: 16-byte aligned bases and
// strides in whole 8-element pieces
bool aligned16(const void* p, const long long* s) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s[0] % 8 == 0 &&
         s[1] % 8 == 0 && s[2] % 8 == 0;
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
    return (int)simt::launch(q, k, v, mask, out, B, H, Tq, Tk, D, qs, ks,
                             vs, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(q, qs) || !aligned16(k, ks) || !aligned16(v, vs))
    return (int)cudaErrorMisalignedAddress;
  if (D <= 32)
    return (int)tc::launch<32>(q, k, v, mask, out, B, H, Tq, Tk, D, qs, ks,
                               vs, scale, st);
  if (D <= 64)
    return (int)tc::launch<64>(q, k, v, mask, out, B, H, Tq, Tk, D, qs, ks,
                               vs, scale, st);
  return (int)tc::launch<128>(q, k, v, mask, out, B, H, Tq, Tk, D, qs, ks,
                              vs, scale, st);
}

}  // extern "C"
