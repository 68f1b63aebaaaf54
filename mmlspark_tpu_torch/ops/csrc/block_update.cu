// The ring-hop block update for Hopper (sm_90a): one online-softmax update
// of a carried (m, denom, acc) over a whole K/V block, f32 in and out, its
// two products on the tensor cores.
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
// What bounds it on an H100 (N=32, H=12, Tq=Tk=256, D=64, the ring's first
// training batch, mean over its 4 hops): the function does 4*H*D f32
// operations per kept (query, key) pair, 0.041 ms a hop at the 67 TFLOP/s
// of the CUDA cores; it must read the kept rows of q, k and v, the carry
// and the mask and write the carry, about 0.03-0.039 ms at 3.35 TB/s. On
// the tensor cores each f32 product costs three TF32 products, 0.017 ms a
// hop at 495 TFLOP/s, so on the units this kernel uses the floor is the
// bytes.
//
// Precision: 3xTF32, as in block_update_bwd.cu (whose head note derives
// it). Each f32 operand x is split as hi = tf32(x) and lo = tf32(x - hi),
// rounded to nearest with ties away from zero by integer operations; a
// product a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, small terms
// first, in one f32 accumulator. That leaves about 6 float32 epsilons of
// each product before the accumulation's own rounding, within the check's
// BLOCK_TOL = 1e-5 on m and acc/denom; one TF32 product alone errs by about
// 2^-11 of each term, past it. Small integers are exact in hi with lo = 0,
// so integer scores, and m, stay exact. p = exp(s - m') by ex2.approx on
// the log2(e)-scaled difference.
//
// Fragments (mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32; lane = 4g + t):
// the scores take k-slot t from head column 8ks + 2t and slot t + 4 from
// 8ks + 2t + 1, so that a thread's C fragment of s holds keys 2t and 2t + 1
// of each 8-key n-tile; p . v then takes slot t from key 2t and slot t + 4
// from 2t + 1, so the C fragment of p is the A fragment as it stands, and
// the v rows 2t and 2t + 1 load to match.
//
// Design: one block per (n, h, 64-row query tile), 4 warps, a warp per 16
// query rows; a thread holds rows g and g + 8 of its warp's 16, their
// carried m and denom and their acc as C fragments, in registers from the
// first stripe to the last. The keys go by in stripes of 64, always in the
// same order. The q tile stays resident in shared memory as f32 (row r's
// 8-column groups XORed by a Gray code of r) and is split as each k-step
// loads it; each k and v stripe is split once into (hi, hi, lo, lo) column
// pairs, laid out (pswz) so that the mma's register pairs load directly and
// the fragment loads are free of bank conflicts. One split buffer serves
// both products in turn, and one raw buffer takes the next operand by
// cp.async while the current one is multiplied:
//
//   split k(j) -> | v(j) lands in the raw buffer | split v(j) -> | k(j') lands
//                 | s = q.k^T, the stripe's      |               | acc += p.v
//                 | online softmax in registers  |               |
//
// with j' the next stripe that keeps a key (its keep tile loaded into
// registers while the scores run). The softmax works on the C fragments:
// the row max and sum over a quad (lanes 4g .. 4g + 3) by shuffles, corr
// and p computed in registers, denom and acc rescaled in registers. The
// outputs are fresh (not in place: autograd keeps the inputs for the
// backward), written once at the end; two launches on one input give the
// same bits (fixed orders, no atomics). The staging tile XORs odd rows'
// columns by 16, and the split pass gives each half-warp 8 column pairs of
// two neighbouring rows, whose pswz differ in bit 1, so that its loads and
// its 64-bit stores are free of bank conflicts. At D <= 64: 72.5 KB of
// shared memory and 168 registers a thread, three blocks an SM.
//
// What holds it now (PERF.md has the times): at the ring's geometry it
// takes about 4x the bytes of its kept rows, and a pad-only block, which
// takes no product, still costs the carry's trip in and out at well under
// the memory's rate. Variants of the split pass (its layout, its
// unrolling) and of the shared-memory carveout moved it little on the
// card: the chains of mma.sync and the instructions around them (the split
// of each A fragment, the softmax, four barriers a stripe) hold the rest.
// wgmma, with its operands read from shared memory, is the next step.
//
// Skipping: a stripe in which no row of the tile keeps any key is skipped.
// This is exact. For a row with a finite m the stripe's row max is -inf, so
// m' = m, corr = exp(0) = 1 and every p = 0: denom * 1 + 0 and acc * 1 + 0
// are denom and acc, bit for bit. For a row whose m is -inf the plain
// update multiplies denom and acc by corr = 0; so after the last stripe a
// row whose m is still -inf gets that factor 0 applied once (idempotent when
// a stripe already applied it), and the initial carry (-inf, 0, 0) leaves as
// (-inf, 0, 0). On the ring this skips every hop whose key block lies wholly
// after the query block under the causal mask, and every pad-only block; a
// tile with no kept key at all loads neither q nor k nor v.
//
// Layout: every operand is contiguous (the wrapper makes it so: the ring
// folds [B,L,H,D] into the rank-major [sp*B,H,l,D] with one copy, which is
// contiguous). q, k and v are staged by 16-byte copies when all three start
// on 16 bytes, else by 4-byte copies; acc is read and written a column pair
// at a time when the carry starts on 8 bytes. The kernel allocates nothing;
// the caller passes the outputs and the stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per stripe
constexpr int THREADS = 128;   // 4 warps of 16 rows
constexpr int MAX_D = 128;
constexpr int KLD = BK + 4;    // keep tile row stride, bytes
constexpr int NT = BK / 8;     // 8-key n-tiles of a stripe
constexpr int KW = BQ * BK / 4 / THREADS;  // keep words a thread loads
constexpr unsigned FULL = 0xffffffffu;

// finite: neither +-inf nor NaN (the JAX body's isfinite)
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

// e^x as 2^(x log2 e) by ex2.approx (subnormal results kept): about 2
// float32 epsilons of e^x, plus |x| 2^-24 from rounding x log2 e
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// an f32 tile [64][DP]: element (r, c) at r * DP + (c ^ (gray(r) << 3))
__device__ __forceinline__ int gray(int r) { return (r ^ (r >> 1)) & 3; }
template <int DP>
__device__ __forceinline__ int raw_at(int r, int c) {
  return r * DP + (c ^ (gray(r) << 3));
}
// the k/v staging tile [64][DP]: element (r, c) at r * DP + (c ^ 16 (r & 1)),
// so that two neighbouring rows' 16-column blocks fill the 32 banks once
template <int DP>
__device__ __forceinline__ int kv_at(int r, int c) {
  return r * DP + (c ^ ((r & 1) << 4));
}
// a split tile [64][2 DP] words: each pair of columns (2u, 2u + 1) of row
// r as four words hi(2u), hi(2u + 1), lo(2u), lo(2u + 1) at 4u, XORed by
// pswz(r) (bits 1 and 4): element (r, c)'s part (0 hi, 1 lo) at
// r * 2 DP + ((4 (c >> 1) + 2 part + (c & 1)) ^ pswz(r))
__device__ __forceinline__ int pswz(int r) {
  return (((r ^ (r >> 2)) & 1) << 1) | (((r >> 1) & 1) << 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one f32 value as its TF32 high part and the TF32 rounding of the rest,
// each rounded to nearest, ties away from zero (cvt.rna.tf32.f32's rounding)
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ Split split(float x) {
  Split s;
  s.hi = tf32_rna(x);
  s.lo = tf32_rna(x - __uint_as_float(s.hi));
  return s;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c[c0 + n] += a.b[n] for n < nv in 3xTF32: lo_a.hi_b, hi_a.lo_b,
// hi_a.hi_b, each of the three over every n before the next, so that
// independent accumulators stand between the dependent mma of one chain
template <int NB, int NC>
__device__ __forceinline__ void mma3(float (&c)[NC][4], int c0,
                                     const Split (&a)[4],
                                     const uint32_t (&bh)[NB][2],
                                     const uint32_t (&bl)[NB][2], int nv) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
    if (n < nv)
      mma_tf32(c[c0 + n], a[0].lo, a[1].lo, a[2].lo, a[3].lo, bh[n][0],
               bh[n][1]);
#pragma unroll
  for (int n = 0; n < NB; ++n)
    if (n < nv)
      mma_tf32(c[c0 + n], a[0].hi, a[1].hi, a[2].hi, a[3].hi, bl[n][0],
               bl[n][1]);
#pragma unroll
  for (int n = 0; n < NB; ++n)
    if (n < nv)
      mma_tf32(c[c0 + n], a[0].hi, a[1].hi, a[2].hi, a[3].hi, bh[n][0],
               bh[n][1]);
}

// rows [t0, t0 + 64) of a [T, D] f32 matrix into an f32 tile (raw_at
// layout when GRAY, else kv_at) by cp.async, 16 bytes a copy when `vec`,
// else 4; zeros past T and past D. The caller commits and waits.
template <int DP, bool GRAY>
__device__ __forceinline__ void stage_raw(float* __restrict__ sm,
                                          const float* __restrict__ g,
                                          int t0, int T, int D, bool vec) {
  constexpr int CH = DP / 4;
#pragma unroll
  for (int it = 0; it < 64 * CH / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / CH, c = (i - r * CH) * 4;
    const int t = t0 + r;
    const bool in = t < T && c < D;
    const float* src = in ? g + (size_t)t * D + c : g;
    float* dst = sm + (GRAY ? raw_at<DP>(r, c) : kv_at<DP>(r, c));
    if (vec) {
      cp_async16(dst, src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + (in ? e : 0),
                                            in ? 4 : 0);
    }
  }
}

// a staging tile (kv_at layout) into a split tile: each element split once.
// A half-warp takes 8 column pairs of two neighbouring rows, whose pswz
// differ in bit 1, so that its 64-bit stores fill the 32 banks once.
// Unrolled 4 deep at D <= 64 (3 blocks an SM at 168 registers), not at all
// at D > 64 (no spills).
template <int DP>
__device__ __forceinline__ void split_tile(uint32_t* __restrict__ sp,
                                           const float* __restrict__ raw) {
  constexpr int G = DP / 16;  // groups of 8 column pairs in a row
  const int hw = threadIdx.x >> 4, re = (threadIdx.x >> 3) & 1,
            u0 = threadIdx.x & 7;
#pragma unroll (DP <= 64 ? 4 : 1)
  for (int it = 0; it < 32 * G / (THREADS / 16); ++it) {
    const int task = it * (THREADS / 16) + hw;
    const int r = 2 * (task / G) + re, u = 8 * (task % G) + u0;
    const float2 x =
        *reinterpret_cast<const float2*>(raw + kv_at<DP>(r, 2 * u));
    const Split s0 = split(x.x), s1 = split(x.y);
    const int sw = pswz(r);
    uint32_t* row = sp + r * 2 * DP + ((4 * u) ^ (sw & 16));
    *reinterpret_cast<uint2*>(row + (sw & 2)) = make_uint2(s0.hi, s1.hi);
    *reinterpret_cast<uint2*>(row + ((sw & 2) ^ 2)) =
        make_uint2(s0.lo, s1.lo);
  }
}

// s[n] = q rows [r0, r0 + 16) (an f32 tile) . k rows [8n, 8n + 8) (a split
// tile) over the first 8 * nks head columns, in C layout. k-step ks takes
// slot t from column 8ks + 2t and slot t + 4 from 8ks + 2t + 1. r0 is a
// multiple of 16, so the swizzles depend on g and t alone. NB n-tiles'
// B fragments at a time.
template <int DP, int NB>
__device__ __forceinline__ void scores(const float* __restrict__ a,
                                       const uint32_t* __restrict__ b,
                                       int r0, int nks, int g, int t,
                                       float (&s)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  // the swizzles XOR the k-step's offset: 8 ks ^ (gray(g) << 3) is
  // 32 (ks / 4) + 8 ((ks % 4) ^ gray(g)) and 16 ks ^ (pswz(g) & 16) is
  // 32 (ks / 2) + 16 ((ks % 2) ^ (pswz(g) >> 4 & 1)): a few base pointers
  // and immediate offsets
  const float* ap = a + (r0 + g) * DP + 2 * t;
  const float* av[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) av[v] = ap + 8 * (v ^ gray(g));
  const int sw = pswz(g);
  const uint32_t* bp = b + g * 2 * DP + 4 * t;
  const uint32_t* bhv[2];
  const uint32_t* blv[2];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    bhv[v] = bp + 16 * (v ^ ((sw >> 4) & 1)) + (sw & 2);
    blv[v] = bp + 16 * (v ^ ((sw >> 4) & 1)) + ((sw & 2) ^ 2);
  }
#pragma unroll (DP <= 64 ? DP / 8 : 4)
  for (int ks = 0; ks < DP / 8; ++ks) {
    if (ks < nks) {
      const float* a0 = av[ks % 4] + 32 * (ks / 4);
      const float2 x0 = *reinterpret_cast<const float2*>(a0);
      const float2 x1 = *reinterpret_cast<const float2*>(a0 + 8 * DP);
      const Split af[4] = {split(x0.x), split(x1.x), split(x0.y),
                           split(x1.y)};
      // the B fragments of NB n-tiles at a time
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NB) {
        uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int o = (n0 + i) * 16 * DP + 32 * (ks / 2);
          const uint2 yh = *reinterpret_cast<const uint2*>(bhv[ks % 2] + o);
          const uint2 yl = *reinterpret_cast<const uint2*>(blv[ks % 2] + o);
          bh[i][0] = yh.x;
          bh[i][1] = yh.y;
          bl[i][0] = yl.x;
          bl[i][1] = yl.y;
        }
        mma3<NB>(s, n0, af, bh, bl, NB);
      }
    }
  }
}

// acc[i] += P.V over head columns 8i + g, i < nks: P the C fragments p[n]
// of the stripe's [16 x 64] probabilities as A (slot t = key 8n + 2t, slot
// t + 4 = 8n + 2t + 1), V rows 8n + 2t and 8n + 2t + 1 of a split tile; DG
// n-tiles of head columns at a time, those past the head width skipped
template <int DP, int DG>
__device__ __forceinline__ void pv_product(const float (&p)[NT][4],
                                           const uint32_t* __restrict__ b,
                                           int nks, int g, int t,
                                           float (&acc)[DP / 8][4]) {
  // rows 2t and 2t + 1 (e = 0, 1), their hi and lo words (h = 0, 1), and
  // the parity of the n-tile of head columns (v): 16 dn ^ (pswz & 16) is
  // 32 (dn / 2) + 16 ((dn % 2) ^ (pswz >> 4 & 1))
  const uint32_t* base[2][2][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int sw = pswz(2 * t + e);
    const uint32_t* row = b + (2 * t + e) * 2 * DP + 4 * (g >> 1) + (g & 1);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      base[e][0][v] = row + 16 * (v ^ ((sw >> 4) & 1)) + (sw & 2);
      base[e][1][v] = row + 16 * (v ^ ((sw >> 4) & 1)) + ((sw & 2) ^ 2);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const Split af[4] = {split(p[n][0]), split(p[n][2]), split(p[n][1]),
                         split(p[n][3])};
#pragma unroll
    for (int dg = 0; dg < DP / 8; dg += DG) {
      uint32_t bh[DG][2], bl[DG][2];
#pragma unroll
      for (int i = 0; i < DG; ++i) {
        const int dn = dg + i;
        const int o = n * 16 * DP + 32 * (dn / 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bh[i][e] = base[e][0][dn % 2][o];
          bl[i][e] = base[e][1][dn % 2][o];
        }
      }
      mma3<DG>(acc, dg, af, bh, bl, nks - dg);
    }
  }
}

// the keep sub-tile of query rows [q0, q0 + BQ) and keys [k0, k0 + BK),
// 4 keys a word, into registers (0 past the edges); 4-byte loads when `vec`
// (Tk % 4 == 0 and the mask 4-byte aligned)
__device__ __forceinline__ void keep_words(uint32_t (&w)[KW],
                                           const int8_t* __restrict__ mp,
                                           int q0, int Tq, int k0, int Tk,
                                           bool vec) {
#pragma unroll
  for (int it = 0; it < KW; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / (BK / 4), c = (i - r * (BK / 4)) * 4;
    const int tq = q0 + r, tk = k0 + c;
    w[it] = 0;
    if (tq < Tq && tk < Tk) {
      const int8_t* src = mp + (size_t)tq * Tk + tk;
      if (vec) {
        w[it] = *reinterpret_cast<const uint32_t*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tk + e < Tk) w[it] |= (uint32_t)(uint8_t)src[e] << (8 * e);
      }
    }
  }
}
// those words into the keep tile ks [BQ][KLD]; true when some entry is kept
__device__ __forceinline__ bool store_keep(int8_t* __restrict__ ks,
                                           const uint32_t (&w)[KW]) {
  bool any = false;
#pragma unroll
  for (int it = 0; it < KW; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / (BK / 4), c = (i - r * (BK / 4)) * 4;
    *reinterpret_cast<uint32_t*>(ks + r * KLD + c) = w[it];
    any |= w[it] != 0;
  }
  return any;
}
// load and store at once; ends with a barrier, so every thread sees the
// same answer
__device__ __forceinline__ bool load_keep(int8_t* __restrict__ ks,
                                          const int8_t* __restrict__ mp,
                                          int q0, int Tq, int k0, int Tk,
                                          bool vec) {
  uint32_t w[KW];
  keep_words(w, mp, q0, Tq, k0, Tk, vec);
  return __syncthreads_or(store_keep(ks, w)) != 0;
}

// the resident q tile, the raw buffer, the split buffer, two keep tiles
template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)2 * 64 * DP * sizeof(float) +
         (size_t)64 * 2 * DP * sizeof(uint32_t) + (size_t)2 * BQ * KLD;
}

// Warp w owns rows 16w .. 16w + 15 of the query tile; a thread holds rows
// g and g + 8 (index j = 0, 1) and, of each stripe, keys 8n + 2t and
// 8n + 2t + 1. (The name is what a profiler trace of the step is searched
// for.)
template <int DP>
__global__ void __launch_bounds__(THREADS)
block_update_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int8_t* __restrict__ mask,
                    const float* __restrict__ m_in,
                    const float* __restrict__ d_in,
                    const float* __restrict__ a_in, float* __restrict__ m_out,
                    float* __restrict__ d_out, float* __restrict__ a_out,
                    int H, int Tq, int Tk, int D, float scale, bool vec,
                    bool mask_vec, bool pair) {
  constexpr bool PREFETCH = DP <= 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [BQ][DP] q rows
  float* raw = qs + BQ * DP;        // [BK][DP] the next k or v stripe
  uint32_t* sp = reinterpret_cast<uint32_t*>(raw + BK * DP);  // split
  int8_t* keep_s = reinterpret_cast<int8_t*>(sp + BK * 2 * DP);  // 2 tiles

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const size_t nh = (size_t)n * H + h;
  const float* kg = k + nh * Tk * D;
  const float* vg = v + nh * Tk * D;
  const int8_t* mp = mask + (size_t)n * Tq * Tk;
  const int nks = D / 8;
  const int r0 = warp * 16;

  // the carried running max and denominator of rows g and g + 8
  float m[2], l[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tq = q0 + r0 + g + 8 * j;
    m[j] = tq < Tq ? m_in[nh * Tq + tq] : -INFINITY;
    l[j] = tq < Tq ? d_in[nh * Tq + tq] : 0.f;
  }

  // the first stripe that keeps a key; q and its k by cp.async
  int cur = 0, kb = 0;
  while (cur < Tk && !load_keep(keep_s, mp, q0, Tq, cur, Tk, mask_vec))
    cur += BK;
  if (cur < Tk) {
    stage_raw<DP, true>(qs, q + nh * Tq * D, q0, Tq, D, vec);
    stage_raw<DP, false>(raw, kg, cur, Tk, D, vec);
    cp_async_commit();
  }

  // the carried acc as C fragments: rows g, g + 8, columns 8dn + 2t, + 1
  // (a pair at a time when the carry starts on 8 bytes)
  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tq = q0 + r0 + g + 8 * j;
      const float* src = a_in + (nh * Tq + tq) * D + 8 * dn + 2 * t;
      float2 x = make_float2(0.f, 0.f);
      if (tq < Tq && dn < nks)
        x = pair ? *reinterpret_cast<const float2*>(src)
                 : make_float2(src[0], src[1]);
      acc[dn][2 * j] = x.x;
      acc[dn][2 * j + 1] = x.y;
    }

  while (cur < Tk) {
    const int8_t* keep = keep_s + kb * BQ * KLD;
    cp_async_wait_all();
    __syncthreads();  // k(cur) landed; the last p.v's readers are done
    split_tile<DP>(sp, raw);
    __syncthreads();  // split k ready; the raw buffer is free
    stage_raw<DP, false>(raw, vg, cur, Tk, D, vec);
    cp_async_commit();
    // the next stripe's keep words, in flight while the scores run (at
    // D <= 64: wider heads leave no registers for them)
    int nxt = cur + BK;
    uint32_t kw[KW];
    if (PREFETCH) keep_words(kw, mp, q0, Tq, nxt, Tk, mask_vec);

    float s[NT][4];
    scores<DP, PREFETCH ? 4 : 2>(qs, sp, r0, nks, g, t, s);

    // the stripe's online softmax in fragments: element (nt, e) is row
    // g + 8 (e >> 1), key 8 nt + 2t + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const char2 kk = *reinterpret_cast<const char2*>(
            keep + (r0 + g + 8 * j) * KLD + 8 * nt + 2 * t);
        const float s0 = __fmul_rn(s[nt][2 * j], scale);
        const float s1 = __fmul_rn(s[nt][2 * j + 1], scale);
        s[nt][2 * j] = kk.x != 0 ? s0 : -INFINITY;
        s[nt][2 * j + 1] = kk.y != 0 ? s1 : -INFINITY;
        mx[j] = fmaxf(mx[j], fmaxf(s[nt][2 * j], s[nt][2 * j + 1]));
      }
    float mn[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL, mx[j], 2));
      mn[j] = fmaxf(m[j], mx[j]);
      // guard -inf - -inf: a row with every key masked so far
      corr[j] = finite(m[j]) ? expf(m[j] - mn[j]) : 0.f;
      m[j] = mn[j];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e >> 1;
        const float sc = s[nt][e];
        const float p = finite(sc) ? exp_approx(sc - mn[j]) : 0.f;
        s[nt][e] = p;
        sum[j] += p;
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sum[j] += __shfl_xor_sync(FULL, sum[j], 1);
      sum[j] += __shfl_xor_sync(FULL, sum[j], 2);
      l[j] = l[j] * corr[j] + sum[j];
    }
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= corr[e >> 1];

    cp_async_wait_all();
    __syncthreads();  // v(cur) landed; the scores' readers are done
    split_tile<DP>(sp, raw);
    int8_t* keep_next = keep_s + (kb ^ 1) * BQ * KLD;
    // a barrier: split v ready, the raw buffer free, the answer shared
    bool any = __syncthreads_or(PREFETCH && nxt < Tk &&
                                store_keep(keep_next, kw)) != 0;
    if (!any) {  // the next stripe keeps no key, or was not prefetched
      if (PREFETCH) nxt += BK;
      while (nxt < Tk &&
             !(any = load_keep(keep_next, mp, q0, Tq, nxt, Tk, mask_vec)))
        nxt += BK;
    }
    if (any) {
      stage_raw<DP, false>(raw, kg, nxt, Tk, D, vec);
      cp_async_commit();
    }

    pv_product<DP, DP <= 64 ? 8 : 2>(s, sp, nks, g, t, acc);
    cur = any ? nxt : Tk;
    kb ^= 1;
  }

  // the fresh carry; a row whose max is still -inf takes the plain
  // update's corr = 0 (see the note at the head of this file)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tq = q0 + r0 + g + 8 * j;
    if (tq >= Tq) continue;
    const size_t row = nh * Tq + tq;
    const float zero_if_unseen = finite(m[j]) ? 1.f : 0.f;
    if (t == 0) {
      m_out[row] = m[j];
      d_out[row] = l[j] * zero_if_unseen;
    }
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      if (dn < nks) {
        float* dst = a_out + row * D + 8 * dn + 2 * t;
        const float2 x = make_float2(acc[dn][2 * j] * zero_if_unseen,
                                     acc[dn][2 * j + 1] * zero_if_unseen);
        if (pair) {
          *reinterpret_cast<float2*>(dst) = x;
        } else {
          dst[0] = x.x;
          dst[1] = x.y;
        }
      }
    }
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int8_t* mask, const float* m_in, const float* d_in,
                   const float* a_in, float* m_out, float* d_out,
                   float* a_out, int N, int H, int Tq, int Tk, int D,
                   float scale, bool vec, bool mask_vec, bool pair,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      block_update_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  block_update_kernel<DP><<<dim3((Tq + BQ - 1) / BQ, H, N), THREADS, bytes,
                            stream>>>(q, k, v, mask, m_in, d_in, a_in, m_out,
                                      d_out, a_out, H, Tq, Tk, D, scale, vec,
                                      mask_vec, pair);
  return cudaGetLastError();
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
  const bool vec = ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const bool mask_vec =
      Tk % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const bool pair = ((reinterpret_cast<uintptr_t>(a_in) |
                      reinterpret_cast<uintptr_t>(a_out)) % 8) == 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const int8_t* mk = static_cast<const int8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      D <= 64 ? launch<64>(f(q), f(k), f(v), mk, f(m_in), f(d_in), f(a_in),
                           o(m_out), o(d_out), o(a_out), N, H, Tq, Tk, D,
                           scale, vec, mask_vec, pair, st)
              : launch<128>(f(q), f(k), f(v), mk, f(m_in), f(d_in),
                            f(a_in), o(m_out), o(d_out), o(a_out), N, H, Tq,
                            Tk, D, scale, vec, mask_vec, pair, st);
  return (int)e;
}

}  // extern "C"
