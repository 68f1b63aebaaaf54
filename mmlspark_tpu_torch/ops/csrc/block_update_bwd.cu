// The backward of the ring-hop block update for Hopper (sm_90a): the
// gradients of one online-softmax update of a carried (m, denom, acc) over a
// whole K/V block, f32 in and out, its five products on the tensor cores.
//
// What it replaces. The JAX package has no backward kernel here: its
// training differentiates mmlspark_tpu/ops/pallas/attention.py:
// _online_update (:59) with jax.vjp through XLA. This file is that vjp in
// closed form. Per (n, h) and query row i, with keys j of the block,
// keep_ij from the shared [N,Tq,Tk] mask:
//
//   s_ij = scale * q_i.k_j (kept; -inf elsewhere), b_i = max_j s_ij,
//   m'_i = max(m_i, b_i), c_i = exp(m_i - m'_i) (0 while m_i = -inf),
//   p_ij = exp(s_ij - m'_i) (0 where masked)
//
// and, given the cotangents (gm, gD, gA) of the fresh (m', D', A'):
//
//   dA_i = c_i gA_i, dD_i = c_i gD_i, dc_i = gA_i.A_i + gD_i D_i,
//   dp_ij = gA_i.v_j + gD_i, dv_j = sum_i p_ij gA_i,
//   dm'_i = gm_i - c_i dc_i - sum_j p_ij dp_ij,
//   m'_i = max(m_i, b_i) sends dm'_i to m_i where m_i > b_i, to b_i where
//   b_i > m_i and half to each at a tie; b_i sends its share evenly to the
//   kept keys with s_ij == b_i (torch.maximum/amax and jnp.maximum/max do),
//   dm_i = c_i dc_i + (m_i's share),
//   ds_ij = p_ij dp_ij + (key j's share of b_i's), dq_i = scale sum_j ds_ij
//   k_j, dk_j = scale sum_i ds_ij q_i.
//
// Dead rows (m_i = -inf and no kept key in the block): the plain route's
// autograd gives NaN for dm_i and 0 for everything else of the row; so does
// this file. Such a row's dm'_i never reaches dq or dk: it has no kept key.
//
// Bounds on an H100 (N=32, H=12, Tq=Tk=256, D=64, the ring's first batch,
// mean over its 4 hops): the function does 10*H*D f32 operations per kept
// (query, key) pair (five products: s, dp, dq, dk, dv), 0.103 ms a hop at
// the 67 TFLOP/s of the CUDA cores; it must move about 231 MB (q, k, v, the
// carry, three cotangents and the mask read, six gradients written), 0.069
// ms at 3.35 TB/s. On the tensor cores each f32 product costs three TF32
// products, 0.042 ms at 495 TFLOP/s, so on the units this kernel uses the
// floor is the bytes, 0.069 ms.
//
// Precision: 3xTF32. Each f32 operand x is split as hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest with ties away from zero (the
// rounding of cvt.rna.tf32.f32, done here by adding half a TF32 unit to
// the bits and clearing the 13 low ones: the same values for every finite
// x in two integer instructions); x - hi is exact and |x - hi - lo| <=
// 2^-22 |x|. A product a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b,
// small terms first, in one f32 accumulator: the products of 11-bit
// significands are exact; the dropped lo_a.lo_b and the two roundings of
// lo leave about 3 * 2^-22 = 6 float32 epsilons of |a.b|, before the
// accumulation's own rounding (the tensor core adds each group of 8
// products into the accumulator, truncating: about one epsilon of the
// partial sum a step). The check holds every gradient within 64 epsilons
// of the sizes of its terms (ops/attention.py
// block_update_backward_error_bound); one TF32 product alone errs by about
// 2^-11 = 4096 epsilons. Small integers are exact in hi with lo = 0, so
// integer scores stay exact.
//
// Fragments (mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32; lane = 4g + t):
// A 16x8 holds (g, t), (g+8, t), (g, t+4), (g+8, t+4); B 8x8 holds (t, g),
// (t+4, g); C 16x8 holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1). The
// k order inside one mma is free, so
// * the scores and dp take k-slot t from head column 8ks + 2t and slot t + 4
//   from 8ks + 2t + 1;
// * a product whose A side is a C fragment (ds.k in launch 1, p^T.gA and
//   ds^T.q in launch 2) takes slot t from C column 2t and slot t + 4 from
//   2t + 1, so the C fragment is the A fragment as it stands, and the B
//   side loads its rows 2t and 2t + 1 to match.
//
// Shared memory. Each launch keeps a 64-row tile resident as the A side
// (launch 1: q and gA; launch 2: k and v), f32 with row r's 8-column groups
// XORed by a Gray code of r, and stages 64-row tiles of the other side as
// the B operand (launch 1: k and v stripes; launch 2: q and gA tiles)
// already split: each element once, each pair of columns as (hi, hi, lo,
// lo), so that a B fragment's two hi words and its two lo words land in
// the register pairs the mma takes, with no move and no instruction
// beyond the loads. The split tile's rows are XORed by pswz(r), which
// leaves the A loads (8 bytes), the score B loads (two of 8 bytes) and the
// C-side B loads (rows 2t and 2t + 1, four of 4 bytes) free of bank
// conflicts. 101 KB a block at D <= 64: two blocks an SM.
//
// Design: two launches of 4 warps, deterministic (no float atomics: two
// launches on one input give the same bits), recompute only:
//
// 1. bu_bwd_dq, one block per (n, h, 64-row query tile), a warp per 16
//    rows. Pass 1 walks the key stripes for each row's b_i. Pass 2 walks
//    them again, recomputes s and p, forms dp from gA and v, and
//    accumulates sum_j p dp, ds.k and, per row, the count and the sum of
//    the keys that tie at b_i (a 64-bit mask per row and stripe OR-ed over
//    the quad; the tied keys' rows added in key order into the thread's
//    own entries of dq, which serve as that sum's scratch until the end).
//    It writes dq (with b's share), dm, dD, dA and, per row, (m'_i, b_i,
//    t_i) for launch 2, t_i being the share of b_i's gradient each tied key
//    takes.
// 2. bu_bwd_dkdv, one block per (n, h, 64-key tile), a warp per 16 keys. It
//    walks the query tiles in order, computes s^T and dp^T (k and v as A,
//    q and gA as B), p and ds, adds t_i where s_ij == b_i, and accumulates
//    dk and dv in registers; each is written once.
//
// The tie test of launch 2 must see launch 1's b_i bit for bit. Launch 2
// computes s^T = k.q^T with the roles of launch 1's s = q.k^T swapped, but
// every element takes the same exact products into the same k-slots in the
// same order: the same splits, the same column of each slot, and the three
// products mirrored (hi_k.lo_q, lo_k.hi_q, hi_k.hi_q against launch 1's
// lo_q.hi_k, hi_q.lo_k, hi_q.hi_k), then one rounded multiply by the scale.
// The card holds this: every live row's largest key ties with b_i, and its
// share reaches dk only where launch 2's score equals b_i bit for bit, so
// a score that differed would move dk by the share's whole size, far past
// the bound, in every case chip_smoke.py checks (and both integer cases
// tie many keys exactly). Every row sum runs in a fixed order (a thread's
// keys in order, then a butterfly over the quad), so a repeat gives the
// same bits.
//
// What holds it now: two blocks of 4 warps an SM (about 250 registers a
// thread, 101 KB), whose warps wait on the staging loads, the barriers and
// the chains of mma more than the tensor cores work (PERF.md has the
// times); wgmma, with its operands read from shared memory, is the next
// step, once the three transposed products have K-major tiles.
//
// Skipping: a (query tile, key stripe) pair in which no row keeps any key is
// skipped in both launches. This is exact: every p of the pair is 0 and no
// key of it is kept, so none takes a share of b_i.
//
// Layout: every operand is contiguous f32 (the mask int8), q, k, v and gA
// 16-byte aligned, D <= 128 with D % 8 == 0, any Tq and Tk. The kernel
// allocates nothing; the caller passes the outputs, the [N,H,Tq,3] f32 row
// scratch and the stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per stripe
constexpr int THREADS = 128;   // 4 warps of 16 rows, both launches
constexpr int MAX_D = 128;
constexpr int KLD = BK + 4;    // keep tile row stride, bytes
constexpr unsigned FULL = 0xffffffffu;

// launch 1: row j (0, 1) of the thread's two in its query tile, 16 w + g
// and 16 w + g + 8, read from the thread index where it is needed
__device__ __forceinline__ int tile_row(int j) {
  return ((threadIdx.x >> 5) << 4) + ((threadIdx.x & 31) >> 2) + 8 * j;
}

// finite: neither +-inf nor NaN (the plain version's isfinite)
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

// e^x as 2^(x log2 e) by ex2.approx (subnormal results kept): about 2
// float32 epsilons of e^x, plus |x| 2^-24 from rounding x log2 e; the
// check grants p (|s - m'| + 1) 64 epsilons
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
// independent accumulators stand between the dependent mma of one chain.
// MIRROR takes the first two in the other order (hi_a.lo_b, lo_a.hi_b), so
// that b.a^T adds the same products in the same order as a.b^T.
template <bool MIRROR, int NT, int NC>
__device__ __forceinline__ void mma3(float (&c)[NC][4], int c0,
                                     const Split (&a)[4],
                                     const uint32_t (&bh)[NT][2],
                                     const uint32_t (&bl)[NT][2], int nv) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nv) {
      if (MIRROR)
        mma_tf32(c[c0 + n], a[0].hi, a[1].hi, a[2].hi, a[3].hi, bl[n][0],
                 bl[n][1]);
      else
        mma_tf32(c[c0 + n], a[0].lo, a[1].lo, a[2].lo, a[3].lo, bh[n][0],
                 bh[n][1]);
    }
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nv) {
      if (MIRROR)
        mma_tf32(c[c0 + n], a[0].lo, a[1].lo, a[2].lo, a[3].lo, bh[n][0],
                 bh[n][1]);
      else
        mma_tf32(c[c0 + n], a[0].hi, a[1].hi, a[2].hi, a[3].hi, bl[n][0],
                 bl[n][1]);
    }
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nv)
      mma_tf32(c[c0 + n], a[0].hi, a[1].hi, a[2].hi, a[3].hi, bh[n][0],
               bh[n][1]);
}

// rows [t0, t0 + 64) of a [T, D] f32 matrix into an f32 tile by 16-byte
// cp.async; zeros past T and past D. The caller waits.
template <int DP>
__device__ __forceinline__ void stage_raw(float* __restrict__ sm,
                                          const float* __restrict__ g,
                                          int t0, int T, int D) {
  constexpr int CH = DP / 4;
#pragma unroll
  for (int it = 0; it < 64 * CH / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / CH, c = (i - r * CH) * 4;
    const int t = t0 + r;
    const bool in = t < T && c < D;
    cp_async16(sm + raw_at<DP>(r, c), in ? g + (size_t)t * D + c : g,
               in ? 16 : 0);
  }
}

// rows [t0, t0 + 64) of a [T, D] f32 matrix into a split tile: each element
// split once, zeros past T and past D; eight 16-byte loads of a thread in
// flight at a time (four at D > 64, where the accumulators take more of the
// registers)
template <int DP>
__device__ __forceinline__ void stage_split(uint32_t* __restrict__ sp,
                                            const float* __restrict__ g,
                                            int t0, int T, int D) {
  constexpr int CH = DP / 4, N = 64 * CH / THREADS, B = DP <= 64 ? 8 : 4;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += B) {
    float4 x[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int i = threadIdx.x + (i0 + j) * THREADS;
      const int r = i / CH, c = (i - r * CH) * 4;
      const int t = t0 + r;
      x[j] = t < T && c < D ? *reinterpret_cast<const float4*>(
                                  g + (size_t)t * D + c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int i = threadIdx.x + (i0 + j) * THREADS;
      const int r = i / CH, c = (i - r * CH) * 4;
      const Split s0 = split(x[j].x), s1 = split(x[j].y), s2 = split(x[j].z),
                  s3 = split(x[j].w);
      const int sw = pswz(r);
      uint32_t* hi = sp + r * 2 * DP + (sw & 2);
      uint32_t* lo = sp + r * 2 * DP + ((sw & 2) ^ 2);
      const int w0 = (2 * c) ^ (sw & 16), w1 = (2 * c + 4) ^ (sw & 16);
      *reinterpret_cast<uint2*>(hi + w0) = make_uint2(s0.hi, s1.hi);
      *reinterpret_cast<uint2*>(lo + w0) = make_uint2(s0.lo, s1.lo);
      *reinterpret_cast<uint2*>(hi + w1) = make_uint2(s2.hi, s3.hi);
      *reinterpret_cast<uint2*>(lo + w1) = make_uint2(s2.lo, s3.lo);
    }
  }
}

// s[n] = A rows [r0, r0 + 16) (an f32 tile) . B rows [c0 + 8n, c0 + 8n + 8)
// (a split tile) over the first 8 * nks head columns, in C layout. k-step
// ks takes slot t from column 8ks + 2t and slot t + 4 from 8ks + 2t + 1.
// r0 is a multiple of 16 and c0 of 8, so the swizzles depend on g and t
// alone.
template <int DP, int NT, bool MIRROR>
__device__ __forceinline__ void tile_product(const float* __restrict__ a,
                                             const uint32_t* __restrict__ b,
                                             int r0, int c0, int nks, int g,
                                             int t, float (&s)[NT][4]) {
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
  const uint32_t* bp = b + (c0 + g) * 2 * DP + 4 * t;
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
      // the B fragments of four n-tiles at a time
      constexpr int NB = NT < 4 ? NT : 4;
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
        mma3<MIRROR>(s, n0, af, bh, bl, NB);
      }
    }
  }
}

// acc[i] += F.B over head columns 8 (dn0 + i) + g, i < ND: F the C
// fragments f[n] of a [16 x 8 NT] tile as A (slot t = its column 8n + 2t,
// slot t + 4 = 8n + 2t + 1), B rows c0 + 8n + 2t and + 1 of a split tile;
// DG n-tiles of head columns at a time, those past the head width skipped
template <int DP, int NT, int ND, int DG>
__device__ __forceinline__ void fragment_product(
    const float (&f)[NT][4], const uint32_t* __restrict__ b, int c0,
    int dn0, int nks, int g, int t, float (&acc)[ND][4]) {
  // rows 2t and 2t + 1 (e = 0, 1), their hi and lo words (h = 0, 1), and
  // the parity of the n-tile of head columns (v): 16 dn ^ (pswz & 16) is
  // 32 (dn / 2) + 16 ((dn % 2) ^ (pswz >> 4 & 1))
  const uint32_t* base[2][2][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int sw = pswz(2 * t + e);
    const uint32_t* row =
        b + (c0 + 2 * t + e) * 2 * DP + 4 * (g >> 1) + (g & 1);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      base[e][0][v] = row + 16 * (v ^ ((sw >> 4) & 1)) + (sw & 2);
      base[e][1][v] = row + 16 * (v ^ ((sw >> 4) & 1)) + ((sw & 2) ^ 2);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const Split af[4] = {split(f[n][0]), split(f[n][2]), split(f[n][1]),
                         split(f[n][3])};
#pragma unroll
    for (int dg = 0; dg < ND; dg += DG) {
      uint32_t bh[DG][2], bl[DG][2];
#pragma unroll
      for (int i = 0; i < DG; ++i) {
        const int dn = dn0 + dg + i;
        const int o = n * 16 * DP + 32 * (dn / 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bh[i][e] = base[e][0][dn % 2][o];
          bl[i][e] = base[e][1][dn % 2][o];
        }
      }
      mma3<false>(acc, dg, af, bh, bl, nks - dn0 - dg);
    }
  }
}

// the keep sub-tile of query rows [q0, q0 + BQ) and keys [k0, k0 + BK)
// into ks [BQ][KLD] (0 past the edges), 4 keys a thread; 4-byte loads when
// `vec` (Tk % 4 == 0 and the mask 4-byte aligned). True when some entry is
// kept; ends with a barrier, so every thread sees the same answer.
__device__ __forceinline__ bool load_keep(int8_t* __restrict__ ks,
                                          const int8_t* __restrict__ mp,
                                          int q0, int Tq, int k0, int Tk,
                                          bool vec) {
  bool any = false;
#pragma unroll
  for (int it = 0; it < BQ * BK / 4 / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / (BK / 4), c = (i - r * (BK / 4)) * 4;
    const int tq = q0 + r, tk = k0 + c;
    uint32_t w = 0;
    if (tq < Tq && tk < Tk) {
      const int8_t* src = mp + (size_t)tq * Tk + tk;
      if (vec) {
        w = *reinterpret_cast<const uint32_t*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tk + e < Tk) w |= (uint32_t)(uint8_t)src[e] << (8 * e);
      }
    }
    *reinterpret_cast<uint32_t*>(ks + r * KLD + c) = w;
    any |= w != 0;
  }
  return __syncthreads_or(any) != 0;
}

// one resident f32 tile pair, one staged split tile pair, the keep tile
template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)2 * 64 * DP * sizeof(float) +
         (size_t)2 * 64 * 2 * DP * sizeof(uint32_t) + 64 * sizeof(float4) +
         (size_t)BQ * KLD;
}

// Launch 1. Warp w owns rows 16w .. 16w + 15 of the query tile; a thread
// holds rows g and g + 8 (index j = 0, 1) and, of each sweep of 8 NT keys,
// keys 8n + 2t and 8n + 2t + 1.
template <int DP>
__global__ void __launch_bounds__(THREADS)
bu_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int8_t* __restrict__ mask,
          const float* __restrict__ m_in, const float* __restrict__ d_in,
          const float* __restrict__ a_in, const float* __restrict__ gm,
          const float* __restrict__ gd, const float* __restrict__ ga,
          float* __restrict__ dq, float* __restrict__ dm,
          float* __restrict__ dd, float* __restrict__ da,
          float* __restrict__ rowstat, int H, int Tq, int Tk, int D,
          float scale, bool mask_vec) {
  // n-tiles of 8 keys a warp sweeps at once: the whole stripe when the
  // head width leaves the registers for it, else a quarter of it
  constexpr int NT = DP <= 64 ? 8 : 2;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [BQ][DP] q rows
  float* gas = qs + BQ * DP;        // [BQ][DP] gA rows
  uint32_t* kp = reinterpret_cast<uint32_t*>(gas + BQ * DP);  // k stripe
  uint32_t* vp = kp + BK * 2 * DP;  // v stripe, split
  int8_t* keep_s = reinterpret_cast<int8_t*>(vp + BK * 2 * DP + 4 * 64);

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

  stage_raw<DP>(qs, q + nh * Tq * D, q0, Tq, D);
  stage_raw<DP>(gas, ga + nh * Tq * D, q0, Tq, D);

  const int r0 = warp * 16;
  // this thread's entries of its rows' dq, the tied keys' sums until the end
  float* dqt = dq + nh * Tq * D + 2 * t;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (q0 + tile_row(j) < Tq)
      for (int dn = 0; dn < nks; ++dn)
        *reinterpret_cast<float2*>(dqt + (q0 + tile_row(j)) * D + 8 * dn) =
            make_float2(0.f, 0.f);

  // pass 1: b_i, the largest kept score of each row
  float b[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the previous stripe's readers are done
    if (!load_keep(keep_s, mp, q0, Tq, k0, Tk, mask_vec)) continue;
    stage_split<DP>(kp, kg, k0, Tk, D);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1  // one sweep at a time: the registers hold one
    for (int c0 = 0; c0 < BK; c0 += 8 * NT) {
      float s[NT][4];
      tile_product<DP, NT, false>(qs, kp, r0, c0, nks, g, t, s);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e >> 1, c = c0 + 8 * nt + 2 * t + (e & 1);
          if (keep_s[tile_row(j) * KLD + c] != 0)
            b[j] = fmaxf(b[j], __fmul_rn(s[nt][e], scale));
        }
    }
  }
  float gdr[2], mn[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tq = q0 + tile_row(j);
    gdr[j] = tq < Tq ? gd[nh * Tq + tq] : 0.f;
    b[j] = fmaxf(b[j], __shfl_xor_sync(FULL, b[j], 1));
    b[j] = fmaxf(b[j], __shfl_xor_sync(FULL, b[j], 2));
    mn[j] = fmaxf(tq < Tq ? m_in[nh * Tq + tq] : -INFINITY, b[j]);
  }

  // pass 2: sum_j p dp, ds.k, and the keys tied at b_i
  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;
  float psum[2] = {0.f, 0.f};
  int cnt[2] = {0, 0};  // the row's tied keys (the quad's lanes agree)
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();
    if (!load_keep(keep_s, mp, q0, Tq, k0, Tk, mask_vec)) continue;
    stage_split<DP>(kp, kg, k0, Tk, D);
    stage_split<DP>(vp, vg, k0, Tk, D);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1  // one sweep at a time: the registers hold one
    for (int c0 = 0; c0 < BK; c0 += 8 * NT) {
      float s[NT][4], dpv[NT][4];
      tile_product<DP, NT, false>(qs, kp, r0, c0, nks, g, t, s);
      tile_product<DP, NT, false>(gas, vp, r0, c0, nks, g, t, dpv);
      unsigned long long tm[2] = {0ull, 0ull};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e >> 1, c = c0 + 8 * nt + 2 * t + (e & 1);
          const bool kept = keep_s[tile_row(j) * KLD + c] != 0;
          const float sc = __fmul_rn(s[nt][e], scale);
          const float p = kept ? exp_approx(sc - mn[j]) : 0.f;
          const float ds = p * (dpv[nt][e] + gdr[j]);
          psum[j] += ds;
          tm[j] |= (unsigned long long)(kept && sc == b[j]) << c;
          s[nt][e] = ds;
        }
      fragment_product<DP, NT, DP / 8, DP <= 64 ? 8 : 2>(s, kp, c0, 0, nks,
                                                         g, t, acc);
      // the tied keys, in key order (almost always the row's one argmax),
      // summed into this thread's dq entries
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        tm[j] |= __shfl_xor_sync(FULL, tm[j], 1);
        tm[j] |= __shfl_xor_sync(FULL, tm[j], 2);
        cnt[j] += __popcll(tm[j]);
        while (tm[j]) {
          const int c = __ffsll((long long)tm[j]) - 1;
          tm[j] &= tm[j] - 1;
          const float* kr = kg + (size_t)(k0 + c) * D + 2 * t;
          for (int dn = 0; dn < nks; ++dn) {
            const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * dn);
            float2* o = reinterpret_cast<float2*>(
                dqt + (q0 + tile_row(j)) * D + 8 * dn);
            const float2 ov = *o;
            *o = make_float2(ov.x + kv.x, ov.y + kv.y);
          }
        }
      }
    }
  }
  cp_async_wait_all();  // q and gA, when every stripe was skipped
  __syncthreads();

  // the rows: c, dc, dm', the max's split, and the outputs
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    psum[j] += __shfl_xor_sync(FULL, psum[j], 1);
    psum[j] += __shfl_xor_sync(FULL, psum[j], 2);
    const int r = tile_row(j);
    const int tq = q0 + r;
    const bool in = tq < Tq;
    const size_t row = nh * Tq + (in ? tq : 0);
    // gA_i.A_i: the quad's lanes over d = t, t + 4, ..., then the quad
    float dcp = 0.f;
    if (in)
      for (int d = t; d < D; d += 4)
        dcp = fmaf(gas[raw_at<DP>(r, d)], a_in[row * D + d], dcp);
    dcp += __shfl_xor_sync(FULL, dcp, 1);
    dcp += __shfl_xor_sync(FULL, dcp, 2);
    if (!in) continue;
    const float mr = m_in[row];
    const float dc = fmaf(gdr[j], d_in[row], dcp);
    const float c = finite(mr) ? expf(mr - mn[j]) : 0.f;
    const float cdc = c * dc;
    const float dmn = gm[row] - cdc - psum[j];
    float sm, sb;
    if (mr > b[j]) {
      sm = dmn;
      sb = 0.f;
    } else if (b[j] > mr) {
      sm = 0.f;
      sb = dmn;
    } else {
      sm = sb = 0.5f * dmn;
    }
    const float share = cnt[j] > 0 ? sb / (float)cnt[j] : 0.f;
    if (t == 0) {
      dm[row] = finite(mn[j]) ? cdc + sm : __int_as_float(0x7fc00000);
      dd[row] = c * gdr[j];
      rowstat[row * 3 + 0] = mn[j];
      rowstat[row * 3 + 1] = b[j];
      rowstat[row * 3 + 2] = share;
    }
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      if (dn < nks) {
        const int col = 8 * dn + 2 * t;
        float2* o = reinterpret_cast<float2*>(dqt + tq * D + 8 * dn);
        const float2 kt = *o;
        const float2 gv =
            *reinterpret_cast<const float2*>(gas + raw_at<DP>(r, col));
        *o = make_float2(scale * fmaf(share, kt.x, acc[dn][2 * j]),
                         scale * fmaf(share, kt.y, acc[dn][2 * j + 1]));
        *reinterpret_cast<float2*>(da + row * D + col) =
            make_float2(c * gv.x, c * gv.y);
      }
    }
  }
}

// Launch 2. Warp w owns keys 16w .. 16w + 15 of the key tile; a thread
// holds keys g and g + 8 (index j = 0, 1) and, of each sweep of 8 NT query
// rows, rows 8n + 2t and 8n + 2t + 1.
template <int DP>
__global__ void __launch_bounds__(THREADS)
bu_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int8_t* __restrict__ mask,
            const float* __restrict__ gd, const float* __restrict__ ga,
            const float* __restrict__ rowstat, float* __restrict__ dk,
            float* __restrict__ dv, int H, int Tq, int Tk, int D,
            float scale, bool mask_vec) {
  // n-tiles of 8 columns a warp sweeps at once: the whole 64-wide tile
  // when the head width leaves the registers for it, else half of it
  constexpr int NT = DP <= 64 ? 8 : 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [BK][DP] this block's keys
  float* vs = ks + BK * DP;         // [BK][DP] and values
  uint32_t* qp = reinterpret_cast<uint32_t*>(vs + BK * DP);  // q tile
  uint32_t* gp = qp + BQ * 2 * DP;  // gA tile, split
  float4* rst = reinterpret_cast<float4*>(gp + BQ * 2 * DP);  // m', b, t, gD
  int8_t* keep_s = reinterpret_cast<int8_t*>(rst + 64);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const size_t nh = (size_t)n * H + h;
  const float* qg = q + nh * Tq * D;
  const float* gag = ga + nh * Tq * D;
  const int8_t* mp = mask + (size_t)n * Tq * Tk;
  const int nks = D / 8;

  stage_raw<DP>(ks, k + nh * Tk * D, k0, Tk, D);
  stage_raw<DP>(vs, v + nh * Tk * D, k0, Tk, D);

  const int r0 = warp * 16;
  // the head columns in halves of 64 at D > 64 (each half walks the query
  // tiles again), so that dk and dv fit the registers
  constexpr int ND = DP / 8 < 8 ? DP / 8 : 8;
  for (int dn0 = 0; dn0 < nks; dn0 += ND) {
    float dka[ND][4], dva[ND][4];
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

    for (int q0 = 0; q0 < Tq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      if (!load_keep(keep_s, mp, q0, Tq, k0, Tk, mask_vec)) continue;
      if (tid < BQ) {
        const int tq = q0 + tid;
        const size_t row = nh * Tq + tq;
        rst[tid] = tq < Tq ? make_float4(rowstat[row * 3 + 0],
                                         rowstat[row * 3 + 1],
                                         rowstat[row * 3 + 2], gd[row])
                           : make_float4(-INFINITY, -INFINITY, 0.f, 0.f);
      }
      stage_split<DP>(qp, qg, q0, Tq, D);
      stage_split<DP>(gp, gag, q0, Tq, D);
      cp_async_wait_all();
      __syncthreads();
      const int qn = min(BQ, Tq - q0);
#pragma unroll 1  // one sweep at a time: the registers hold one
      for (int c0 = 0; c0 < BQ; c0 += 8 * NT) {
        if (c0 < qn) {
          float s[NT][4], dpv[NT][4];
          tile_product<DP, NT, true>(ks, qp, r0, c0, nks, g, t, s);
          tile_product<DP, NT, true>(vs, gp, r0, c0, nks, g, t, dpv);
          // s becomes ds, dpv becomes p: element (key r0 + g + 8j, query
          // c0 + 8nt + 2t + e)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = c0 + 8 * nt + 2 * t + e;
              const float4 sti = rst[i];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const bool kept = keep_s[i * KLD + r0 + g + 8 * j] != 0;
                const float sc = __fmul_rn(s[nt][2 * j + e], scale);
                const float p = kept ? exp_approx(sc - sti.x) : 0.f;
                float ds = p * (dpv[nt][2 * j + e] + sti.w);
                if (kept && sc == sti.y) ds += sti.z;
                s[nt][2 * j + e] = ds;
                dpv[nt][2 * j + e] = p;
              }
            }
          fragment_product<DP, NT, ND, ND>(dpv, gp, c0, dn0, nks, g, t, dva);
          fragment_product<DP, NT, ND, ND>(s, qp, c0, dn0, nks, g, t, dka);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tk = k0 + r0 + g + 8 * j;
      if (tk >= Tk) continue;
      const size_t row = nh * Tk + tk;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        if (dn0 + i < nks) {
          const int col = 8 * (dn0 + i) + 2 * t;
          *reinterpret_cast<float2*>(dk + row * D + col) = make_float2(
              scale * dka[i][2 * j], scale * dka[i][2 * j + 1]);
          *reinterpret_cast<float2*>(dv + row * D + col) =
              make_float2(dva[i][2 * j], dva[i][2 * j + 1]);
        }
      }
    }
  }
  cp_async_wait_all();  // k and v, when every query tile was skipped
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int8_t* mask, const float* m_in, const float* d_in,
                   const float* a_in, const float* gm, const float* gd,
                   const float* ga, float* dq, float* dk, float* dv,
                   float* dm, float* dd, float* da, float* rowstat, int N,
                   int H, int Tq, int Tk, int D, float scale, bool mask_vec,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      bu_bwd_dq<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bu_bwd_dkdv<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  bu_bwd_dq<DP><<<dim3((Tq + BQ - 1) / BQ, H, N), THREADS, bytes, stream>>>(
      q, k, v, mask, m_in, d_in, a_in, gm, gd, ga, dq, dm, dd, da, rowstat,
      H, Tq, Tk, D, scale, mask_vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bu_bwd_dkdv<DP><<<dim3((Tk + BK - 1) / BK, H, N), THREADS, bytes, stream>>>(
      q, k, v, mask, gd, ga, rowstat, dk, dv, H, Tq, Tk, D, scale,
      mask_vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every operand float32 and contiguous, the mask int8 [N,Tq,Tk]; q, k, v
// and ga 16-byte aligned. q/dq [N,H,Tq,D], k/v/dk/dv [N,H,Tk,D],
// m/denom/gm/gd/dm/dd [N,H,Tq,1], acc/ga/da [N,H,Tq,D], rowstat [N,H,Tq,3]
// scratch. Two launches on `stream`. Returns a cudaError_t.
int block_update_bwd(const void* q, const void* k, const void* v,
                     const void* mask, const void* m_in, const void* d_in,
                     const void* a_in, const void* gm, const void* gd,
                     const void* ga, void* dq, void* dk, void* dv, void* dm,
                     void* dd, void* da, void* rowstat, int N, int H, int Tq,
                     int Tk, int D, float scale, void* stream) {
  if (D < 8 || D > MAX_D || D % 8 != 0 || N < 1 || N > 65535 || H < 1 ||
      H > 65535 || Tq < 1 || Tk < 1)
    return (int)cudaErrorInvalidValue;
  const uintptr_t staged = reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) |
                           reinterpret_cast<uintptr_t>(ga);
  if (staged % 16 != 0) return (int)cudaErrorMisalignedAddress;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const int8_t* mk = static_cast<const int8_t*>(mask);
  const bool vec = Tk % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      D <= 64 ? launch<64>(f(q), f(k), f(v), mk, f(m_in), f(d_in), f(a_in),
                           f(gm), f(gd), f(ga), o(dq), o(dk), o(dv), o(dm),
                           o(dd), o(da), o(rowstat), N, H, Tq, Tk, D, scale,
                           vec, st)
              : launch<128>(f(q), f(k), f(v), mk, f(m_in), f(d_in),
                            f(a_in), f(gm), f(gd), f(ga), o(dq), o(dk),
                            o(dv), o(dm), o(dd), o(da), o(rowstat), N, H, Tq,
                            Tk, D, scale, vec, st);
  return (int)e;
}

}  // extern "C"
