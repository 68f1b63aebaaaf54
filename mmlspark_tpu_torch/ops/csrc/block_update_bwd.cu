// The backward of the ring-hop block update for Hopper (sm_90a): the
// gradients of one online-softmax update of a carried (m, denom, acc) over a
// whole K/V block, f32 throughout.
//
// The JAX package has no backward kernel here: its training differentiates
// mmlspark_tpu/ops/pallas/attention.py:_online_update (:59) with jax.vjp
// through XLA. This file is that vjp in closed form. Per (n, h) and query
// row i, with keys j of the block, keep_ij from the shared [N,Tq,Tk] mask:
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
// autograd gives NaN for dm_i (exp(-inf - -inf) in the where branch not
// taken, times 0) and 0 for everything else of the row; so does this file.
// Such a row's dm'_i never reaches dq or dk: it has no kept key to take b's
// share.
//
// Design: two launches, deterministic (no float atomics: two launches on one
// input give the same bits), recompute only (nothing of the forward kept but
// its inputs), the split of a flash-attention backward:
//
// 1. bu_bwd_dq, one block per (n, h, 64-row query tile). Pass 1 walks the
//    key stripes for each row's b_i. Pass 2 walks them again, recomputes s
//    and p, forms dp from gA and v, and accumulates sum_j p dp, sum_j p dp
//    k_j, and per row the count and the sum of the keys that tie at b_i
//    (a 64-bit mask per row and stripe, from warp ballots). It writes dq
//    (with b's share), dm, dD, dA and, per row, (m'_i, b_i, t_i) for launch
//    2, t_i being the share of b_i's gradient each tied key takes.
// 2. bu_bwd_dkdv, one block per (n, h, 64-key tile), its K/V rows resident.
//    It walks the query tiles in order, recomputes s and p the same way,
//    adds t_i where s_ij == b_i, and accumulates dk and dv in registers;
//    each is written once.
//
// Both launches compute s_ij with the same code (dot_tile: one fmaf chain
// from 0 over d ascending, then one multiply by the scale), so the tie test
// of launch 2 sees launch 1's b_i bit for bit.
//
// Skipping: a (query tile, key stripe) pair in which no row keeps any key is
// skipped in both launches. This is exact: every p of the pair is 0 and no
// key of it is kept, so none takes a share of b_i. On the ring this skips
// the causal-future hops and pad-only blocks, as the forward does.
//
// What bounds it on an H100 (N=32, H=12, Tq=Tk=256, D=64): it must read q,
// k, v, the carry, the three cotangents and the mask and write dq, dk, dv
// and the carry's gradients, about 231 MB or 69 us at 3.35 TB/s, while the
// function does 10*H*D f32 operations per kept (query, key) pair (five
// products: s, dp, dq, dk, dv), 103 us a hop at 67 TFLOP/s over the kept
// pairs of the ring's first batch: so the floor is the f32 operations. This
// first design runs every product with f32 FMAs on CUDA cores from shared
// memory, as block_update.cu's forward does, and does more than that floor:
// s three times (launch 1 twice, launch 2 once) and dp twice, 16 units of
// H*D per kept pair against the function's 10. Tensor cores (a precision
// scheme shared with the forward) are later work.
//
// Layout: every operand is contiguous f32 (the mask int8), D <= 128 with
// D % 8 == 0, any Tq and Tk. The kernel allocates nothing; the caller
// passes the outputs, the [N,H,Tq,3] f32 row scratch and the stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per stripe
constexpr int THREADS = 256;  // 16 row groups of 4 rows x 16 lanes
constexpr int MAX_D = 128;

// finite: neither +-inf nor NaN (the plain version's isfinite)
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

// s[j][i] = sum_d a[(r0 + j) * ld + d] * b[(lane + 16 i) * ld + d]: one
// fmaf chain from 0 over d ascending for every entry. Both launches take
// their scores from here, so the same (row, key) gives the same bits.
__device__ __forceinline__ void dot_tile(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         int ld, int D, int r0, int lane,
                                         float s[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) av[j] = a[(r0 + j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) bv[i] = b[(lane + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = fmaf(av[j], bv[i], s[j][i]);
  }
}

// rows [t0, t0 + 64) of a [T, D] f32 matrix into sm [64][ld]; rows past T
// are zeros
__device__ __forceinline__ void load_rows(float* __restrict__ sm,
                                          const float* __restrict__ g,
                                          int t0, int T, int D, int ld) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int t = t0 + r;
    sm[r * ld + d] = t < T ? g[(size_t)t * D + d] : 0.f;
  }
}

// the keep sub-tile of query rows [q0, q0 + BQ) and keys [k0, k0 + BK) into
// ks [BQ][BK] (0 past the edges); true when some entry is kept. Ends with a
// barrier, so every thread sees the same answer.
__device__ __forceinline__ bool load_keep(int8_t* __restrict__ ks,
                                          const int8_t* __restrict__ mp,
                                          int q0, int Tq, int k0, int Tk) {
  bool any = false;
  for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
    const int r = i / BK, c = i - r * BK;
    const int tq = q0 + r, tk = k0 + c;
    const int8_t kk =
        (tq < Tq && tk < Tk) ? mp[(size_t)tq * Tk + tk] : (int8_t)0;
    ks[i] = kk;
    any |= kk != 0;
  }
  return __syncthreads_or(any) != 0;
}

// sum over the 16 lanes of a row group, in a fixed butterfly: every lane
// ends with the same bits (each step adds the same two values)
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ inline size_t dq_smem_bytes(int d) {
  return ((size_t)4 * 64 * (d + 1) + (size_t)BQ * (BK + 1)) * sizeof(float) +
         (size_t)BQ * BK;
}
__host__ __device__ inline size_t dkdv_smem_bytes(int d) {
  return ((size_t)4 * 64 * (d + 1) + (size_t)2 * BQ * (BK + 1) + 4 * BQ) *
             sizeof(float) +
         (size_t)BQ * BK;
}

// Launch 1. Thread -> rows rg*4 + j of the tile, score keys lane + 16 i of
// a stripe, output columns lane + 16 i (i < DPT).
template <int DPT>
__global__ void __launch_bounds__(THREADS)
bu_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int8_t* __restrict__ mask,
          const float* __restrict__ m_in, const float* __restrict__ d_in,
          const float* __restrict__ a_in, const float* __restrict__ gm,
          const float* __restrict__ gd, const float* __restrict__ ga,
          float* __restrict__ dq, float* __restrict__ dm,
          float* __restrict__ dd, float* __restrict__ da,
          float* __restrict__ rowstat, int H, int Tq, int Tk, int D,
          float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;               // [BQ][ld] q rows
  float* gas = qs + BQ * ld;      // [BQ][ld] gA rows
  float* ks = gas + BQ * ld;      // [BK][ld] key stripe
  float* vs = ks + BK * ld;       // [BK][ld] value stripe
  float* ss = vs + BK * ld;       // [BQ][BK+1] p * dp of the stripe
  int8_t* keep_s = reinterpret_cast<int8_t*>(ss + BQ * (BK + 1));

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const size_t nh = (size_t)n * H + h;
  const float* kp = k + nh * Tk * D;
  const float* vp = v + nh * Tk * D;
  const int8_t* mp = mask + (size_t)n * Tq * Tk;

  load_rows(qs, q + nh * Tq * D, q0, Tq, D, ld);
  load_rows(gas, ga + nh * Tq * D, q0, Tq, D, ld);

  const int rg = tid >> 4;
  const int lane = tid & 15;
  const int half = (tid >> 4) & 1;  // which 16 lanes of the warp
  float mr[4], gdr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = q0 + rg * 4 + j;
    mr[j] = t < Tq ? m_in[nh * Tq + t] : -INFINITY;
    gdr[j] = t < Tq ? gd[nh * Tq + t] : 0.f;
  }

  // pass 1: b_i, the largest kept score of each row
  float b[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the previous stripe's readers are done
    if (!load_keep(keep_s, mp, q0, Tq, k0, Tk)) continue;  // exact skip
    load_rows(ks, kp, k0, Tk, D, ld);
    __syncthreads();
    float s[4][4];
    dot_tile(qs, ks, ld, D, rg * 4, lane, s);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (keep_s[(rg * 4 + j) * BK + lane + 16 * i] != 0)
          b[j] = fmaxf(b[j], s[j][i] * scale);
  }
  float mn[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      b[j] = fmaxf(b[j], __shfl_xor_sync(0xffffffffu, b[j], o));
    mn[j] = fmaxf(mr[j], b[j]);
  }

  // pass 2: sum_j p dp, sum_j p dp k_j, and the keys tied at b_i
  float acc[4][DPT], kt[4][DPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[j][i] = kt[j][i] = 0.f;
  float psum[4] = {0.f, 0.f, 0.f, 0.f};
  float cnt[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();
    if (!load_keep(keep_s, mp, q0, Tq, k0, Tk)) continue;  // exact skip
    load_rows(ks, kp, k0, Tk, D, ld);
    load_rows(vs, vp, k0, Tk, D, ld);
    __syncthreads();
    float s[4][4], g[4][4];
    dot_tile(qs, ks, ld, D, rg * 4, lane, s);
    dot_tile(gas, vs, ld, D, rg * 4, lane, g);
    unsigned long long tmask[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rg * 4 + j;
      tmask[j] = 0ull;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 16 * i;
        const bool kept = keep_s[r * BK + c] != 0;
        const float sc = s[j][i] * scale;
        const float p = kept ? expf(sc - mn[j]) : 0.f;
        const float ds = p * (g[j][i] + gdr[j]);
        psum[j] += ds;
        const bool tie = kept && sc == b[j];
        cnt[j] += tie ? 1.f : 0.f;
        ss[r * (BK + 1) + c] = ds;
        // bit c of the row's mask: lane + 16 i of this row group's half
        const unsigned bal = __ballot_sync(0xffffffffu, tie);
        tmask[j] |= (unsigned long long)((bal >> (16 * half)) & 0xffffu)
                    << (16 * i);
      }
    }
    __syncthreads();
    const int kn = min(BK, Tk - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = ss[(rg * 4 + j) * (BK + 1) + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = lane + 16 * i;
        if (d < D) {
          const float kv = ks[c * ld + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j][i] = fmaf(pv[j], kv, acc[j][i]);
        }
      }
    }
    // the tied keys, in key order (almost always the row's one argmax)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned long long mk = tmask[j];
      while (mk) {
        const int c = __ffsll((long long)mk) - 1;
        mk &= mk - 1;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          const int d = lane + 16 * i;
          if (d < D) kt[j][i] += ks[c * ld + d];
        }
      }
    }
  }

  // the rows: c, dc, dm', the max's split, and the outputs
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = rg * 4 + j;
    const int t = q0 + r;
    const bool in = t < Tq;
    const size_t row = nh * Tq + (in ? t : 0);
    float dcp = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane + 16 * i;
      if (in && d < D) dcp = fmaf(gas[r * ld + d], a_in[row * D + d], dcp);
    }
    dcp = lanes_sum(dcp);
    const float ps = lanes_sum(psum[j]);
    const float nt = lanes_sum(cnt[j]);
    if (!in) continue;
    const float dc = fmaf(gdr[j], d_in[row], dcp);
    const float c = finite(mr[j]) ? expf(mr[j] - mn[j]) : 0.f;
    const float cdc = c * dc;
    const float dmn = gm[row] - cdc - ps;
    float sm, sb;
    if (mr[j] > b[j]) {
      sm = dmn;
      sb = 0.f;
    } else if (b[j] > mr[j]) {
      sm = 0.f;
      sb = dmn;
    } else {
      sm = sb = 0.5f * dmn;
    }
    const float share = nt > 0.f ? sb / nt : 0.f;
    if (lane == 0) {
      dm[row] = finite(mn[j]) ? cdc + sm : __int_as_float(0x7fc00000);
      dd[row] = c * gdr[j];
      rowstat[row * 3 + 0] = mn[j];
      rowstat[row * 3 + 1] = b[j];
      rowstat[row * 3 + 2] = share;
    }
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane + 16 * i;
      if (d < D) {
        dq[row * D + d] = scale * fmaf(share, kt[j][i], acc[j][i]);
        da[row * D + d] = c * gas[r * ld + d];
      }
    }
  }
}

// Launch 2. Scores as launch 1 (rows rg*4 + j of the query tile, keys
// lane + 16 i of this block's key tile); then thread -> keys rg*4 + j of the
// tile and columns lane + 16 i (i < DPT) for dk and dv.
template <int DPT>
__global__ void __launch_bounds__(THREADS)
bu_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int8_t* __restrict__ mask,
            const float* __restrict__ gd, const float* __restrict__ ga,
            const float* __restrict__ rowstat, float* __restrict__ dk,
            float* __restrict__ dv, int H, int Tq, int Tk, int D,
            float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;               // [BK][ld] this block's keys
  float* vs = ks + BK * ld;       // [BK][ld] and values
  float* qs = vs + BK * ld;       // [BQ][ld] q rows of the query tile
  float* gas = qs + BQ * ld;      // [BQ][ld] gA rows
  float* ps = gas + BQ * ld;      // [BQ][BK+1] p
  float* dss = ps + BQ * (BK + 1);  // [BQ][BK+1] ds
  float* rmn = dss + BQ * (BK + 1);  // [BQ] m'
  float* rb = rmn + BQ;           // [BQ] b
  float* rt = rb + BQ;            // [BQ] each tied key's share
  float* rgd = rt + BQ;           // [BQ] gD
  int8_t* keep_s = reinterpret_cast<int8_t*>(rgd + BQ);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const size_t nh = (size_t)n * H + h;
  const float* qp = q + nh * Tq * D;
  const float* gap = ga + nh * Tq * D;
  const int8_t* mp = mask + (size_t)n * Tq * Tk;

  load_rows(ks, k + nh * Tk * D, k0, Tk, D, ld);
  load_rows(vs, v + nh * Tk * D, k0, Tk, D, ld);

  const int rg = tid >> 4;
  const int lane = tid & 15;
  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < DPT; ++i) dka[j][i] = dva[j][i] = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    if (!load_keep(keep_s, mp, q0, Tq, k0, Tk)) continue;  // exact skip
    load_rows(qs, qp, q0, Tq, D, ld);
    load_rows(gas, gap, q0, Tq, D, ld);
    if (tid < BQ) {
      const int t = q0 + tid;
      const bool in = t < Tq;
      const size_t row = nh * Tq + (in ? t : 0);
      rmn[tid] = in ? rowstat[row * 3 + 0] : -INFINITY;
      rb[tid] = in ? rowstat[row * 3 + 1] : -INFINITY;
      rt[tid] = in ? rowstat[row * 3 + 2] : 0.f;
      rgd[tid] = in ? gd[row] : 0.f;
    }
    __syncthreads();
    float s[4][4], g[4][4];
    dot_tile(qs, ks, ld, D, rg * 4, lane, s);
    dot_tile(gas, vs, ld, D, rg * 4, lane, g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rg * 4 + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 16 * i;
        const bool kept = keep_s[r * BK + c] != 0;
        const float sc = s[j][i] * scale;
        const float p = kept ? expf(sc - rmn[r]) : 0.f;
        float ds = p * (g[j][i] + rgd[r]);
        if (kept && sc == rb[r]) ds += rt[r];
        ps[r * (BK + 1) + c] = p;
        dss[r * (BK + 1) + c] = ds;
      }
    }
    __syncthreads();
    const int qn = min(BQ, Tq - q0);
    for (int r = 0; r < qn; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pv[j] = ps[r * (BK + 1) + rg * 4 + j];
        dsv[j] = dss[r * (BK + 1) + rg * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = lane + 16 * i;
        if (d < D) {
          const float gv = gas[r * ld + d];
          const float qv = qs[r * ld + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dva[j][i] = fmaf(pv[j], gv, dva[j][i]);
            dka[j][i] = fmaf(dsv[j], qv, dka[j][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = k0 + rg * 4 + j;
    if (t >= Tk) continue;
    const size_t row = nh * Tk + t;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane + 16 * i;
      if (d < D) {
        dk[row * D + d] = scale * dka[j][i];
        dv[row * D + d] = dva[j][i];
      }
    }
  }
}

template <int DPT>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int8_t* mask, const float* m_in, const float* d_in,
                   const float* a_in, const float* gm, const float* gd,
                   const float* ga, float* dq, float* dk, float* dv,
                   float* dm, float* dd, float* da, float* rowstat, int N,
                   int H, int Tq, int Tk, int D, float scale,
                   cudaStream_t stream) {
  const size_t s1 = dq_smem_bytes(D), s2 = dkdv_smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      bu_bwd_dq<DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bu_bwd_dkdv<DPT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)s2);
  if (e != cudaSuccess) return e;
  bu_bwd_dq<DPT><<<dim3((Tq + BQ - 1) / BQ, H, N), THREADS, s1, stream>>>(
      q, k, v, mask, m_in, d_in, a_in, gm, gd, ga, dq, dm, dd, da, rowstat,
      H, Tq, Tk, D, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bu_bwd_dkdv<DPT><<<dim3((Tk + BK - 1) / BK, H, N), THREADS, s2, stream>>>(
      q, k, v, mask, gd, ga, rowstat, dk, dv, H, Tq, Tk, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every operand float32 and contiguous, the mask int8 [N,Tq,Tk]. q/dq
// [N,H,Tq,D], k/v/dk/dv [N,H,Tk,D], m/denom/gm/gd/dm/dd [N,H,Tq,1],
// acc/ga/da [N,H,Tq,D], rowstat [N,H,Tq,3] scratch. Two launches on
// `stream`. Returns a cudaError_t.
int block_update_bwd(const void* q, const void* k, const void* v,
                     const void* mask, const void* m_in, const void* d_in,
                     const void* a_in, const void* gm, const void* gd,
                     const void* ga, void* dq, void* dk, void* dv, void* dm,
                     void* dd, void* da, void* rowstat, int N, int H, int Tq,
                     int Tk, int D, float scale, void* stream) {
  if (D < 8 || D > MAX_D || D % 8 != 0 || N < 1 || N > 65535 || H < 1 ||
      H > 65535 || Tq < 1 || Tk < 1)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const int8_t* mk = static_cast<const int8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      D <= 64 ? launch<4>(f(q), f(k), f(v), mk, f(m_in), f(d_in), f(a_in),
                          f(gm), f(gd), f(ga), o(dq), o(dk), o(dv), o(dm),
                          o(dd), o(da), o(rowstat), N, H, Tq, Tk, D, scale,
                          st)
              : launch<8>(f(q), f(k), f(v), mk, f(m_in), f(d_in), f(a_in),
                          f(gm), f(gd), f(ga), o(dq), o(dk), o(dv), o(dm),
                          o(dd), o(da), o(rowstat), N, H, Tq, Tk, D, scale,
                          st);
  return (int)e;
}

}  // extern "C"
