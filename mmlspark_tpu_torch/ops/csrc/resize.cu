// Fused per-sample crop -> align-corners bilinear resize -> scale, for
// Hopper (sm_90a): uint8 [N,H,W,C] in, float32 [N,OH,OW,C] out.
//
// Replaces mmlspark_tpu/ops/pallas/resize.py:_pallas_call (the Pallas
// kernel _kernel behind fused_resize_norm). Same function: sample n takes
// the (ch, cw) window at (oy[n], ox[n]), placed as jax.lax.dynamic_slice
// places a start index (a negative start counts from the end of its axis,
// then the start is clamped into the image); output pixel (i, j) blends
// the four taps at window rows y0[i], y1[i] and columns x0[j], x1[j] with
// the weights w00..w11[i, j], as v00*w00 + v01*w01 + v10*w10 + v11*w11
// (left-associated), then multiplies by scale. The taps and weights come
// from the caller, computed once per geometry in numpy float32 (_grids),
// so every implementation uses bit-identical constants. Each product and
// sum is rounded on its own (__fmul_rn/__fadd_rn, no FMA contraction), so
// the result equals the plain PyTorch version's bit for bit.
//
// The Pallas kernel reads a whole sample into VMEM (grid over samples).
// Here one thread takes one output pixel (n, i, j) and all C channels:
// there is no reduction, only a gather, so nothing needs shared memory.
//
// What bounds it on an H100: reading the uint8 windows once and writing
// the f32 output once (at N=64, 240^2 windows of a 256^2 source, 224^2
// out, C=3: 11.1 MB + 38.5 MB, about 15 us at 3.35 TB/s). The taps of
// neighbouring output pixels overlap, so the gathers are served mostly
// from L1/L2; the 12-byte writes of a pixel's three channels make each
// warp's stores contiguous.
//
// The kernel allocates nothing: the caller passes the output and the
// stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void resize_kernel(const uint8_t* __restrict__ x,
                              const int* __restrict__ oy,
                              const int* __restrict__ ox,
                              const int* __restrict__ yidx,  // [2, OH]
                              const int* __restrict__ xidx,  // [2, OW]
                              const float* __restrict__ w,   // [4, OH, OW]
                              float* __restrict__ out, int N, int H, int W,
                              int C, int ch, int cw, int OH, int OW,
                              float scale) {
  const int total = N * OH * OW;  // < 2^31, checked by the caller
  const int plane = OH * OW;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < total;
       p += gridDim.x * blockDim.x) {
    const int n = p / plane;
    const int ij = p - n * plane;
    const int i = ij / OW;
    const int j = ij - i * OW;
    const int sy = oy[n] < 0 ? oy[n] + H : oy[n];
    const int sx = ox[n] < 0 ? ox[n] + W : ox[n];
    const int top = min(max(sy, 0), H - ch);
    const int left = min(max(sx, 0), W - cw);
    const int ya = top + yidx[i], yb = top + yidx[OH + i];
    const int xa = left + xidx[j], xb = left + xidx[OW + j];
    const uint8_t* img = x + (size_t)n * H * W * C;
    const uint8_t* p00 = img + ((size_t)ya * W + xa) * C;
    const uint8_t* p01 = img + ((size_t)ya * W + xb) * C;
    const uint8_t* p10 = img + ((size_t)yb * W + xa) * C;
    const uint8_t* p11 = img + ((size_t)yb * W + xb) * C;
    const float w00 = w[ij], w01 = w[plane + ij];
    const float w10 = w[2 * plane + ij], w11 = w[3 * plane + ij];
    float* o = out + (size_t)p * C;
    for (int c = 0; c < C; ++c) {
      float v = __fmul_rn((float)p00[c], w00);
      v = __fadd_rn(v, __fmul_rn((float)p01[c], w01));
      v = __fadd_rn(v, __fmul_rn((float)p10[c], w10));
      v = __fadd_rn(v, __fmul_rn((float)p11[c], w11));
      o[c] = __fmul_rn(v, scale);
    }
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched).
extern "C" int fused_resize_norm_fwd(const uint8_t* x, const int* oy,
                                     const int* ox, const int* yidx,
                                     const int* xidx, const float* w,
                                     float* out, int N, int H, int W, int C,
                                     int ch, int cw, int OH, int OW,
                                     int threads, float scale,
                                     void* stream) {
  const long long total = (long long)N * OH * OW;
  if (total == 0) return 0;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65535 * 8 ? want : 65535 * 8);
  resize_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, oy, ox, yidx, xidx, w, out, N, H, W, C, ch, cw, OH, OW, scale);
  return (int)cudaGetLastError();
}
