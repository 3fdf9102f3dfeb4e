// K1: Farneback matrix update with an exact bilinear warp, for Hopper (sm_90a).
//
// Replaces the Pallas kernel relaxtpu/ops/warp.py::_warp_kernel (launched by
// warp_planes_banded_pallas) together with the elementwise tail of
// relaxtpu/ops/flow.py::_update_matrices.  On the TPU, Mosaic cannot
// gather, so the warp there is a banded one-hot bf16 hi/lo matmul that is
// exact only inside its band and clamps beyond it.  Hopper gathers, so this
// kernel reads the four bilinear corners directly and is exact for any flow:
// it computes _update_matrices(..., warp="exact") (flow.py:179-268).
//
// What bounds it on the card: bytes.  Per pixel it reads r0 (5 planes), the
// four corners of r1 (5 planes; the corners of neighbouring threads overlap,
// so device memory sees about one read of r1), the flow (2) and writes M (5):
// 17 f32 values against ~70 flops, far below the H100's ~20 flops per byte.
// Design: one thread per output pixel over a (pixels, pairs) grid, so
// neighbouring threads touch neighbouring addresses of every plane; the
// warp, the inside mask, the averaging, the flow terms, the border taper and
// the five products are fused into this one launch, and only M is written.
// Corner gathers are left to L1/L2; staging tiles in shared memory (TMA)
// is later work.

#include <cuda_runtime.h>

namespace {

// Border confidence taper of flow.py::_border_scale for index i of n.
__device__ __forceinline__ float taper(int i, int n) {
  const float ramp[5] = {0.14f, 0.14f, 0.4472f, 0.4472f, 0.4472f};
  const int m = n < 5 ? n : 5;
  float s = 1.0f;
  if (i < m) s *= ramp[i];
  if (i >= n - m) s *= ramp[n - 1 - i];
  return s;
}

__global__ void update_matrices_kernel(const float* __restrict__ r0,
                                       const float* __restrict__ r1,
                                       const float* __restrict__ flow,
                                       float* __restrict__ m, int H, int W) {
  const long long hw = (long long)H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hw) return;
  const long long p = blockIdx.y;
  const float* a = r0 + p * 5 * hw;
  const float* b = r1 + p * 5 * hw;
  const float* f = flow + p * 2 * hw;
  float* out = m + p * 5 * hw;

  const int y = (int)(idx / W);
  const int x = (int)(idx - (long long)y * W);
  const float dx = f[idx];
  const float dy = f[hw + idx];
  const float fx = (float)x + dx;
  const float fy = (float)y + dy;
  const float x1 = floorf(fx);
  const float y1 = floorf(fy);
  const float tx = fx - x1;
  const float ty = fy - y1;
  // the mask uses the unclipped floor; the corners are clipped
  const bool inside =
      x1 >= 0.0f && x1 <= (float)(W - 2) && y1 >= 0.0f && y1 <= (float)(H - 2);
  const int xi = (int)fminf(fmaxf(x1, 0.0f), (float)(W - 2));
  const int yi = (int)fminf(fmaxf(y1, 0.0f), (float)(H - 2));
  const float a00 = (1.0f - tx) * (1.0f - ty);
  const float a01 = tx * (1.0f - ty);
  const float a10 = (1.0f - tx) * ty;
  const float a11 = tx * ty;
  const long long c00 = (long long)yi * W + xi;

  float w[5], r[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* bc = b + c * hw;
    w[c] = a00 * bc[c00] + a01 * bc[c00 + 1] + a10 * bc[c00 + W] + a11 * bc[c00 + W + 1];
    r[c] = a[c * hw + idx];
  }

  float r2, r3, r4, r5, r6;
  if (inside) {
    r2 = (r[0] - w[0]) * 0.5f;
    r3 = (r[1] - w[1]) * 0.5f;
    r4 = (r[2] + w[2]) * 0.5f;
    r5 = (r[3] + w[3]) * 0.5f;
    r6 = (r[4] + w[4]) * 0.25f;
  } else {
    r2 = r[0] * 0.5f;
    r3 = r[1] * 0.5f;
    r4 = r[2];
    r5 = r[3];
    r6 = r[4] * 0.5f;
  }
  r2 = r2 + r4 * dy + r6 * dx;
  r3 = r3 + r6 * dy + r5 * dx;

  const float s = taper(y, H) * taper(x, W);
  r2 *= s;
  r3 *= s;
  r4 *= s;
  r5 *= s;
  r6 *= s;

  out[idx] = r4 * r4 + r6 * r6;
  out[hw + idx] = (r4 + r5) * r6;
  out[2 * hw + idx] = r5 * r5 + r6 * r6;
  out[3 * hw + idx] = r4 * r2 + r6 * r3;
  out[4 * hw + idx] = r6 * r2 + r5 * r3;
}

}  // namespace

// r0, r1: (P, 5, H, W) f32; flow: (P, 2, H, W) f32; m: (P, 5, H, W) f32.
extern "C" int relax_update_matrices(const void* r0, const void* r1, const void* flow,
                                     void* m, int P, int H, int W, void* stream) {
  const int threads = 256;
  const long long hw = (long long)H * W;
  dim3 grid((unsigned)((hw + threads - 1) / threads), (unsigned)P);
  update_matrices_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)r0, (const float*)r1, (const float*)flow, (float*)m, H, W);
  return (int)cudaGetLastError();
}
