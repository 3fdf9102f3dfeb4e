// K2: fused box blur and 2x2 flow solve, for Hopper (sm_90a).
//
// Replaces the Pallas kernel relaxtpu/ops/boxsolve.py::_box_solve_kernel
// (launched by box_blur_solve_pallas), which computes
// relaxtpu/ops/flow.py::_update_flow: a winsize x winsize replicate-border
// box sum of M = [G11, G12, G22, h1, h2], times 1/winsize^2, then per pixel
//   idet = 1 / (G11*G22 - G12^2 + 1e-3)
//   dx = (G11*h2 - G12*h1) * idet,  dy = (G22*h1 - G12*h2) * idet.
//
// What bounds it on the card: bytes.  It must read 5 planes and write 2
// (28 bytes a pixel) against ~160 flops a pixel with direct sums.
// Design: one block per (pair, 16-row slab, 64-column tile).  A full 540p
// row slab of five planes with its halo would not fit in shared memory, so
// the slab is cut into column tiles and the planes go through shared memory
// one at a time: each plane's tile plus an r-pixel halo on every side
// (rows and columns clamped: the replicate border), a vertical direct sum
// into a second shared buffer, a horizontal direct sum into registers.  The
// five box sums of a pixel stay in registers, the solve runs there, and only
// the two flow planes are written.  Halo re-reads are served by L2.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 64;      // tile columns = threads in x
constexpr int TY = 4;       // threads in y
constexpr int TH = 16;      // tile rows
constexpr int RPT = TH / TY;  // rows per thread

__global__ void box_blur_solve_kernel(const float* __restrict__ m, float* __restrict__ out,
                                      int H, int W, int r, float inv_area) {
  extern __shared__ float smem[];
  const int sw = TW + 2 * r;
  const int sh = TH + 2 * r;
  float* tile = smem;           // sh x sw
  float* vsum = smem + sh * sw; // TH x sw

  const long long hw = (long long)H * W;
  const long long p = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthreads = TW * TY;

  float acc[5][RPT];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* plane = m + (p * 5 + c) * hw;
    for (int i = tid; i < sh * sw; i += nthreads) {
      const int ty = i / sw;
      const int tx = i - ty * sw;
      const int gy = min(max(y0 - r + ty, 0), H - 1);
      const int gx = min(max(x0 - r + tx, 0), W - 1);
      tile[i] = plane[(long long)gy * W + gx];
    }
    __syncthreads();
    for (int i = tid; i < TH * sw; i += nthreads) {
      const int ty = i / sw;
      const int tx = i - ty * sw;
      float s = tile[ty * sw + tx];
      for (int d = 1; d <= 2 * r; ++d) s += tile[(ty + d) * sw + tx];
      vsum[i] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const float* row = vsum + (threadIdx.y + TY * k) * sw + threadIdx.x;
      float s = row[0];
      for (int d = 1; d <= 2 * r; ++d) s += row[d];
      acc[c][k] = s;
    }
    __syncthreads();
  }

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int y = y0 + threadIdx.y + TY * k;
    if (y >= H) continue;
    const float g11 = acc[0][k] * inv_area;
    const float g12 = acc[1][k] * inv_area;
    const float g22 = acc[2][k] * inv_area;
    const float h1 = acc[3][k] * inv_area;
    const float h2 = acc[4][k] * inv_area;
    const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
    const long long o = (long long)y * W + x;
    out[p * 2 * hw + o] = (g11 * h2 - g12 * h1) * idet;
    out[p * 2 * hw + hw + o] = (g22 * h1 - g12 * h2) * idet;
  }
}

}  // namespace

// m: (P, 5, H, W) f32 -> flow: (P, 2, H, W) f32; winsize odd.
extern "C" int relax_box_blur_solve(const void* m, void* flow, int P, int H, int W,
                                    int winsize, void* stream) {
  const int r = winsize / 2;
  const size_t smem = sizeof(float) * (size_t)((TH + 2 * r) + TH) * (TW + 2 * r);
  dim3 grid((unsigned)((W + TW - 1) / TW), (unsigned)((H + TH - 1) / TH), (unsigned)P);
  dim3 block(TW, TY);
  box_blur_solve_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)m, (float*)flow, H, W, r, 1.0f / (float)(winsize * winsize));
  return (int)cudaGetLastError();
}
