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
// (28 bytes a pixel) against ~155 flops a pixel with direct sums.  On this
// card the L2-to-SM path, not only device memory, runs near that rate, so
// every re-read of a halo row costs about what a first read does.  The sums
// stay direct and in the plain version's tap order (vertical, then
// horizontal): running add/subtract sums would drift, and the solve
// amplifies drift where the system is ill-conditioned.  Design:
// - one block of 256 threads per (pair, strip of 112 or 128 columns, run
//   of rows): it walks down its rows 8 output rows at a time, keeping each
//   plane's input rows in a 32-row ring in shared memory (5 x 32 x 128 or
//   144 floats, 90-100 KB, so two blocks share an SM), so every input row
//   is read once per run: the halo read is 1.13x across and ~1.1x down,
//   where 32 x 128 tiles would read 1.6x;
// - the run length is chosen at launch so the grid fills whole waves of
//   resident blocks;
// - rows arrive by 16-byte cp.async over the aligned span (4-byte copies,
//   clamped, only at the image's edges or for widths that are not a
//   multiple of 4), one step ahead;
// - vertical sums: a thread holds a column's (or half a column's) inputs in
//   registers and forms its sums from them (2.75 to 4.5 shared loads an
//   output, not 15);
// - horizontal sums: a thread forms 4 consecutive outputs of a row from 20
//   values read as five 16-byte loads, a warp covering 128 of a row;
// - the five box sums of a pixel stay in registers, the solve runs there
//   with products rounded as the plain version rounds them, and only the
//   two flow planes are written, a warp storing 512 contiguous bytes.
//
// Windows above 17 (box_blur_solve_pallas takes any odd winsize; the strip
// kernel's halo holds a radius of at most 8) take a generic-radius pair of
// kernels: a vertical clamped-row box sum of the five planes into a scratch
// buffer the wrapper allocates, then a horizontal clamped-column sum fused
// with the 1/winsize^2 scale and the 2x2 solve.  The radius is a run-time
// value, so the taps are read from global memory through L1, each once per
// thread, and added into a run of outputs held in registers (16 rows of a
// column in the vertical pass, 4 columns of a row in the horizontal one),
// in the plain version's tap order: the result is the plain version's to
// the bit.  It moves
// 68 bytes a pixel (M read, the scratch written and read, the flow
// written) against the function's 28: simple and right first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int TH = 8;              // output rows a step
constexpr int NT = 256;            // threads a block
constexpr int RMAX = 8;            // largest radius: the span starts 8 columns left
constexpr int RING = 32;           // input rows held per plane: >= 2 TH + 2 RMAX
static_assert(RING >= 2 * TH + 2 * RMAX && (RING & (RING - 1)) == 0, "ring too small");

// A strip of TW output columns stages SW = TW + 16 (the span from x0 - 8).
// TW = 112 spans 128 columns, so the vertical pass takes a (column, half of
// the rows) a thread on all 256 threads; TW = 128 spans 144 and takes a
// column a thread on 144 of them, but wastes fewer columns at widths such
// as 120, 240 and 480.
template <int TW>
struct Strip {
  static constexpr int SW = TW + 2 * RMAX;
  static constexpr int VS = SW + 4;             // vertical-sum row stride
  static constexpr int C4 = SW / 4;             // 16-byte chunks a staged row
  static constexpr int RUNS = TH * TW / 4;      // 4-pixel runs a step: a thread each
  static constexpr bool HALVES = 2 * SW == NT;  // else a column a thread
  static constexpr size_t smem = sizeof(float) * (size_t)(5 * RING * SW + 2 * TH * VS);
  static_assert(RUNS <= NT, "a thread a run");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Ring rows [from, to) of all five planes: ring row r holds image row
// ys - R + r (clamped: the replicate border), columns x0 - 8 .. x0 + SW - 9.
// A thread keeps one 16-byte column chunk and walks rows.
template <int R, int TW>
__device__ __forceinline__ void load_rows(float* ring, const float* m, int p, int H, int W,
                                          int ys, int x0, int from, int to, bool vec) {
  using S = Strip<TW>;
  constexpr int LANES = NT / S::C4;  // threads a row
  const int lane = threadIdx.x / S::C4, cc = 4 * (threadIdx.x % S::C4);
  if (lane >= LANES) return;
  const int gx = x0 - RMAX + cc;
  const bool whole = vec && gx >= 0 && gx + 4 <= W;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* plane = m + ((long long)p * 5 + c) * H * W;
    for (int r = from + lane; r < to; r += LANES) {
      const float* row = plane + (long long)min(max(ys - R + r, 0), H - 1) * W;
      float* dst = ring + (c * RING + (r & (RING - 1))) * S::SW + cc;
      if (whole) {
        cp_async16(dst, row + gx);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(dst + e, row + min(max(gx + e, 0), W - 1));
      }
    }
  }
}

// grid: (strips, runs of ``seg`` rows, pairs)
template <int R, int TW>
__global__ void __launch_bounds__(NT)
box_blur_solve_kernel(const float* __restrict__ m, float* __restrict__ out, int H, int W,
                      int seg, float inv_area, bool vec) {
  using S = Strip<TW>;
  constexpr int SW = S::SW, VS = S::VS, RUNS = S::RUNS;
  extern __shared__ __align__(16) float smem[];
  float* const ring = smem;                  // 5 x RING x SW
  float* const vsum = smem + 5 * RING * SW;  // 2 x TH x VS, alternating planes
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW;
  const int ys = blockIdx.y * seg;
  const int ye = min(ys + seg, H);
  const int p = blockIdx.z;
  const int steps = (ye - ys + TH - 1) / TH;
  const long long hw = (long long)H * W;

  // step k needs ring rows [TH k, TH k + TH + 2R); it brings the last TH
  load_rows<R, TW>(ring, m, p, H, W, ys, x0, 0, TH + 2 * R, vec);
  cp_async_commit();
  for (int k = 0; k < steps; ++k) {
    cp_async_wait_all();
    __syncthreads();  // step k's rows are in; step k - 1 no longer reads the ring
    if (k + 1 < steps) {  // into rows below TH k, which step k does not read
      load_rows<R, TW>(ring, m, p, H, W, ys, x0, TH * (k + 1) + 2 * R, TH * (k + 2) + 2 * R, vec);
      cp_async_commit();
    }

    float acc[5][4];  // this thread's run: the five box sums of 4 pixels
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      float* const vs = vsum + (c & 1) * TH * VS;
      // vertical: a thread a column (or a column's half of the rows), its
      // inputs in registers
      constexpr int VR = S::HALVES ? TH / 2 : TH;
      if (S::HALVES || tid < SW) {
        const int col = tid % SW, y0 = VR * (tid / SW);
        const float* src = ring + c * RING * SW + col;
        float w[VR + 2 * R], s[VR];
#pragma unroll
        for (int r = 0; r < VR + 2 * R; ++r) w[r] = src[((TH * k + y0 + r) & (RING - 1)) * SW];
        // each sum in tap order; the VR independent chains interleave
#pragma unroll
        for (int y = 0; y < VR; ++y) s[y] = w[y];
#pragma unroll
        for (int d = 1; d <= 2 * R; ++d)
#pragma unroll
          for (int y = 0; y < VR; ++y) s[y] += w[y + d];
#pragma unroll
        for (int y = 0; y < VR; ++y) vs[(y0 + y) * VS + col] = s[y];
      }
      __syncthreads();  // also: plane c - 1's horizontal is done with the other buffer
      if (tid < RUNS) {  // horizontal: 4 outputs of a row from 20 values
        const float* row = vs + (tid / (TW / 4)) * VS + 4 * (tid % (TW / 4));
        float w[20];
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          const float4 f = *reinterpret_cast<const float4*>(row + 4 * q);
          w[4 * q] = f.x;
          w[4 * q + 1] = f.y;
          w[4 * q + 2] = f.z;
          w[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] = w[RMAX - R + i];
#pragma unroll
        for (int d = 1; d <= 2 * R; ++d)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[c][i] += w[RMAX - R + i + d];
      }
    }

    const int y = ys + TH * k + tid / (TW / 4);
    const int xb = x0 + 4 * (tid % (TW / 4));
    if (tid >= RUNS || y >= ye) continue;
    float dx[4], dy[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the plain version's roundings: no contraction into FMAs
      const float g11 = __fmul_rn(acc[0][i], inv_area);
      const float g12 = __fmul_rn(acc[1][i], inv_area);
      const float g22 = __fmul_rn(acc[2][i], inv_area);
      const float h1 = __fmul_rn(acc[3][i], inv_area);
      const float h2 = __fmul_rn(acc[4][i], inv_area);
      const float idet = 1.0f / (__fmul_rn(g11, g22) - __fmul_rn(g12, g12) + 1e-3f);
      dx[i] = __fmul_rn(__fmul_rn(g11, h2) - __fmul_rn(g12, h1), idet);
      dy[i] = __fmul_rn(__fmul_rn(g22, h1) - __fmul_rn(g12, h2), idet);
    }
    float* ox = out + (long long)p * 2 * hw + (long long)y * W + xb;
    float* oy = ox + hw;
    if (vec && xb + 4 <= W) {
      *reinterpret_cast<float4*>(ox) = make_float4(dx[0], dx[1], dx[2], dx[3]);
      *reinterpret_cast<float4*>(oy) = make_float4(dy[0], dy[1], dy[2], dy[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (xb + i < W) {
          ox[i] = dx[i];
          oy[i] = dy[i];
        }
      }
    }
  }
}

template <int R, int TW>
int launch_tw(const float* m, float* flow, int P, int H, int W, float inv_area, bool vec,
              cudaStream_t stream) {
  constexpr size_t smem = Strip<TW>::smem;
  // the opt-in above 48 KB and the resident blocks the card holds, once per
  // kernel function and device
  static PerDevice opted, resident;
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  const int attr = once_per_device(opted, dev, [] {
    return (int)cudaFuncSetAttribute(box_blur_solve_kernel<R, TW>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)Strip<TW>::smem);
  });
  if (attr != cudaSuccess) return attr;
  const int slots = once_per_device(resident, dev, [dev] {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, box_blur_solve_kernel<R, TW>, NT,
                                                  Strip<TW>::smem);
    return sms * max(per_sm, 1);
  });
  // The run of steps a block walks: a block's time goes with the rows it
  // loads (run TH + 2R), and the launch takes whole waves of ``slots``
  // blocks, so take the run with the fewest rows across its waves.
  const int strips = (W + TW - 1) / TW, steps = (H + TH - 1) / TH;
  int run = steps;
  long long best = -1;
  for (int r = 1; r <= steps; ++r) {
    const long long blocks = (long long)P * strips * ((steps + r - 1) / r);
    const long long cost = (blocks + slots - 1) / slots * (TH * r + 2 * R);
    if (best < 0 || cost < best) best = cost, run = r;
  }
  const int seg = TH * run;
  dim3 grid((unsigned)strips, (unsigned)((H + seg - 1) / seg), (unsigned)P);
  box_blur_solve_kernel<R, TW><<<grid, NT, smem, stream>>>(m, flow, H, W, seg, inv_area, vec);
  return (int)cudaGetLastError();
}

template <int R>
int launch(const float* m, float* flow, int P, int H, int W, float inv_area, bool vec,
           cudaStream_t stream) {
  // the strip width that wastes fewer columns; 112 on a tie
  if ((W + 111) / 112 * 112 <= (W + 127) / 128 * 128)
    return launch_tw<R, 112>(m, flow, P, H, W, inv_area, vec, stream);
  return launch_tw<R, 128>(m, flow, P, H, W, inv_area, vec, stream);
}

// --------------------------------------------------------- generic radius
constexpr int GX = 128;  // threads a block in both passes
constexpr int GR = 16;   // output rows a thread in the vertical pass
constexpr int GC = 4;    // output columns a thread in the horizontal pass

// acc[i] = sum over d = 0 .. 2R of tap(i + d), in tap order, for the OUT
// outputs of a run: each tap is loaded once and added to the outputs whose
// window holds it.
template <int OUT, typename Tap>
__device__ __forceinline__ void run_sums(float (&acc)[OUT], int R, Tap tap) {
#pragma unroll 2
  for (int r = 0; r < OUT + 2 * R; ++r) {
    const float val = tap(r);
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
      const int d = r - i;
      if (d == 0)
        acc[i] = val;
      else if (d > 0 && d <= 2 * R)
        acc[i] += val;
    }
  }
}

// vsum[pc, y, x] = sum over d = 0 .. 2R of m[pc, clamp(y - R + d), x]: block
// (column strip, run of GR rows, plane of a pair), a thread a column
__global__ void __launch_bounds__(GX)
box_rows_kernel(const float* __restrict__ m, float* __restrict__ vsum, int H, int W, int R) {
  const int x = blockIdx.x * GX + threadIdx.x;
  if (x >= W) return;
  const long long plane = (long long)blockIdx.z * H * W;
  const float* const col = m + plane + x;
  const int y0 = blockIdx.y * GR;
  float acc[GR];
  run_sums<GR>(acc, R, [&](int r) {
    return __ldg(col + (long long)min(max(y0 - R + r, 0), H - 1) * W);
  });
#pragma unroll
  for (int i = 0; i < GR; ++i)
    if (y0 + i < H) vsum[plane + (long long)(y0 + i) * W + x] = acc[i];
}

// the horizontal sums of the five planes of GC pixels of row y, scaled,
// and the solve: block (strip of GX * GC columns, row, pair)
__global__ void __launch_bounds__(GX)
box_cols_solve_kernel(const float* __restrict__ vsum, float* __restrict__ out, int H, int W,
                      int R, float inv_area) {
  const int x0 = (blockIdx.x * GX + threadIdx.x) * GC;
  if (x0 >= W) return;
  const int y = blockIdx.y, p = blockIdx.z;
  const long long hw = (long long)H * W;
  float b[5][GC];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* const row = vsum + ((long long)p * 5 + c) * hw + (long long)y * W;
    run_sums<GC>(b[c], R, [&](int r) { return __ldg(row + min(max(x0 - R + r, 0), W - 1)); });
  }
  float* const o = out + (long long)p * 2 * hw + (long long)y * W;
#pragma unroll
  for (int i = 0; i < GC; ++i) {
    if (x0 + i >= W) break;
    // the plain version's roundings, as in the strip kernel
    const float g11 = __fmul_rn(b[0][i], inv_area), g12 = __fmul_rn(b[1][i], inv_area);
    const float g22 = __fmul_rn(b[2][i], inv_area), h1 = __fmul_rn(b[3][i], inv_area);
    const float h2 = __fmul_rn(b[4][i], inv_area);
    const float idet = 1.0f / (__fmul_rn(g11, g22) - __fmul_rn(g12, g12) + 1e-3f);
    o[x0 + i] = __fmul_rn(__fmul_rn(g11, h2) - __fmul_rn(g12, h1), idet);
    o[hw + x0 + i] = __fmul_rn(__fmul_rn(g22, h1) - __fmul_rn(g12, h2), idet);
  }
}

}  // namespace

// m: (P, 5, H, W) f32, scratch: (P, 5, H, W) f32 -> flow: (P, 2, H, W) f32;
// any odd winsize.
extern "C" int relax_box_blur_solve_generic(const void* m, void* scratch, void* flow, int P,
                                            int H, int W, int winsize, void* stream) {
  if (winsize < 1 || winsize % 2 != 1 || 5LL * P > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int R = winsize / 2;
  const float inv_area = (float)(1.0 / ((double)winsize * winsize));
  cudaStream_t s = (cudaStream_t)stream;
  box_rows_kernel<<<dim3((unsigned)((W + GX - 1) / GX), (unsigned)((H + GR - 1) / GR),
                         (unsigned)(5 * P)), GX, 0, s>>>((const float*)m, (float*)scratch, H, W, R);
  const int err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;
  box_cols_solve_kernel<<<dim3((unsigned)((W + GX * GC - 1) / (GX * GC)), (unsigned)H, (unsigned)P),
                          GX, 0, s>>>(
      (const float*)scratch, (float*)flow, H, W, R, inv_area);
  return (int)cudaGetLastError();
}

// m: (P, 5, H, W) f32 -> flow: (P, 2, H, W) f32; winsize odd, at most 17.
extern "C" int relax_box_blur_solve(const void* m, void* flow, int P, int H, int W,
                                    int winsize, void* stream) {
  if (winsize < 1 || winsize % 2 != 1 || winsize / 2 > RMAX) return (int)cudaErrorInvalidValue;
  const float* mi = (const float*)m;
  float* fo = (float*)flow;
  // 16-byte loads and stores need 16-byte aligned rows
  const bool vec = W % 4 == 0 && ((uintptr_t)m | (uintptr_t)flow) % 16 == 0;
  const float inv_area = (float)(1.0 / (double)(winsize * winsize));
  cudaStream_t s = (cudaStream_t)stream;
  switch (winsize / 2) {
    case 0: return launch<0>(mi, fo, P, H, W, inv_area, vec, s);
    case 1: return launch<1>(mi, fo, P, H, W, inv_area, vec, s);
    case 2: return launch<2>(mi, fo, P, H, W, inv_area, vec, s);
    case 3: return launch<3>(mi, fo, P, H, W, inv_area, vec, s);
    case 4: return launch<4>(mi, fo, P, H, W, inv_area, vec, s);
    case 5: return launch<5>(mi, fo, P, H, W, inv_area, vec, s);
    case 6: return launch<6>(mi, fo, P, H, W, inv_area, vec, s);
    case 7: return launch<7>(mi, fo, P, H, W, inv_area, vec, s);
    default: return launch<8>(mi, fo, P, H, W, inv_area, vec, s);
  }
}
