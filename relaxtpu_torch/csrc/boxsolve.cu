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
// Windows 19 and 21 (box_blur_solve_pallas takes any odd winsize; the
// strip kernel's halo span holds a radius of at most 8) take the
// generic-radius kernel, box_ring_solve_kernel: the strip kernel's
// structure with the radius R a run-time value, in one launch that reads M
// once and writes only the flow (no scratch).  It takes windows up to 65.
// - A block of 256 threads takes (pair, strip of tw output columns, run of
//   seg rows) and walks down it 16 output rows a step.  Each plane's input
//   rows sit in a ring of ``rows`` = 16 + 2R rows (rounded up to 4) of a
//   128-column span in dynamic shared memory: the strip plus R4 = R rounded
//   up to 4 columns each side, so every 16-byte copy is aligned.  The plan
//   (tw <= 128 - 2 R4, the widest that splits W into the fewest strips, and
//   seg, whole waves of resident blocks) is ops/boxsolve.py::_ring_plan's.
// - Every input row arrives once a run, by 16-byte cp.async (4-byte copies,
//   clamped, at the image's edges or for widths that are not a multiple of
//   4).  The planes are staged in turn: right after a step's vertical pass
//   of plane c, plane c's next 16 rows go into the slots of the 16 it no
//   longer needs, so a ring holds one step's window and no more (rows
//   16 + 2R, not 32 + 2R), and they have the rest of the step to land.  One
//   barrier a plane a step.
// - Vertical sums: a thread takes a column and 8 rows, and slides a window
//   of 8 registers down the column one row a tap, so each sum is formed in
//   tap order from one shared load a tap and no compare an output (the
//   loop runs 2R taps; its body, unrolled over the 8 rows, reads 4 ring rows
//   at a time, which never straddle the ring's wrap: rows is a multiple of
//   4).  The sums land in a row of vertical sums shifted by R4 - R, so the
//   horizontal pass reads 16-byte chunks.
// - Horizontal sums: a thread forms 4 consecutive outputs of a row from
//   16-byte chunks of that row, taps again in order.
// - The five box sums of a pixel stay in registers; the solve is the strip
//   kernel's, so the result is the plain version's to the bit.
// At R = 32 the rings take 200 KB (one block an SM); winsize 65 is the
// largest the kernel takes (GRMAX).
//
// Wider windows take a pair of kernels whose shared memory does not hold
// five planes at once: the function's 28 bytes a pixel plus a scratch
// buffer of vertical sums written once and read once: 68 bytes a pixel,
// and the halos (a run of seg rows reads seg + taps - 1 of M's, 1.24x at
// winsize 67 on a 540x960 plane; a band's staged span is its width plus
// taps + 3 columns, 1.075x there).  One launch of each takes windows up to
// 421.
// - box_vsum_kernel, the vertical pass: a block of 256 threads takes one
//   plane of a pair, a strip of 128 columns (all of them output columns:
//   a vertical sum needs no horizontal halo) and a run of seg rows, and
//   walks down it 16 output rows a step.  The plane's input rows sit in a
//   ring of 32 + (taps - 1) rows (rounded up to 4) x 128 columns: a step's
//   window and the next step's 16 rows, which arrive by 16-byte cp.async
//   (4-byte copies, clamped, at the edges or for unaligned widths) while
//   the step reads the ring, one barrier a step: 51,200 bytes at winsize 67
//   (four blocks an SM), 118,784 at 201, 231,424 at 421.  A thread
//   takes a column and 8 rows and forms their sums in tap order with the
//   generic-radius kernel's sliding register window (one shared load a
//   tap, no compare an output), then stores them to the scratch, a warp
//   writing 128 contiguous bytes of a row (16-byte stores would need rows
//   aligned as the horizontal pass needs them shifted).  Windows whose ring
//   would not fit walk their taps in chunks, in order: a launch a chunk,
//   each adding its taps to the sums the launches before it stored.
// - box_hsum_solve_kernel, the horizontal pass, the scale and the solve: a
//   block of 256 threads takes (pair, strip of tw columns, band of bh rows),
//   tw whole rows up to 2,048 columns (each sum read once but for the
//   halo), 512 4-pixel runs at most.  It stages the five planes' sums of
//   the band over tw + taps + 3 columns by cp.async (clamped at the edges);
//   the scratch holds column x at R mod 4 + x of rows of ws floats, so the
//   staged span starts 16-byte aligned at any R.  A thread forms 4
//   consecutive outputs from 16-byte chunks, taps in order, the five box
//   sums of its (two) runs in registers; the solve is the strip kernel's.
//   Windows whose staged span would not fit (about 9,500 taps) walk their
//   taps in staged chunks, in order, into the same registers.
// Both start their sums from -0, which adds exactly, so the pair's output
// is the plain version's to the bit.  The pair takes windows above
// ops/boxsolve.py's GENERIC_WINSIZE: it is faster than the generic-radius
// kernel from winsize 23 on, where that kernel's rings hold it to one block
// an SM.

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
// until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ------------------------------------------------- generic radius: one launch
constexpr int GT = 256;    // threads a block
constexpr int GTH = 16;    // output rows a step
constexpr int GRS = 128;   // staged columns a ring row: tw + 2 R4 <= GRS
constexpr int GRMAX = 32;  // largest radius (winsize 65)

template <int TH, int RS>
struct Ring {
  static constexpr int VR = TH * RS / GT;                 // rows a thread sums in the vertical pass
  static constexpr int VS = RS + 4;                       // vertical-sum row stride
  static constexpr int HR = (TH * RS / 4 + GT - 1) / GT;  // 4-pixel runs a thread, at most
  // ring rows a plane: one step's window, a multiple of 4
  __host__ __device__ static constexpr int rows(int R) { return (TH + 2 * R + 3) & ~3; }
  static constexpr size_t smem(int R) {
    return sizeof(float) * ((size_t)5 * rows(R) * RS + 2 * TH * VS);
  }
  static_assert(VR % 4 == 0 && VR * GT == TH * RS && RS % 32 == 0, "a (column, VR rows) item a thread");
};

// ``n`` rows of the run's ring (image rows y0 .. y0 + n - 1, clamped: the
// replicate border) of one plane into slots slot0, slot0 + 1, ... (mod
// rows); columns gx0 .. gx0 + span - 1, clamped.  A thread keeps one 16-byte
// column chunk and walks rows.
template <int RS>
__device__ __forceinline__ void ring_rows(float* ring, const float* plane, int H, int W, int y0,
                                          int gx0, int span, int n, int slot0, int rows, bool vec) {
  constexpr int C4 = RS / 4, LANES = GT / C4;
  const int lane = threadIdx.x / C4, cc = 4 * (threadIdx.x % C4);
  if (cc >= span) return;
  const int gx = gx0 + cc;
  const bool whole = vec && gx >= 0 && gx + 4 <= W;
  int slot = slot0 + lane;
  if (slot >= rows) slot -= rows;
  for (int i = lane; i < n; i += LANES) {
    const float* row = plane + (long long)min(max(y0 + i, 0), H - 1) * W;
    float* dst = ring + slot * RS + cc;
    if (whole) {
      cp_async16(dst, row + gx);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(dst + e, row + min(max(gx + e, 0), W - 1));
    }
    slot += LANES;
    if (slot >= rows) slot -= rows;
  }
}

// The ring slot 4 rows on from ``slot`` (both multiples of 4, as rows is).
__device__ __forceinline__ int next4(int slot, int rows) { return slot + 4 == rows ? 0 : slot + 4; }

// One block of J consecutive ring rows of a column (J <= 4, never across the
// wrap) into w[at .. at + J), each added as a tap to every output right
// after it is loaded: tap t loads u(t + VR - 1) into w[(t - 1) % VR] and
// adds u(y + t) = w[(y + t) % VR] to output y; ``at`` is (t - 1) % VR of
// the block's first tap.  Every caller's loops are unrolled, so ``at`` and
// the register indices are constants.
template <int VR, int RS, int J>
__device__ __forceinline__ void vtaps(float (&s)[VR], float (&w)[VR], const float* src, int at) {
  float n[J];
#pragma unroll
  for (int j = 0; j < J; ++j) n[j] = src[j * RS];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    w[at + j] = n[j];
#pragma unroll
    for (int y = 0; y < VR; ++y) s[y] += w[(y + at + j + 1) % VR];
  }
}

// s[y] = u(y) + u(y + 1) + ... + u(y + 2R) for y < VR, in that order: u(v)
// is ring row slot + v (mod rows) of column ``col``.  A window of VR
// registers slides down the column one row a tap.
template <int VR, int RS>
__device__ __forceinline__ void vsums(float (&s)[VR], const float* col, int slot, int rows, int R) {
  float w[VR];
#pragma unroll
  for (int b = 0; b < VR / 4; ++b) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[4 * b + j] = col[(slot + j) * RS];
    slot = next4(slot, rows);
  }
#pragma unroll
  for (int y = 0; y < VR; ++y) s[y] = w[y];
  int t = 2 * R;  // taps left
  for (; t >= VR; t -= VR) {
#pragma unroll
    for (int b = 0; b < VR / 4; ++b) {
      vtaps<VR, RS, 4>(s, w, col + slot * RS, 4 * b);
      slot = next4(slot, rows);
    }
  }
#pragma unroll
  for (int b = 0; b < VR / 4; ++b) {  // t is even and below VR
    if (4 * b + 4 <= t) {
      vtaps<VR, RS, 4>(s, w, col + slot * RS, 4 * b);
      slot = next4(slot, rows);
    } else if (4 * b + 2 == t) {
      vtaps<VR, RS, 2>(s, w, col + slot * RS, 4 * b);
    }
  }
}

__device__ __forceinline__ void ld4(float (&a)[4], const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  a[0] = f.x;
  a[1] = f.y;
  a[2] = f.z;
  a[3] = f.w;
}

// Taps 4g + 1 .. 4g + J of outputs i < 4 from chunks a = g, b = g + 1.
template <int J>
__device__ __forceinline__ void htaps(float (&s)[4], const float (&a)[4], const float (&b)[4]) {
#pragma unroll
  for (int j = 1; j <= J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] += i + j < 4 ? a[i + j] : b[i + j - 4];
}

// s[i] = v(i) + v(i + 1) + ... + v(i + 2R) for i < 4, in that order, v read
// from p (16-byte aligned) by 16-byte chunks; 2R = 4n + 2(R & 1).  Reads at
// most v(2R + 7).
__device__ __forceinline__ void hsums(float (&s)[4], const float* p, int R) {
  float a[4], b[4];
  ld4(a, p);
  ld4(b, p + 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = a[i];
  int n = R >> 1;  // whole groups of 4 taps
  p += 8;
  for (; n >= 2; n -= 2, p += 8) {  // two groups a trip, the chunks' roles swapped
    htaps<4>(s, a, b);
    ld4(a, p);
    htaps<4>(s, b, a);
    ld4(b, p + 4);
  }
  if (n) {
    htaps<4>(s, a, b);
    ld4(a, p);
    if (R & 1) htaps<2>(s, b, a);
  } else if (R & 1) {
    htaps<2>(s, a, b);
  }
}

// grid: (strips of tw columns, runs of ``seg`` rows, pairs)
template <int TH, int RS>
__global__ void __launch_bounds__(GT, 2)
box_ring_solve_kernel(const float* __restrict__ m, float* __restrict__ out, int H, int W, int R,
                      int tw, int seg, float inv_area, bool vec) {
  using G = Ring<TH, RS>;
  constexpr int VR = G::VR, VS = G::VS, HR = G::HR;
  extern __shared__ __align__(16) float smem[];
  const int rows = G::rows(R);
  float* const vsum = smem + 5 * rows * RS;  // 2 x TH x VS, alternating planes
  const int tid = threadIdx.x;
  const int r4 = (R + 3) & ~3, off = r4 - R, span = tw + 2 * r4;
  const int x0 = blockIdx.x * tw, ys = blockIdx.y * seg, ye = min(ys + seg, H);
  const int steps = (ye - ys + TH - 1) / TH;
  const long long hw = (long long)H * W;
  const float* const mp = m + (long long)blockIdx.z * 5 * hw;

  // ring row r holds image row ys - R + r; step k reads rows [TH k, TH k + TH + 2R)
#pragma unroll
  for (int c = 0; c < 5; ++c) {  // a commit group a plane
    ring_rows<RS>(smem + c * rows * RS, mp + c * hw, H, W, ys - R, x0 - r4, span, TH + 2 * R, 0, rows,
                  vec);
    cp_async_commit();
  }
  cp_async_wait<4>();
  __syncthreads();

  const int vcol = tid % RS, vy0 = VR * (tid / RS);
  int hrow[HR], hx[HR];  // this thread's 4-pixel runs: row of the step, first column
#pragma unroll
  for (int e = 0; e < HR; ++e) {
    const int u = tid + GT * e;
    hrow[e] = u / (tw / 4);
    hx[e] = 4 * (u % (tw / 4));
  }
  int vslot = vy0;  // the slot of ring row TH k + vy0
  for (int k = 0; k < steps; ++k) {
    const int fill = (TH * (k + 1) + 2 * R) % rows;  // the slot of the next step's first new row
    float acc[5][HR][4];                              // the five box sums of this thread's runs
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      float* const ring = smem + c * rows * RS;
      float* const vs = vsum + ((k + c) & 1) * TH * VS;
      if (vcol < span) {
        float s[VR];
        vsums<VR, RS>(s, ring + vcol, vslot, rows, R);
        if (vcol >= off) {  // vs[y][q] sums column x0 - R + q
#pragma unroll
          for (int y = 0; y < VR; ++y) vs[(vy0 + y) * VS + vcol - off] = s[y];
        }
      }
      // The next plane's rows (or plane 0's of the next step) have landed;
      // after the barrier every thread sees them and vs, plane c's oldest
      // TH rows are free, and plane c - 1's horizontal pass is done with the
      // other buffer, which plane c + 1 writes.
      cp_async_wait<3>();
      __syncthreads();
      if (k + 1 < steps)
        ring_rows<RS>(ring, mp + c * hw, H, W, ys - R + TH * (k + 1) + 2 * R, x0 - r4, span, TH, fill,
                      rows, vec);
      cp_async_commit();  // every trip, so the count of groups in flight stays 3
#pragma unroll
      for (int e = 0; e < HR; ++e)
        if (hrow[e] < TH) hsums(acc[c][e], vs + hrow[e] * VS + hx[e], R);
    }
    vslot += TH;
    if (vslot >= rows) vslot -= rows;

#pragma unroll
    for (int e = 0; e < HR; ++e) {
      const int y = ys + TH * k + hrow[e], xb = x0 + hx[e];
      if (hrow[e] >= TH || y >= ye || xb >= W) continue;
      float dx[4], dy[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // the plain version's roundings, as in the strip kernel
        const float g11 = __fmul_rn(acc[0][e][i], inv_area), g12 = __fmul_rn(acc[1][e][i], inv_area);
        const float g22 = __fmul_rn(acc[2][e][i], inv_area), h1 = __fmul_rn(acc[3][e][i], inv_area);
        const float h2 = __fmul_rn(acc[4][e][i], inv_area);
        const float idet = 1.0f / (__fmul_rn(g11, g22) - __fmul_rn(g12, g12) + 1e-3f);
        dx[i] = __fmul_rn(__fmul_rn(g11, h2) - __fmul_rn(g12, h1), idet);
        dy[i] = __fmul_rn(__fmul_rn(g22, h1) - __fmul_rn(g12, h2), idet);
      }
      float* ox = out + (long long)blockIdx.z * 2 * hw + (long long)y * W + xb;
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
}

using GRing = Ring<GTH, GRS>;

// The opt-in above 48 KB, once per device, at the largest size the kernel
// takes (R = GRMAX); a CUDA error or 0.
int ring_opt_in(int dev) {
  static PerDevice opted;
  return once_per_device(opted, dev, [] {
    return (int)cudaFuncSetAttribute(box_ring_solve_kernel<GTH, GRS>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)GRing::smem(GRMAX));
  });
}

// ------------------------------------------------ wide windows: two passes
constexpr int VT = GT;     // threads a block in the vertical pass (ring_rows' thread count)
constexpr int VTH = 16;    // output rows a step of the vertical pass
constexpr int VRS = 128;   // columns a vertical block: its ring rows, all output columns
constexpr int VR = VTH * VRS / VT;  // rows a thread sums
constexpr int HT = 256;    // threads a block in the horizontal pass
constexpr int HR = 2;      // 4-pixel runs a thread in the horizontal pass, at most
constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory on the card
static_assert(VR % 4 == 0 && VR * VT == VTH * VRS && VRS % 32 == 0, "a (column, VR rows) item a thread");

// Ring rows of the vertical pass for n taps a launch: a step's window (VTH +
// n - 1 rows) and the next step's VTH, a multiple of 4.
__host__ __device__ constexpr int vring_rows(int n) { return (2 * VTH + n - 1 + 3) & ~3; }
// Staged floats a row of the horizontal pass for chunks of ct taps: the
// strip, the taps and what hsums_from reads past them.
__host__ __device__ constexpr int hstage_cols(int tw, int ct) { return tw + ((ct + 3 + 3) & ~3); }

// s[y] += u(y) + u(y + 1) + ... + u(y + n - 1) for y < VR, in that order:
// u(v) is ring row slot + v (mod rows) of column ``col``.  vsums' sliding
// window of VR registers, from sums already begun and for any count of taps.
template <int VR_, int RS>
__device__ __forceinline__ void vsums_from(float (&s)[VR_], const float* col, int slot, int rows, int n) {
  float w[VR_];
#pragma unroll
  for (int b = 0; b < VR_ / 4; ++b) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[4 * b + j] = col[(slot + j) * RS];
    slot = next4(slot, rows);
  }
#pragma unroll
  for (int y = 0; y < VR_; ++y) s[y] += w[y];
  int t = n - 1;  // taps left
  for (; t >= VR_; t -= VR_) {
#pragma unroll
    for (int b = 0; b < VR_ / 4; ++b) {
      vtaps<VR_, RS, 4>(s, w, col + slot * RS, 4 * b);
      slot = next4(slot, rows);
    }
  }
#pragma unroll
  for (int b = 0; b < VR_ / 4; ++b) {  // t is below VR
    if (4 * b + 4 <= t) {
      vtaps<VR_, RS, 4>(s, w, col + slot * RS, 4 * b);
      slot = next4(slot, rows);
    } else if (4 * b + 3 == t) {
      vtaps<VR_, RS, 3>(s, w, col + slot * RS, 4 * b);
    } else if (4 * b + 2 == t) {
      vtaps<VR_, RS, 2>(s, w, col + slot * RS, 4 * b);
    } else if (4 * b + 1 == t) {
      vtaps<VR_, RS, 1>(s, w, col + slot * RS, 4 * b);
    }
  }
}

// s[i] += v(i) + v(i + 1) + ... + v(i + n - 1) for i < 4, in that order, v
// read from p (16-byte aligned) by 16-byte chunks: hsums for sums already
// begun and any count of taps.  Reads at most v(n + 6).
__device__ __forceinline__ void hsums_from(float (&s)[4], const float* p, int n) {
  float a[4], b[4];
  ld4(a, p);
  ld4(b, p + 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] += a[i];
  int t = n - 1;  // taps left
  p += 8;
#pragma unroll 2
  for (; t >= 8; t -= 8, p += 8) {  // two groups of 4 a trip, the chunks' roles swapped
    htaps<4>(s, a, b);
    ld4(a, p);
    htaps<4>(s, b, a);
    ld4(b, p + 4);
  }
  if (t >= 4) {
    htaps<4>(s, a, b);
    ld4(a, p);
    if (t == 7) htaps<3>(s, b, a);
    else if (t == 6) htaps<2>(s, b, a);
    else if (t == 5) htaps<1>(s, b, a);
  } else if (t == 3) {
    htaps<3>(s, a, b);
  } else if (t == 2) {
    htaps<2>(s, a, b);
  } else if (t == 1) {
    htaps<1>(s, a, b);
  }
}

// Vertical pass, taps t0 .. t0 + n - 1 of every output:
//   vs[pc, y, padl + x] (+)= m[pc, clamp(y - R + t0), x] + ... + m[pc, clamp(y - R + t0 + n - 1), x]
// in that order, begun from the sums of the taps before t0 (t0 > 0) or
// from -0 (which adds exactly).  grid: (strips of VRS columns, runs of seg
// rows, P x 5 planes).  Stream row i of a run (image row ys - R + t0 + i,
// clamped) sits in ring slot i mod rows; step k reads stream rows [VTH k,
// VTH k + VTH + n - 1) and, while it does, the next step's VTH rows land in
// the slots of rows below VTH k.
__global__ void __launch_bounds__(VT, 4)
box_vsum_kernel(const float* __restrict__ m, float* __restrict__ vs, int H, int W, int ws, int padl,
                int R, int t0, int n, int seg, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int rows = vring_rows(n);
  const int x0 = blockIdx.x * VRS, ys = blockIdx.y * seg, ye = min(ys + seg, H);
  const int steps = (ye - ys + VTH - 1) / VTH, span = min(VRS, W - x0);
  const float* const src = m + (long long)blockIdx.z * H * W;
  float* const dst = vs + (long long)blockIdx.z * H * ws + padl + x0;
  const int y0 = ys - R + t0;  // the image row of stream row 0
  ring_rows<VRS>(smem, src, H, W, y0, x0, span, VTH + n - 1, 0, rows, vec);
  cp_async_commit();
  const int col = threadIdx.x % VRS, vy0 = VR * (threadIdx.x / VRS);
  int slot = vy0;  // the slot of stream row VTH k + vy0
  for (int k = 0; k < steps; ++k) {
    cp_async_wait_all();
    __syncthreads();  // step k's rows are in; step k - 1 no longer reads the slots the next rows take
    if (k + 1 < steps) {
      const int next = VTH * (k + 1) + n - 1;  // the next step's first new stream row
      ring_rows<VRS>(smem, src, H, W, y0 + next, x0, span, VTH, next % rows, rows, vec);
      cp_async_commit();
    }
    if (col < span) {
      const int y = ys + VTH * k + vy0;
      float s[VR];
#pragma unroll
      for (int i = 0; i < VR; ++i) s[i] = t0 > 0 && y + i < ye ? dst[(long long)(y + i) * ws + col] : -0.0f;
      vsums_from<VR, VRS>(s, smem + col, slot, rows, n);
#pragma unroll
      for (int i = 0; i < VR; ++i)
        if (y + i < ye) dst[(long long)(y + i) * ws + col] = s[i];
    }
    slot += VTH;
    if (slot >= rows) slot -= rows;
  }
}

// Horizontal pass, the scale and the solve: block (strip of tw columns,
// band of bh rows, pair).  The taps walk in chunks of ct (a multiple of 4):
// for each, the five planes' vertical sums of the band, columns x0 - R + t0
// .. on (clamped: the replicate border), are staged in shared memory, and a
// thread adds the chunk's taps to the five sums of each of its 4-pixel runs,
// which stay in registers.  Row q of the scratch holds column x at padl + x
// with padl = R mod 4, so the staged span starts 16-byte aligned.
__global__ void __launch_bounds__(HT, 3)
box_hsum_solve_kernel(const float* __restrict__ vs, float* __restrict__ out, int H, int W, int ws,
                      int padl, int R, int tw, int bh, int ct, float inv_area, bool vec_in,
                      bool vec_out) {
  extern __shared__ __align__(16) float smem[];
  const int x0 = blockIdx.x * tw, y0 = blockIdx.y * bh, nb = min(bh, H - y0);
  const int ss = hstage_cols(tw, ct), taps = 2 * R + 1;
  const long long hw = (long long)H * W, hws = (long long)H * ws;
  const float* const src = vs + (long long)blockIdx.z * 5 * hws + (long long)y0 * ws + padl;
  int hrow[HR], hx[HR];  // this thread's 4-pixel runs: row of the band, first column of the strip
  float acc[5][HR][4];
#pragma unroll
  for (int e = 0; e < HR; ++e) {
    const int u = threadIdx.x + HT * e;
    hrow[e] = u / (tw / 4);
    hx[e] = 4 * (u % (tw / 4));
#pragma unroll
    for (int c = 0; c < 5; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][e][i] = -0.0f;
  }
  for (int t0 = 0; t0 < taps; t0 += ct) {
    if (t0 > 0) __syncthreads();  // the last chunk's taps are done with the buffer
    // a warp a staged row (plane c, row r of the band) at a time, a lane a 16-byte chunk
    for (int c = threadIdx.x / 32 / nb, r = threadIdx.x / 32 % nb; c < 5;) {
      const float* const line = src + c * hws + (long long)r * ws;
      float* const dst = smem + (c * bh + r) * ss;
      for (int q = 4 * (threadIdx.x % 32); q < ss; q += 128) {
        const int gx = x0 - R + t0 + q;
        if (vec_in && gx >= 0 && gx + 4 <= W) {
          cp_async16(dst + q, line + gx);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) cp_async4(dst + q + e, line + min(max(gx + e, 0), W - 1));
        }
      }
      for (r += HT / 32; r >= nb; r -= nb) ++c;
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const int n = min(ct, taps - t0);
#pragma unroll
    for (int c = 0; c < 5; ++c)
#pragma unroll
      for (int e = 0; e < HR; ++e)
        if (hrow[e] < nb) hsums_from(acc[c][e], smem + (c * bh + hrow[e]) * ss + hx[e], n);
  }
#pragma unroll
  for (int e = 0; e < HR; ++e) {
    const int y = y0 + hrow[e], xb = x0 + hx[e];
    if (hrow[e] >= nb || xb >= W) continue;
    float dx[4], dy[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the plain version's roundings, as in the strip kernel
      const float g11 = __fmul_rn(acc[0][e][i], inv_area), g12 = __fmul_rn(acc[1][e][i], inv_area);
      const float g22 = __fmul_rn(acc[2][e][i], inv_area), h1 = __fmul_rn(acc[3][e][i], inv_area);
      const float h2 = __fmul_rn(acc[4][e][i], inv_area);
      const float idet = 1.0f / (__fmul_rn(g11, g22) - __fmul_rn(g12, g12) + 1e-3f);
      dx[i] = __fmul_rn(__fmul_rn(g11, h2) - __fmul_rn(g12, h1), idet);
      dy[i] = __fmul_rn(__fmul_rn(g22, h1) - __fmul_rn(g12, h2), idet);
    }
    float* ox = out + (long long)blockIdx.z * 2 * hw + (long long)y * W + xb;
    float* oy = ox + hw;
    if (vec_out && xb + 4 <= W) {
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

// The opt-in to the largest dynamic shared memory for both passes, once per
// device; a CUDA error or 0.
int wide_opt_in(int dev) {
  static PerDevice opted;
  return once_per_device(opted, dev, [] {
    const int err = (int)cudaFuncSetAttribute(box_vsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              SMEM_MAX);
    if (err != cudaSuccess) return err;
    return (int)cudaFuncSetAttribute(box_hsum_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     SMEM_MAX);
  });
}

}  // namespace

// m: (P, 5, H, W) f32 -> flow: (P, 2, H, W) f32; winsize odd, at most 65;
// tw and seg: the plan of ops/boxsolve.py::_ring_plan (tw a multiple of 4
// with tw + 2 R4 <= 128, seg a multiple of 16).
extern "C" int relax_box_blur_solve_generic(const void* m, void* flow, int P, int H, int W,
                                            int winsize, int tw, int seg, void* stream) {
  const int R = winsize / 2, r4 = (R + 3) & ~3;
  if (winsize < 1 || winsize % 2 != 1 || R > GRMAX || P < 1 || P > 65535 || H < 1 || W < 1 ||
      tw < 4 || tw % 4 != 0 || tw + 2 * r4 > GRS || seg < GTH || seg % GTH != 0 ||
      (H + seg - 1) / seg > 65535)
    return (int)cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  const int attr = ring_opt_in(dev);
  if (attr != cudaSuccess) return attr;
  // 16-byte loads and stores need 16-byte aligned rows
  const bool vec = W % 4 == 0 && ((uintptr_t)m | (uintptr_t)flow) % 16 == 0;
  const float inv_area = (float)(1.0 / ((double)winsize * winsize));
  const dim3 grid((unsigned)((W + tw - 1) / tw), (unsigned)((H + seg - 1) / seg), (unsigned)P);
  box_ring_solve_kernel<GTH, GRS><<<grid, GT, GRing::smem(R), (cudaStream_t)stream>>>(
      (const float*)m, (float*)flow, H, W, R, tw, seg, inv_area, vec);
  return (int)cudaGetLastError();
}

// The generic-radius kernel's resident blocks on the current device at this
// winsize (SMs x blocks an SM), once per device and radius; minus a CUDA
// error.
extern "C" int relax_box_blur_solve_generic_slots(int winsize) {
  const int R = winsize / 2;
  if (winsize < 1 || winsize % 2 != 1 || R > GRMAX) return -(int)cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return -(int)cudaErrorInvalidDevice;
  const int attr = ring_opt_in(dev);
  if (attr != cudaSuccess) return -attr;
  static PerDevice resident[GRMAX + 1];
  return once_per_device(resident[R], dev, [dev, R] {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, box_ring_solve_kernel<GTH, GRS>, GT,
                                                  GRing::smem(R));
    return sms * max(per_sm, 1);
  });
}

// m: (P, 5, H, W) f32, scratch: (P, 5, H, ws) f32 -> flow: (P, 2, H, W) f32;
// any odd winsize (the route above GENERIC_WINSIZE).  The plan is ops/boxsolve.py::
// _wide_plan's: the scratch row stride ws (a multiple of 4, at least W + R
// mod 4); the vertical pass's runs of seg rows (a multiple of 16) and taps a
// launch nv (the whole window where its ring fits, else chunks of nv in
// turn, each launch adding its taps to the sums of the ones before); the
// horizontal pass's strips of tw columns, bands of bh rows (bh x tw / 4
// runs at most HT x HR) and chunks of ct taps (a multiple of 4).
extern "C" int relax_box_blur_solve_wide(const void* m, void* scratch, void* flow, int P, int H, int W,
                                         int winsize, int ws, int seg, int nv, int tw, int bh, int ct,
                                         void* stream) {
  const int R = winsize / 2, padl = R & 3;
  if (winsize < 1 || winsize % 2 != 1 || P < 1 || 5LL * P > 65535 || H < 1 || W < 1 || ws % 4 != 0 ||
      ws < W + padl || seg < VTH || seg % VTH != 0 || (H + seg - 1) / seg > 65535 || nv < 1 ||
      (long long)vring_rows(nv) * VRS * 4 > SMEM_MAX || tw < 4 || tw % 4 != 0 || bh < 1 ||
      (long long)bh * (tw / 4) > HT * HR || (H + bh - 1) / bh > 65535 || ct < 4 || ct % 4 != 0 ||
      20LL * bh * hstage_cols(tw, ct) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  const int attr = wide_opt_in(dev);
  if (attr != cudaSuccess) return attr;
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte copies need 16-byte aligned rows
  const bool vec_m = W % 4 == 0 && (uintptr_t)m % 16 == 0;
  const dim3 vgrid((unsigned)((W + VRS - 1) / VRS), (unsigned)((H + seg - 1) / seg), (unsigned)(5 * P));
  for (int t0 = 0; t0 < 2 * R + 1; t0 += nv) {
    const int n = min(nv, 2 * R + 1 - t0);
    box_vsum_kernel<<<vgrid, VT, (size_t)vring_rows(n) * VRS * 4, s>>>(
        (const float*)m, (float*)scratch, H, W, ws, padl, R, t0, n, seg, vec_m);
    const int err = (int)cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const float inv_area = (float)(1.0 / ((double)winsize * winsize));
  const dim3 hgrid((unsigned)((W + tw - 1) / tw), (unsigned)((H + bh - 1) / bh), (unsigned)P);
  box_hsum_solve_kernel<<<hgrid, HT, (size_t)20 * bh * hstage_cols(tw, ct), s>>>(
      (const float*)scratch, (float*)flow, H, W, ws, padl, R, tw, bh, ct, inv_area,
      (uintptr_t)scratch % 16 == 0, W % 4 == 0 && (uintptr_t)flow % 16 == 0);
  return (int)cudaGetLastError();
}

// The vertical pass's resident blocks on the current device at nv taps a
// launch (SMs x blocks an SM); minus a CUDA error.
extern "C" int relax_box_blur_solve_wide_slots(int nv) {
  if (nv < 1 || (long long)vring_rows(nv) * VRS * 4 > SMEM_MAX) return -(int)cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return -(int)cudaErrorInvalidDevice;
  const int attr = wide_opt_in(dev);
  if (attr != cudaSuccess) return -attr;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, box_vsum_kernel, VT,
                                                                     (size_t)vring_rows(nv) * VRS * 4);
  if (err != cudaSuccess) return -err;
  return sms * max(per_sm, 1);
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
