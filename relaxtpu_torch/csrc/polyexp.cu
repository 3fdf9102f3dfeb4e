// The flow's polynomial expansion, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves
// relaxtpu/ops/flow.py::_poly_expansion to XLA's fusion.  In the port the
// same function ran as 9 separable correlations and 10 combinations, ~226
// eager launches a pyramid level, each a pass over device memory
// (relaxtpu_torch/ops/flow.py::poly_expansion_plain).  This kernel computes
// it in one launch over every image of a level: (N, H, W) f32 ->
// (N, 5, H, W) f32 planes [c_y, c_x, c_yy, c_xx, c_xy], bit for bit the
// plain version's.
//
// The plain version's arithmetic, which the kernel keeps: every sum starts
// from +0 and adds its taps j = 0 .. 2n in order, each tap one rounded
// product (coefficient rounded to f32) and one rounded add (__fmul_rn,
// __fadd_rn: no FMA contraction); the vertical tap j reads row
// clamp(y + j - n), the horizontal one column clamp(x + j - n) (replicate
// border).  v0, v1, v2 are the vertical sums with g, x g, x^2 g; b1, b2,
// b4 the horizontal sums of v0 with g, x g, x^2 g; b3, b6 those of v1 with
// g, x g; b5 that of v2 with g.  Out: b3 ig11, b2 ig11, b1 ig03 + b5 ig33,
// b1 ig03 + b4 ig33, b6 ig55.
//
// What bounds it on the card: both rates at once.  A pixel reads 4 bytes
// and writes 20 (0.158 ms for a 540p video's 22.0 M level pixels at 3.35
// TB/s), and needs 6 (2n + 1) vertical and 12 (2n + 1) horizontal rounded
// products and adds plus 8 for the combination: 206 instructions at n = 5
// (0.136 ms at one a lane a cycle, 33.5e12 a second).  So it must read
// each input pixel from device memory once, keep the vertical sums on the
// chip, write the five planes once with 16-byte stores, and spend few
// instructions on anything but the products and adds.  Design:
// - one block of 256 threads per (image, strip of tw output columns, run
//   of seg rows); it walks down the run 16 output rows a step.  The
//   image's rows sit in a ring of 16 + 2n rows (rounded up to 4) of a
//   128-column span in shared memory: the strip plus n4 = n rounded up to
//   4 columns each side, so every 16-byte copy is aligned.  40 KB of shared
//   memory and 64 registers a thread at n = 5: four blocks an SM.  The plan
//   (tw, a multiple of 8 so that every strip's rows start on a 32-byte
//   sector; seg, by the rows of the busiest slot) is ops/flow.py::_poly_plan's.
// - rows arrive once a run by 16-byte cp.async (4-byte copies, clamped, at
//   the image's edges or for widths that are not a multiple of 4); the
//   next step's 16 rows go into the slots of the 16 the vertical pass no
//   longer needs and land while the step's horizontal pass runs.
// - vertical sums: a thread takes a column and 8 rows and slides a window
//   of 8 registers down the column one row a tap (one shared load a tap
//   for 24 products and adds), and writes its three sums to rows of
//   vertical sums shifted by n4 - n, so the horizontal pass reads aligned
//   16-byte chunks.
// - horizontal sums: a thread forms 4 consecutive outputs of a row from
//   16-byte chunks of each plane's row (v0's chunks feed three sums, v1's
//   two, v2's one), combines them in registers and stores each of the five
//   planes with one 16-byte store, a warp writing up to 448 contiguous bytes.
// - n = 5 (the flow's poly_n) takes an instantiation whose loops unroll, so
//   every coefficient is an operand from the constant bank and no index is
//   computed; other radii take the run-time-radius instantiation, whose
//   coefficients are constant-bank loads.  The radius is at most 60: the
//   128-column span then holds a strip of 8 columns and its halo (the ring
//   takes 70 KB of the 227 a block may have).

#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int PT = 256;                            // threads a block
constexpr int PTH = 16;                            // output rows a step
constexpr int PRS = 128;                           // staged columns a ring row: tw + 2 n4 <= PRS
constexpr int NMAX = 60;                           // largest radius: n4 = 60 leaves a strip of 8
constexpr int TMAX = 2 * NMAX + 1;                 // taps of the largest radius
constexpr int VR = PTH * PRS / PT;                 // rows a thread sums in the vertical pass
constexpr int VS = PRS + 4;                        // vertical-sum row stride
constexpr int HR = (PTH * PRS / 4 + PT - 1) / PT;  // 4-pixel runs a thread, at most
constexpr int SPECIAL = 5;                         // the radius with an unrolled instantiation
static_assert(VR % 4 == 0 && VR * PT == PTH * PRS && PRS % 32 == 0, "a (column, VR rows) item a thread");

// The kernel's coefficients, by value: taps g, x g, x^2 g (k[0], k[1],
// k[2]; entries 0 .. 2n), each rounded to f32, and the inverse-Gram factors.
struct PolyArgs {
  float k[3][TMAX];
  float ig11, ig03, ig33, ig55;
};

// ring rows a block: one step's window, a multiple of 4
__host__ __device__ constexpr int ring_rows(int n) { return (PTH + 2 * n + 3) & ~3; }
constexpr size_t smem_bytes(int n) { return sizeof(float) * ((size_t)ring_rows(n) * PRS + 3 * PTH * VS); }

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

// ``n`` rows of the image (rows y0 .. y0 + n - 1, clamped: the replicate
// border) into ring slots slot0, slot0 + 1, ... (mod rows); columns gx0 ..
// gx0 + span - 1, clamped.  A thread keeps one 16-byte column chunk and
// walks rows.
__device__ __forceinline__ void stage_rows(float* ring, const float* img, int H, int W, int y0, int gx0,
                                           int span, int n, int slot0, int rows, bool vec) {
  constexpr int C4 = PRS / 4, LANES = PT / C4;
  const int lane = threadIdx.x / C4, cc = 4 * (threadIdx.x % C4);
  if (cc >= span) return;
  const int gx = gx0 + cc;
  const bool whole = vec && gx >= 0 && gx + 4 <= W;
  int slot = slot0 + lane;
  if (slot >= rows) slot -= rows;
  for (int i = lane; i < n; i += LANES) {
    const float* row = img + (long long)min(max(y0 + i, 0), H - 1) * W;
    float* dst = ring + slot * PRS + cc;
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

// s = s + c u, rounded as the plain version rounds it
__device__ __forceinline__ float tap(float s, float c, float u) { return __fadd_rn(s, __fmul_rn(c, u)); }

// Taps t0 .. t0 + J - 1 from J consecutive ring rows of a column (never
// across the wrap): tap t loads u(t + VR - 1) into w[(t - 1) % VR] and
// adds coefficient t times u(y + t) = w[(y + t) % VR] to output y of each
// of the three sums; ``at`` is (t0 - 1) % VR.  Every caller's loops are
// unrolled, so ``at`` and the register indices are constants.
template <int J>
__device__ __forceinline__ void vtaps(float (&s)[3][VR], float (&w)[VR], const float* src, int at, int t0,
                                      const PolyArgs& a) {
  float u[J];
#pragma unroll
  for (int j = 0; j < J; ++j) u[j] = src[j * PRS];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    w[at + j] = u[j];
    const float c0 = a.k[0][t0 + j], c1 = a.k[1][t0 + j], c2 = a.k[2][t0 + j];
#pragma unroll
    for (int y = 0; y < VR; ++y) {
      const float v = w[(y + at + j + 1) % VR];
      s[0][y] = tap(s[0][y], c0, v);
      s[1][y] = tap(s[1][y], c1, v);
      s[2][y] = tap(s[2][y], c2, v);
    }
  }
}

// s[k][y] = sum over t = 0 .. 2n of a.k[k][t] u(y + t) for y < VR, from +0
// in tap order: u(v) is ring row slot + v (mod rows) of column ``col``.  A
// window of VR registers slides down the column one row a tap.  With NC > 0
// (the radius a constant) every loop unrolls.
template <int NC>
__device__ __forceinline__ void vsums(float (&s)[3][VR], const float* col, int slot, int rows, int n,
                                      const PolyArgs& a) {
  float w[VR];
#pragma unroll
  for (int b = 0; b < VR / 4; ++b) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[4 * b + j] = col[(slot + j) * PRS];
    slot = next4(slot, rows);
  }
#pragma unroll
  for (int y = 0; y < VR; ++y) {
    s[0][y] = tap(0.0f, a.k[0][0], w[y]);
    s[1][y] = tap(0.0f, a.k[1][0], w[y]);
    s[2][y] = tap(0.0f, a.k[2][0], w[y]);
  }
  int t = 1;          // the next tap
  int left = 2 * n;   // taps left: even
#pragma unroll
  for (; left >= VR; left -= VR) {
#pragma unroll
    for (int b = 0; b < VR / 4; ++b) {
      vtaps<4>(s, w, col + slot * PRS, 4 * b, t, a);
      t += 4;
      slot = next4(slot, rows);
    }
  }
#pragma unroll
  for (int b = 0; b < VR / 4; ++b) {  // left is even and below VR
    if (4 * b + 4 <= left) {
      vtaps<4>(s, w, col + slot * PRS, 4 * b, t, a);
      t += 4;
      slot = next4(slot, rows);
    } else if (4 * b + 2 == left) {
      vtaps<2>(s, w, col + slot * PRS, 4 * b, t, a);
    }
  }
}

__device__ __forceinline__ void ld4(float (&c)[4], const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  c[0] = f.x;
  c[1] = f.y;
  c[2] = f.z;
  c[3] = f.w;
}

// Taps t0 .. t0 + J - 1 of outputs i < 4 of the S sums (coefficient rows
// 0 .. S - 1), from chunks A (values t0 .. t0 + 3) and B (the next 4).
template <int S, int J>
__device__ __forceinline__ void htaps(float (&s)[S][4], const float (&A)[4], const float (&B)[4], int t0,
                                      const PolyArgs& a) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float c = a.k[k][t0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[k][i] = tap(s[k][i], c, i + j < 4 ? A[i + j] : B[i + j - 4]);
    }
  }
}

// s[k][i] = sum over t = 0 .. 2n of a.k[k][t] v(i + t) for i < 4 and k < S,
// from +0 in tap order; v read from p (16-byte aligned) by 16-byte chunks.
// 2n + 1 = 4 G + r (r 1 or 3); reads v(0) .. v(4 G + 7).
template <int NC, int S>
__device__ __forceinline__ void hsums(float (&s)[S][4], const float* p, int n, const PolyArgs& a) {
  float A[4], B[4];
  ld4(A, p);
  ld4(B, p + 4);
  p += 8;
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[k][i] = 0.0f;
  int t = 0;
  int g = (2 * n + 1) >> 2;  // whole groups of 4 taps
#pragma unroll
  for (; g >= 2; g -= 2, p += 8) {  // two groups a trip, the chunks' roles swapped
    htaps<S, 4>(s, A, B, t, a);
    ld4(A, p);
    htaps<S, 4>(s, B, A, t + 4, a);
    ld4(B, p + 4);
    t += 8;
  }
  if (g) {
    htaps<S, 4>(s, A, B, t, a);
    ld4(A, p);
    if (n & 1) htaps<S, 3>(s, B, A, t + 4, a);
    else htaps<S, 1>(s, B, A, t + 4, a);
  } else if (n & 1) {
    htaps<S, 3>(s, A, B, t, a);
  } else {
    htaps<S, 1>(s, A, B, t, a);
  }
}

// Store 4 consecutive outputs of one plane: one 16-byte store, or those
// inside the image one by one.
__device__ __forceinline__ void store4(float* o, const float (&v)[4], int left, bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < left) o[i] = v[i];
  }
}

// grid: (strips of tw columns, runs of ``seg`` rows, images).  NC: the
// radius as a constant, or 0 for the run-time radius n_.
template <int NC>
__global__ void __launch_bounds__(PT, 4)
poly_expansion_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W, int n_, int tw,
                      int seg, bool vec, const __grid_constant__ PolyArgs a) {
  const int n = NC > 0 ? NC : n_;
  extern __shared__ __align__(16) float smem[];
  const int rows = ring_rows(n);
  float* const ring = smem;                // rows x PRS
  float* const vsum = smem + rows * PRS;   // 3 x PTH x VS: v0, v1, v2
  const int tid = threadIdx.x;
  const int n4 = (n + 3) & ~3, off = n4 - n, span = tw + 2 * n4;
  const int x0 = blockIdx.x * tw, ys = blockIdx.y * seg, ye = min(ys + seg, H);
  const int steps = (ye - ys + PTH - 1) / PTH;
  const long long hw = (long long)H * W;
  const float* const src = img + (long long)blockIdx.z * hw;
  float* const dst = out + (long long)blockIdx.z * 5 * hw;

  // ring row r holds image row ys - n + r; step k reads rows [PTH k, PTH k + PTH + 2n)
  stage_rows(ring, src, H, W, ys - n, x0 - n4, span, PTH + 2 * n, 0, rows, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int vcol = tid % PRS, vy0 = VR * (tid / PRS);
  int hrow[HR], hx[HR];  // this thread's 4-pixel runs: row of the step, first column
#pragma unroll
  for (int e = 0; e < HR; ++e) {
    const int u = tid + PT * e;
    hrow[e] = u / (tw / 4);
    hx[e] = 4 * (u % (tw / 4));
  }
  int vslot = vy0;  // the slot of ring row PTH k + vy0
  for (int k = 0; k < steps; ++k) {
    if (vcol < span) {
      float s[3][VR];
      vsums<NC>(s, ring + vcol, vslot, rows, n, a);
      if (vcol >= off) {  // vsum row q holds column x0 - n + q
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int y = 0; y < VR; ++y) vsum[(c * PTH + vy0 + y) * VS + vcol - off] = s[c][y];
      }
    }
    // the vertical sums are complete, and the ring's oldest PTH rows free:
    // the next step's rows go there and land during the horizontal pass
    __syncthreads();
    if (k + 1 < steps)
      stage_rows(ring, src, H, W, ys - n + PTH * (k + 1) + 2 * n, x0 - n4, span, PTH,
                 (PTH * (k + 1) + 2 * n) % rows, rows, vec);
    cp_async_commit();
#pragma unroll
    for (int e = 0; e < HR; ++e) {
      const int y = ys + PTH * k + hrow[e], xb = x0 + hx[e];
      if (hrow[e] >= PTH || y >= ye || xb >= W) continue;
      const float* const v = vsum + hrow[e] * VS + hx[e];
      float* const o = dst + (long long)y * W + xb;
      const int left = W - xb;
      float c1[4], c2[4], c3[4], c4[4], c5[4];  // c_y, c_x, c_yy, c_xx, c_xy
      {
        float b[3][4];  // b1, b2, b4
        hsums<NC, 3>(b, v, n, a);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          c2[i] = __fmul_rn(b[1][i], a.ig11);
          c3[i] = __fmul_rn(b[0][i], a.ig03);  // b1 ig03, until b5 arrives
          c4[i] = __fadd_rn(c3[i], __fmul_rn(b[2][i], a.ig33));
        }
      }
      store4(o + hw, c2, left, vec);
      store4(o + 3 * hw, c4, left, vec);
      {
        float b[2][4];  // b3, b6
        hsums<NC, 2>(b, v + PTH * VS, n, a);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          c1[i] = __fmul_rn(b[0][i], a.ig11);
          c5[i] = __fmul_rn(b[1][i], a.ig55);
        }
      }
      store4(o, c1, left, vec);
      store4(o + 4 * hw, c5, left, vec);
      {
        float b[1][4];  // b5
        hsums<NC, 1>(b, v + 2 * PTH * VS, n, a);
#pragma unroll
        for (int i = 0; i < 4; ++i) c3[i] = __fadd_rn(c3[i], __fmul_rn(b[0][i], a.ig33));
      }
      store4(o + 2 * hw, c3, left, vec);
    }
    // this thread's copies have landed; after the barrier every thread sees
    // them, and the horizontal pass is done with the vertical sums
    cp_async_wait_all();
    __syncthreads();
    vslot += PTH;
    if (vslot >= rows) vslot -= rows;
  }
}

// The opt-in above 48 KB, once per device, at the largest size the
// run-time-radius kernel takes (n = NMAX); a CUDA error or 0.
int opt_in(int dev) {
  static PerDevice opted;
  return once_per_device(opted, dev, [] {
    return (int)cudaFuncSetAttribute(poly_expansion_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem_bytes(NMAX));
  });
}

}  // namespace

// img: (N, H, W) f32 -> out: (N, 5, H, W) f32; n in 1 .. 60; args: 3 x 121
// taps (g, x g, x^2 g, entries 0 .. 2n used) then ig11, ig03, ig33, ig55,
// f32 on the host; tw and seg: the plan of ops/flow.py::_poly_plan (tw a
// multiple of 4 (the plan's are of 8) with tw + 2 n4 <= 128, seg a multiple
// of 16).
extern "C" int relax_poly_expansion(const void* img, void* out, int N, int H, int W, int n, const void* args,
                                    int tw, int seg, void* stream) {
  const int n4 = (n + 3) & ~3;
  if (n < 1 || n > NMAX || N < 1 || N > 65535 || H < 1 || W < 1 || tw < 4 || tw % 4 != 0 ||
      tw + 2 * n4 > PRS || seg < PTH || seg % PTH != 0 || (H + seg - 1) / seg > 65535)
    return (int)cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  const int attr = opt_in(dev);
  if (attr != cudaSuccess) return attr;
  PolyArgs a;
  const float* f = (const float*)args;
  for (int k = 0; k < 3; ++k)
    for (int t = 0; t < TMAX; ++t) a.k[k][t] = f[k * TMAX + t];
  a.ig11 = f[3 * TMAX];
  a.ig03 = f[3 * TMAX + 1];
  a.ig33 = f[3 * TMAX + 2];
  a.ig55 = f[3 * TMAX + 3];
  // 16-byte copies and stores need 16-byte aligned rows
  const bool vec = W % 4 == 0 && ((uintptr_t)img | (uintptr_t)out) % 16 == 0;
  const dim3 grid((unsigned)((W + tw - 1) / tw), (unsigned)((H + seg - 1) / seg), (unsigned)N);
  if (n == SPECIAL)
    poly_expansion_kernel<SPECIAL><<<grid, PT, smem_bytes(n), (cudaStream_t)stream>>>(
        (const float*)img, (float*)out, H, W, n, tw, seg, vec, a);
  else
    poly_expansion_kernel<0><<<grid, PT, smem_bytes(n), (cudaStream_t)stream>>>(
        (const float*)img, (float*)out, H, W, n, tw, seg, vec, a);
  return (int)cudaGetLastError();
}

// The resident blocks on the current device of the kernel that takes radius
// n (SMs x blocks an SM); minus a CUDA error.
extern "C" int relax_poly_expansion_slots(int n) {
  if (n < 1 || n > NMAX) return -(int)cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return -(int)cudaErrorInvalidDevice;
  const int attr = opt_in(dev);
  if (attr != cudaSuccess) return -attr;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, n == SPECIAL ? (const void*)poly_expansion_kernel<SPECIAL> : (const void*)poly_expansion_kernel<0>,
      PT, smem_bytes(n));
  if (err != cudaSuccess) return -err;
  return sms * max(per_sm, 1);
}
