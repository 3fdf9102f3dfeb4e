// One level of the flow's image pyramid, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the pyramid of
// relaxtpu/ops/flow.py (a Gaussian blur of the base images, then
// jax.image.resize "linear" without antialias) to XLA.  In the port the
// same level ran as a separable correlation of the two full-resolution
// grey stacks (one pad and 4 (2R + 1) eager passes) and two dense f32
// matrix products (relaxtpu_torch/ops/flow.py::pyramid_level_plain).
// This kernel builds a level of both stacks in one launch: (P, H, W)
// uint8 or f32 prev and next grey images -> (2, P, hk, wk) f32.
//
// The plain version's arithmetic, which the kernel keeps.  Smoothing:
// BORDER_REFLECT_101 indices; the horizontal taps first, then the vertical
// ones; every sum starts from +0 and adds its taps j = 0 .. 2R in order,
// each tap one rounded product (tap rounded to f32) and one rounded add
// (__fmul_rn, __fadd_rn: no FMA contraction), so the smoothed values are
// bit for bit the plain version's.  Resize: rows, then columns, as
// resize_hw applies them; linear without antialias has at most two
// adjacent non-zero weights an output row or column (ops/resize.py::
// weight_matrix, the same f32 numbers), combined as a cuBLAS f32 product
// combines a row whose other weights are zero: the first weight's rounded
// product, then an FMA of the second; an axis whose size does not change
// is left alone (weights 1 and 0).
//
// What bounds it on the card: the bytes.  A level reads every grey pixel
// once (1 byte a pixel for uint8) and writes the level (4 bytes an output
// pixel); the smoothing is needed only where the resize samples it, 2 of
// every f columns and rows at a scale of 1/f, so a level costs a few
// rounded operations an input pixel.  Design:
// - one block of 256 threads per (image, strip of tw output columns, run of
//   seg output rows).  The block walks down the input rows that its run's
//   sampled rows need (plus the radius) in chunks of 32 rows: a chunk's
//   columns (the strip's sampled columns plus the radius, aligned down to
//   16 bytes) arrive by 16-byte cp.async into one of two buffers, the next
//   chunk's while this chunk is summed (element loads where the rows are
//   not 16-byte aligned).
// - horizontal pass: a thread keeps one sampled column (its plane and
//   output column) and walks the chunk's rows, 4 at a time (4 independent
//   chains of adds), summing 2R + 1 taps from
//   shared memory into a ring of 32 + 2R + 1 rows of horizontal sums, 1 or
//   2 planes (the c0 and c1 column of each output column) of tw floats: the
//   ring holds every row that an output row not yet finished can read.  Its
//   first 2R rows are mirrored after its end, so a window of 2R + 1 rows
//   never wraps.  A uint8 tap's byte becomes a float by a bitwise or and an
//   add (2^23 + b less 2^23): the card's int-to-float conversion issues at
//   an eighth of its add rate.
// - vertical pass and resize: after each chunk, the output rows whose last
//   vertical tap has arrived (a warp ballot over the row table) are
//   finished: a thread keeps 4 consecutive output columns (16-byte ring
//   loads) and walks those rows, forms the vertical sums at each row's (up
//   to) two sampled rows in each plane from the ring, combines rows then
//   columns and stores the 4 pixels with one 16-byte store; a warp stores
//   512 consecutive bytes.
// - the row and column tables ({i0, i1, w0 bits, w1 bits} an output row,
//   then an output column) are built on the host once a geometry; the taps
//   come by value and are read from the constant bank, which keeps them
//   off the shared-memory pipe that the passes' loads fill.  The flow's
//   radii, 1, 4 and 9 (its four levels), take instantiations whose
//   horizontal tap loops unroll, every tap an operand; other radii up to 79
//   (levels 6, the coarsest level of a 4K frame) the run-time one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int PT = 256;                  // threads a block
constexpr int CH = 32;                   // input rows a chunk
constexpr int RMAX = 79;                 // largest radius: 159 taps
constexpr int TMAX = 2 * RMAX + 1;
constexpr int TWMAX = 128;               // largest strip of output columns
constexpr int SMEM_MAX = 200 * 1024;     // dynamic shared memory a block may take

struct PyrArgs {
  float k[TMAX];  // taps 0 .. 2R, each rounded to f32
};

// the ring's rows, and the rows it keeps (its first 2R mirrored at its end)
__host__ __device__ constexpr int ring_rows(int r) { return CH + 2 * r + 1; }
__host__ __device__ constexpr int ring_kept(int r) { return ring_rows(r) + 2 * r; }
// two staging buffers of CH rows, then the ring
inline size_t smem_bytes(int elem, int r, int tw, int span, int planes) {
  return (size_t)2 * CH * span * elem + (size_t)ring_kept(r) * planes * tw * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// s + c u, rounded as the plain version rounds it
__device__ __forceinline__ float tap(float s, float c, float u) { return __fadd_rn(s, __fmul_rn(c, u)); }

// BORDER_REFLECT_101 for an index at most n - 1 outside [0, n)
__device__ __forceinline__ int reflect101(int x, int n) { return x < 0 ? -x : (x >= n ? 2 * n - 2 - x : x); }

// Items u = tid, tid + PT, ... < rows x per as (row, column) without a
// division an item: fn(i, x).
template <typename Fn>
__device__ __forceinline__ void by_rows(int rows, int per, Fn fn) {
  const int di = PT / per, dx = PT - di * per;
  int i = threadIdx.x / per, x = threadIdx.x - i * per;
  while (i < rows) {
    fn(i, x);
    i += di;
    x += dx;
    if (x >= per) {
      x -= per;
      ++i;
    }
  }
}

// ``nr`` rows of the image from row q, columns xa .. x1, into buf (a row
// every ``span`` elements): 16-byte cp.async pieces (xa and W multiples of
// 16 bytes, so no piece passes the row's end), or element loads.
template <typename T>
__device__ __forceinline__ void stage(T* buf, const T* src, int W, int q, int nr, int xa, int x1, int span,
                                      bool vec) {
  constexpr int VE = 16 / sizeof(T);
  const T* const from = src + (long long)q * W + xa;
  if (vec)
    by_rows(nr, (x1 - xa) / VE + 1, [&](int i, int m) {
      cp_async16(buf + i * span + m * VE, from + (long long)i * W + m * VE);
    });
  else
    by_rows(nr, x1 - xa + 1, [&](int i, int x) { buf[i * span + x] = from[(long long)i * W + x]; });
}

// a staged value as a float: a byte as 2^23 + b less 2^23 (exact)
__device__ __forceinline__ float value(uint8_t b) { return __uint_as_float(0x4B000000u | b) - 8388608.0f; }
__device__ __forceinline__ float value(float f) { return f; }

// The count of output rows from ``done`` (below oye) whose last vertical
// tap, row min(H - 1, i1 + R), is at most qe: a ballot of 32 rows a trip
// (the rows' ends do not decrease, so the rows that pass are a prefix).
// Every thread of the block calls it and gets the same count.
__device__ __forceinline__ int finished_rows(const int4* __restrict__ rows, int done, int oye, int qe, int R,
                                             int H) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (;;) {
    const int y = done + n + lane;
    const bool ok = y < oye && min(H - 1, __ldg(&rows[y].y) + R) <= qe;
    const int c = __popc(__ballot_sync(0xffffffffu, ok));
    n += c;
    if (c < 32) return n;
  }
}

// The ring slot of row q: base + q (base: the chunk's first slot less its
// first row) wrapped into [0, ring); q lies within 2R + 1 rows before the
// chunk and its last row, so one correction does.
__device__ __forceinline__ int slot_of(int base, int q, int ring) {
  const int sl = base + q;
  return sl < 0 ? sl + ring : (sl >= ring ? sl - ring : sl);
}

// The vertical sum at row r of one ring column (``col`` strided by
// ``stride`` floats a ring row): taps k[j] on rows reflect101(r - R + j),
// from +0 in tap order.  Inside the image the 2R + 1 rows are consecutive
// kept rows from the first one's slot (the mirror covers the wrap).
template <int NR>
__device__ __forceinline__ float4 vsum(const float* col, int stride, int r, int R_, int H, int base, int ring,
                                       const float* k) {
  const int R = NR > 0 ? NR : R_;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto add = [&](float c, const float* p) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    s = make_float4(tap(s.x, c, u.x), tap(s.y, c, u.y), tap(s.z, c, u.z), tap(s.w, c, u.w));
  };
  if (r - R >= 0 && r + R < H) {
    const float* const c = col + slot_of(base, r - R, ring) * stride;
#pragma unroll(NR == 1 ? 3 : 4)
    for (int j = 0; j <= 2 * R; ++j) add(k[j], c + j * stride);
  } else {
    for (int j = 0; j <= 2 * R; ++j) add(k[j], col + slot_of(base, reflect101(r - R + j, H), ring) * stride);
  }
  return s;
}

__device__ __forceinline__ float4 mul4(float w, float4 a) {
  return make_float4(__fmul_rn(w, a.x), __fmul_rn(w, a.y), __fmul_rn(w, a.z), __fmul_rn(w, a.w));
}
__device__ __forceinline__ float4 fma4(float w, float4 a, float4 b) {
  return make_float4(__fmaf_rn(w, a.x, b.x), __fmaf_rn(w, a.y, b.y), __fmaf_rn(w, a.z, b.z), __fmaf_rn(w, a.w, b.w));
}

// grid: (strips of tw output columns, runs of seg output rows, 2P images:
// prev's then next's).  tab: hk row entries then wk column entries, each
// {i0, i1, bits of w0, bits of w1}.  NR: the radius as a constant (the tap
// loops unroll), or 0 for the run-time radius R_.
template <typename T, int NR>
__global__ void __launch_bounds__(PT, NR == 1 ? 4 : 3)  // at 64 registers the others spill
pyramid_level_kernel(const T* __restrict__ prev, const T* __restrict__ next, float* __restrict__ out,
                     const int4* __restrict__ tab, int P, int H, int W, int hk, int wk, int R_, int lg_tw, int seg,
                     int span, int planes, bool vec, const __grid_constant__ PyrArgs a) {
  const int R = NR > 0 ? NR : R_;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int cidx[2][TWMAX];
  __shared__ float cwt[2][TWMAX];
  constexpr int VE = 16 / sizeof(T);
  const int tw = 1 << lg_tw, lg_cols = lg_tw + planes - 1, ring = ring_rows(R), stride = planes * tw;
  T* const raw = reinterpret_cast<T*>(smem);  // 2 buffers of CH rows x span
  float* const hs = reinterpret_cast<float*>(smem + (size_t)2 * CH * span * sizeof(T));  // kept ring x planes x tw
  const int4* const rows = tab;
  const int4* const cols = tab + hk;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * tw, ncols = min(tw, wk - x0);
  const int oys = blockIdx.y * seg, oye = min(oys + seg, hk);
  const int z = blockIdx.z;
  const T* const src = z < P ? prev + (long long)z * H * W : next + (long long)(z - P) * H * W;
  float* const dst = out + (long long)z * hk * wk;

  const float* const k = a.k;  // the taps: constant-bank operands (NR > 0) or uniform constant loads
  for (int t = tid; t < ncols; t += PT) {
    const int4 e = __ldg(&cols[x0 + t]);
    cidx[0][t] = e.x;
    cidx[1][t] = e.y;
    cwt[0][t] = __int_as_float(e.z);
    cwt[1][t] = __int_as_float(e.w);
  }
  // the strip's input columns and the run's input rows (reflected taps
  // land inside both: R < H and R < W)
  const int xa = max(0, __ldg(&cols[x0].x) - R) & ~(VE - 1);
  const int x1 = min(W - 1, __ldg(&cols[x0 + ncols - 1].y) + R);
  const int q0 = max(0, __ldg(&rows[oys].x) - R), q1 = min(H - 1, __ldg(&rows[oye - 1].y) + R);
  const int chunks = (q1 - q0) / CH + 1;
  stage(raw, src, W, q0, min(CH, q1 - q0 + 1), xa, x1, span, vec);
  cp_async_commit();
  __syncthreads();

  // horizontal pass: a thread keeps one (plane, output column) and walks
  // the chunk's rows, hg rows apart; vertical pass: 4 output columns (tw is
  // at least 4, so the ring's 16-byte loads are aligned), the finished rows
  // vg apart, 16-byte stores where the level's rows allow them
  const int hcol = tid & ((1 << lg_cols) - 1), hg = PT >> lg_cols, hp = hcol >> lg_tw, ht = hcol & (tw - 1);
  const bool hon = ht < ncols && (hp == 0 || cwt[1][ht] != 0.0f);
  const int hx = hon ? cidx[hp][ht] : 0;
  const bool hin = hx - R >= 0 && hx + R < W;
  const int lg_v = lg_tw - 2, vt = (tid & ((1 << lg_v) - 1)) << 2, vg = PT >> lg_v;
  const bool von = vt < ncols, vec_out = (wk & 3) == 0 && ((uintptr_t)out & 15) == 0 && vt + 4 <= ncols;
  float c0[4], c1[4];
  bool any1 = false;  // a column of the 4 reads plane 1
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool on = vt + e < ncols;
    c0[e] = on ? cwt[0][vt + e] : 0.0f;
    c1[e] = on ? cwt[1][vt + e] : 0.0f;
    any1 |= c1[e] != 0.0f;
  }

  int done = oys;  // the first output row not finished
  int slot0 = 0;   // the ring slot of the chunk's first row
  for (int c = 0; c < chunks; ++c) {
    const int qc = q0 + c * CH, nr = min(CH, q1 - qc + 1);
    // this chunk's rows have landed, and the last chunk's vertical pass is
    // done with the ring slots this one overwrites
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < chunks)
      stage(raw + ((c + 1) & 1) * CH * span, src, W, qc + CH, min(CH, q1 - qc - CH + 1), xa, x1, span, vec);
    cp_async_commit();

    if (hon) {
      // 4 rows at a time, hg apart: 4 independent sums a tap
      const T* const buf = raw + (c & 1) * CH * span + hx - R - xa;
      float* const hcolp = hs + (hp << lg_tw) + ht;
      for (int i = tid >> lg_cols; i < nr; i += 4 * hg) {
        const T* q[4];
        float s[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          q[e] = buf + min(i + e * hg, nr - 1) * span;
          s[e] = 0.0f;
        }
        if (hin) {
#pragma unroll(NR > 0 ? 2 * NR + 1 : 2)
          for (int j = 0; j <= 2 * R; ++j) {
            const float kj = k[j];
#pragma unroll
            for (int e = 0; e < 4; ++e) s[e] = tap(s[e], kj, value(q[e][j]));
          }
        } else {
          for (int j = 0; j <= 2 * R; ++j) {
            const float kj = k[j];
            const int x = reflect101(hx - R + j, W) - hx + R;
#pragma unroll
            for (int e = 0; e < 4; ++e) s[e] = tap(s[e], kj, value(q[e][x]));
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (i + e * hg >= nr) break;
          int sl = slot0 + i + e * hg;
          if (sl >= ring) sl -= ring;
          hcolp[sl * stride] = s[e];
          if (sl < 2 * R) hcolp[(sl + ring) * stride] = s[e];  // the mirror
        }
      }
    }
    __syncthreads();

    const int n = finished_rows(rows, done, oye, qc + nr - 1, R, H);
    if (von) {
      const int base = slot0 - qc;
      for (int y = done + (tid >> lg_v); y < done + n; y += vg) {
        const int4 e = __ldg(&rows[y]);
        const float w0 = __int_as_float(e.z), w1 = __int_as_float(e.w);
        float4 v[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          v[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (p >= planes || (p == 1 && !any1)) continue;
          const float* const col = hs + (p << lg_tw) + vt;
          v[p] = mul4(w0, vsum<NR>(col, stride, e.x, R, H, base, ring, k));
          if (w1 != 0.0f) v[p] = fma4(w1, vsum<NR>(col, stride, e.y, R, H, base, ring, k), v[p]);
        }
        const float v0[4] = {v[0].x, v[0].y, v[0].z, v[0].w}, v1[4] = {v[1].x, v[1].y, v[1].z, v[1].w};
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i] = __fmul_rn(c0[i], v0[i]);
          if (c1[i] != 0.0f) o[i] = __fmaf_rn(c1[i], v1[i], o[i]);
        }
        float* const d = dst + (long long)y * wk + x0 + vt;
        if (vec_out) {
          *reinterpret_cast<float4*>(d) = make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (vt + i < ncols) d[i] = o[i];
        }
      }
    }
    done += n;
    slot0 += nr;
    if (slot0 >= ring) slot0 -= ring;
  }
}

template <typename T, int NR>
const void* fn() {
  return (const void*)pyramid_level_kernel<T, NR>;
}

template <typename T>
const void* kernel_for(int r) {
  switch (r) {
    case 1: return fn<T, 1>();
    case 4: return fn<T, 4>();
    case 9: return fn<T, 9>();
    default: return fn<T, 0>();
  }
}
const void* kernel_for(int elem, int r) { return elem == 1 ? kernel_for<uint8_t>(r) : kernel_for<float>(r); }

template <typename T>
void launch(dim3 grid, size_t smem, cudaStream_t s, const void* prev, const void* next, void* out, const int4* tab,
            int P, int H, int W, int hk, int wk, int R, int lg_tw, int seg, int span, int planes, bool vec,
            const PyrArgs& a) {
  const T *p = (const T*)prev, *n = (const T*)next;
  float* o = (float*)out;
  auto go = [&](auto kernel) {
    kernel<<<grid, PT, smem, s>>>(p, n, o, tab, P, H, W, hk, wk, R, lg_tw, seg, span, planes, vec, a);
  };
  switch (R) {
    case 1: go(pyramid_level_kernel<T, 1>); break;
    case 4: go(pyramid_level_kernel<T, 4>); break;
    case 9: go(pyramid_level_kernel<T, 9>); break;
    default: go(pyramid_level_kernel<T, 0>);
  }
}

// The opt-in above 48 KB for the four instantiations, once per device; a
// CUDA error or 0.
int opt_in(int dev) {
  static PerDevice opted;
  return once_per_device(opted, dev, [] {
    const int elems[] = {1, 4}, radii[] = {1, 4, 9, 0};
    for (int elem : elems)
      for (int r : radii) {
        const cudaError_t e = cudaFuncSetAttribute(kernel_for(elem, r), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   SMEM_MAX);
        if (e != cudaSuccess) return (int)e;
      }
    return 0;
  });
}

bool valid_plan(int elem, int R, int tw, int span, int planes) {
  const int ve = 16 / max(elem, 1);
  return (elem == 1 || elem == 4) && R >= 1 && R <= RMAX && tw >= 4 && tw <= TWMAX && (tw & (tw - 1)) == 0 &&
         (planes == 1 || planes == 2) && span >= 1 && span % ve == 0 &&
         smem_bytes(elem, R, tw, span, planes) <= (size_t)SMEM_MAX;
}

}  // namespace

// prev, next: (P, H, W) uint8 (elem 1) or f32 (elem 4); out: (2, P, hk, wk)
// f32; tab: (hk + wk) x int4 row then column entries {i0, i1, bits of w0,
// bits of w1} (ops/flow.py::_pyramid_axis) on the device; R in 1 .. 79,
// below H and W; taps: 159 f32 on the host (0 .. 2R used); tw (a power of
// two from 4 to 128), seg, span (a multiple of 16 bytes, at least every
// strip's staged columns) and planes (1 where wk == W, else 2): the plan
// of ops/flow.py::_pyramid_plan.
extern "C" int relax_pyramid_level(const void* prev, const void* next, void* out, const void* tab, int P, int H,
                                   int W, int hk, int wk, int R, int elem, const void* taps, int tw, int seg,
                                   int span, int planes, void* stream) {
  if (P < 1 || 2 * P > 65535 || !valid_plan(elem, R, tw, span, planes) || H <= R || W <= R || hk < 1 ||
      hk > H || wk < 1 || wk > W || seg < 1 || (hk + seg - 1) / seg > 65535)
    return (int)cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  const int attr = opt_in(dev);
  if (attr != cudaSuccess) return attr;
  PyrArgs a;
  const float* f = (const float*)taps;
  for (int t = 0; t < TMAX; ++t) a.k[t] = f[t];
  int lg_tw = 0;
  while ((1 << lg_tw) < tw) ++lg_tw;
  // 16-byte copies need 16-byte aligned rows
  const bool vec = W % (16 / elem) == 0 && ((uintptr_t)prev | (uintptr_t)next) % 16 == 0;
  const dim3 grid((unsigned)((wk + tw - 1) / tw), (unsigned)((hk + seg - 1) / seg), (unsigned)(2 * P));
  const size_t smem = smem_bytes(elem, R, tw, span, planes);
  if (elem == 1)
    launch<uint8_t>(grid, smem, (cudaStream_t)stream, prev, next, out, (const int4*)tab, P, H, W, hk, wk, R, lg_tw,
                    seg, span, planes, vec, a);
  else
    launch<float>(grid, smem, (cudaStream_t)stream, prev, next, out, (const int4*)tab, P, H, W, hk, wk, R, lg_tw,
                  seg, span, planes, vec, a);
  return (int)cudaGetLastError();
}

// The resident blocks on the current device of the instantiation that
// takes elem and R with ``smem`` bytes of dynamic shared memory (SMs x
// blocks an SM); minus a CUDA error.
extern "C" int relax_pyramid_level_slots(int elem, int R, int smem) {
  if ((elem != 1 && elem != 4) || R < 1 || R > RMAX || smem < 0 || smem > SMEM_MAX)
    return -(int)cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return -(int)cudaErrorInvalidDevice;
  const int attr = opt_in(dev);
  if (attr != cudaSuccess) return -attr;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(elem, R), PT, smem);
  if (err != cudaSuccess) return -err;
  return sms * max(per_sm, 1);
}
