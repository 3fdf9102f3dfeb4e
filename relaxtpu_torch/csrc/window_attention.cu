// K4: Video Swin's shifted-window attention with FAST-VQA's gated
// relative-position bias, for Hopper (sm_90a).  Replaces no Pallas kernel
// (the JAX package runs no windowed attention): it was added for FAST-VQA
// (arXiv 2207.02595), whose Video Swin-T backbone spends most of its device
// time here.  The math and the plain version are in
// relaxtpu_torch/ops/window_attention.py.  Per window of N = wd wh ww tokens
// and head (head width 32):
//   logits[i][j] = q_i . k_j * scale + B[i][j] + M[i][j]
//   B = the intra table at idx(i, j) where i and j lie in one mini-patch,
//       the cross table elsewhere (one table without the gate)
//   M = -100 where i and j lie in different regions of the rolled grid
//       (a shifted block), 0 elsewhere
//   o_i = softmax_j(logits[i]) V
//
// What is scarce.  At FAST-VQA's shapes (4 views of a 16 x 56 x 56 token
// grid at stage 1: 512 windows of 392 tokens, 3 heads) one call computes
// 236 M scores: 30 GFLOP of products (0.03 ms at 989 TFLOP/s) on 154 MB of
// q, k, v and o (0.046 ms at 3.35 TB/s).  With a head width of 32 the
// products are 128 operations a score, so the work done once a score (the
// bias, the gate, the mask, the softmax's exponential and sums) and not the
// tensor cores bounds it: an SM's 128 lanes and 16 exponentials a clock
// against ~32 scores a clock of mma.sync.  Done eagerly the bias, gate and
// mask are N x N tensors a window and head (944 MB in f32 for the scores
// alone at stage 1), several times over.
//
// Design.
//   1. No tensor of pairs, no window copy: a block takes one (view, window,
//      head, query part).  It finds each of its tokens in the unrolled grid
//      from integer coordinates (window, local position, the roll by
//      -shift folded in: the token at rolled coordinate c is the grid's
//      token (c + shift) mod L), stages the window's K and V rows (16-byte
//      cp.async from the packed qkv projection, rows padded to 40 elements
//      so every ldmatrix is free of bank conflicts) and the head's column
//      of the tables (intra, cross) as one float2 a row, prescaled by
//      log2(e), in shared memory, and writes o to the grid.
//   2. One 32-bit code a token: the relative-position index part rel
//      (12 bits: idx = rel_i - rel_j + offset), the mini-patch id (14 bits)
//      and the region (5 bits).  A pair then costs one subtraction and one
//      8-byte shared load for both tables, and two xor-and tests for the
//      gate and the mask.  The keys' codes sit in shared memory, the
//      queries' in registers.  Neighbouring lanes hold neighbouring tokens,
//      so the table loads of a warp fall on a few consecutive rows.
//   3. One pass with online rescaling (the scores are never stored): a warp
//      takes two 16-query tiles and walks the keys in chunks of 32;
//      S = Q K^T by mma.sync.m16n8k16 (bf16 in, f32 out; Q fragments loaded
//      once to registers, K through ldmatrix, each K fragment feeding both
//      tiles), then s2 = S scale log2(e) + bias2 (+ mask2), the running row
//      max and sum, P = 2^(s2 - max) by ex2.approx, packed to bf16 straight
//      from the accumulators into the A operand of P V (V through
//      ldmatrix.trans).  O is divided by the row sum once, at the end.  The
//      shift mask and the gate are template switches, so an unshifted block
//      or an ungated stage does no work for them.
//   4. Occupancy: 7 warps (14 query tiles) a block, two query parts a window
//      at N = 392 (13 + 12 tiles), 86 KB of shared memory, at most 144
//      registers a thread: two blocks an SM.
// Softmax numerics: scores and sums in f32, P rounded to bf16 for P V, the
// output rounded to bf16; the plain version keeps P in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HD = 32;              // head width
constexpr int KROW = HD + 8;        // shared row of K or V, in bf16 elements (80 bytes)
constexpr int WARPS = 7;
constexpr int TILES = 2;            // 16-query tiles a warp
constexpr int THREADS = WARPS * 32;
constexpr int MAX_TOKENS = 512;     // window volume
constexpr int MAX_TABLE = 4096;     // table rows: the index fits 12 bits
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK2 = -100.0f * LOG2E;  // Video Swin's -100, in base-2 units
constexpr uint32_t REL_BITS = 0xFFFu;
constexpr uint32_t PATCH_BITS = 0x3FFFu << 12;
constexpr uint32_t REGION_BITS = 0x1Fu << 26;

struct Geometry {
  int B, D, H, W;         // views and the token grid
  int wd, wh, ww;         // window
  int sd, sh, sw;         // shift (the grid rolled by -shift before the partition)
  int heads, patch;       // patch: mini-patch side in tokens, 0 without the gate
  int n, npad;            // tokens a window, padded to 16
  int nwh, nww, nwin;     // windows along h and w, and a view's windows
  int table, offset;      // table rows; idx = rel_i - rel_j + offset
  int parts, part_tiles;  // query parts a (window, head); 16-query tiles a part
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Along one axis: the region of rolled coordinate c (0 unless shifted) and
// the unrolled coordinate.
__device__ __forceinline__ int region_of(int c, int size, int win, int s) {
  return s ? (c >= size - win) + (c >= size - s) : 0;
}
__device__ __forceinline__ int unrolled(int c, int s, int size) {
  const int o = c + s;
  return o >= size ? o - size : o;
}

// Token i of window (wdi, whi, wwi) of view b -> its row of the grid and its code.
__device__ __forceinline__ void token(const Geometry& g, int b, int wdi, int whi, int wwi, int i,
                                      long long& row, uint32_t& code) {
  const int hw = g.wh * g.ww;
  const int ld = i / hw;
  const int r = i - ld * hw;
  const int lh = r / g.ww;
  const int lw = r - lh * g.ww;
  const int cd = wdi * g.wd + ld, ch = whi * g.wh + lh, cw = wwi * g.ww + lw;
  const int od = unrolled(cd, g.sd, g.D), oh = unrolled(ch, g.sh, g.H), ow = unrolled(cw, g.sw, g.W);
  row = (long long)b * g.D * g.H * g.W + ((long long)od * g.H + oh) * g.W + ow;
  const uint32_t rel = (uint32_t)((ld * (2 * g.wh - 1) + lh) * (2 * g.ww - 1) + lw);
  const uint32_t region = (uint32_t)((region_of(cd, g.D, g.wd, g.sd) * 3 + region_of(ch, g.H, g.wh, g.sh)) * 3 +
                                     region_of(cw, g.W, g.ww, g.sw));
  const uint32_t pid = g.patch ? (uint32_t)(((oh / g.patch) & 127) | (((ow / g.patch) & 127) << 7)) : 0u;
  code = rel | (pid << 12) | (region << 26);
}

template <int MT, bool SHIFTED, bool GATED>
__device__ __forceinline__ void attend(const Geometry& g, const bf16* __restrict__ qkv, bf16* __restrict__ out,
                                       const bf16* ks, const bf16* vs, const float2* tab, const uint32_t* kcode,
                                       int b, int wdi, int whi, int wwi, int h, int tile0, float scale2) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, c4 = lane & 3;
  const int C = g.heads * HD;
  const long long rs = 3LL * C;  // qkv row stride

  uint32_t qf[MT][2][4];
  uint32_t qc[MT][2];
  int qb[MT][2];
  long long qrow[MT][2];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = (tile0 + t) * 16 + g8 + half * 8;
      long long row = -1;
      uint32_t code = 0;
      if (i < g.n) token(g, b, wdi, whi, wwi, i, row, code);
      qrow[t][half] = row;
      qc[t][half] = code;
      qb[t][half] = (int)(code & REL_BITS) + g.offset;
      const bf16* q = qkv + (row < 0 ? 0 : row) * rs + h * HD + 2 * c4;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        qf[t][k][half] = row < 0 ? 0u : *reinterpret_cast<const uint32_t*>(q + k * 16);
        qf[t][k][2 + half] = row < 0 ? 0u : *reinterpret_cast<const uint32_t*>(q + k * 16 + 8);
      }
    }
  }

  float o[MT][4][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int d = 0; d < 4; ++d) o[t][d][0] = o[t][d][1] = o[t][d][2] = o[t][d][3] = 0.f;
    m[t][0] = m[t][1] = -INFINITY;
    l[t][0] = l[t][1] = 0.f;
  }

  for (int kc = 0; kc < g.n; kc += 32) {
    float s[MT][4][4];
    // S = Q K^T over two groups of 16 keys (four of 8)
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      if (kc + grp * 16 < g.n) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t kb[4];
          ldmatrix_x4(kb, ks + (kc + grp * 16 + nt * 8 + (lane & 7)) * KROW + (lane >> 3) * 8);
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            float* acc = s[t][grp * 2 + nt];
            acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
            mma_bf16(s[t][grp * 2 + nt], qf[t][0], kb[0], kb[1]);
            mma_bf16(s[t][grp * 2 + nt], qf[t][1], kb[2], kb[3]);
          }
        }
      }
    }
    // logits in base 2: S scale log2(e) + the gated bias (+ the mask); keys past N out
    const bool tail = kc + 32 > g.n;
#pragma unroll
    for (int nq = 0; nq < 4; ++nq) {
      const int j0 = kc + nq * 8 + 2 * c4;
      const uint2 kcd = *reinterpret_cast<const uint2*>(kcode + j0);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t kcode_j = e ? kcd.y : kcd.x;
            float& x = s[t][nq][half * 2 + e];
            if (tail && j0 + e >= g.n) {
              x = -INFINITY;
              continue;
            }
            const float2 tb = tab[qb[t][half] - (int)(kcode_j & REL_BITS)];
            const uint32_t diff = qc[t][half] ^ kcode_j;
            const float bias = (GATED && (diff & PATCH_BITS)) ? tb.y : tb.x;
            x = fmaf(x, scale2, bias);
            if (SHIFTED && (diff & REGION_BITS)) x += MASK2;
          }
        }
      }
    }
    // online softmax: raise the running max, rescale O and the sum, P = 2^(s2 - max)
#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = m[t][half];
#pragma unroll
        for (int nq = 0; nq < 4; ++nq) mx = fmaxf(mx, fmaxf(s[t][nq][half * 2], s[t][nq][half * 2 + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = ex2(m[t][half] - mx);
        m[t][half] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nq = 0; nq < 4; ++nq) {
          s[t][nq][half * 2] = ex2(s[t][nq][half * 2] - mx);
          s[t][nq][half * 2 + 1] = ex2(s[t][nq][half * 2 + 1] - mx);
          sum += s[t][nq][half * 2] + s[t][nq][half * 2 + 1];
        }
        l[t][half] = l[t][half] * alpha + sum;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          o[t][d][half * 2] *= alpha;
          o[t][d][half * 2 + 1] *= alpha;
        }
      }
    }
    // O += P V, a group of 16 keys at a time
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      if (kc + grp * 16 < g.n) {
        uint32_t vb[2][4];
        const bf16* vrow = vs + (kc + grp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KROW + (lane >> 4) * 8;
        ldmatrix_x4_trans(vb[0], vrow);       // dims 0-15
        ldmatrix_x4_trans(vb[1], vrow + 16);  // dims 16-31
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const float* p0 = s[t][grp * 2];
          const float* p1 = s[t][grp * 2 + 1];
          const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]), pack_bf16(p1[0], p1[1]),
                                 pack_bf16(p1[2], p1[3])};
#pragma unroll
          for (int d = 0; d < 4; ++d) mma_bf16(o[t][d], a, vb[d >> 1][(d & 1) * 2], vb[d >> 1][(d & 1) * 2 + 1]);
        }
      }
    }
  }

  // the row sums across the quad, then O / l into the grid
#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sum = l[t][half];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (qrow[t][half] < 0) continue;
      const float inv = 1.f / sum;
      bf16* dst = out + qrow[t][half] * C + h * HD + 2 * c4;
#pragma unroll
      for (int d = 0; d < 4; ++d)
        *reinterpret_cast<uint32_t*>(dst + d * 8) = pack_bf16(o[t][d][half * 2] * inv, o[t][d][half * 2 + 1] * inv);
    }
  }
}

template <bool SHIFTED, bool GATED>
__global__ void __launch_bounds__(THREADS, 2)
    window_mha_kernel(const bf16* __restrict__ qkv, const float* __restrict__ t_intra,
                      const float* __restrict__ t_cross, bf16* __restrict__ out, Geometry g, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + g.npad * KROW;
  float2* tab = reinterpret_cast<float2*>(vs + g.npad * KROW);
  uint32_t* kcode = reinterpret_cast<uint32_t*>(tab + g.table);

  int blk = blockIdx.x;
  const int part = blk % g.parts;
  blk /= g.parts;
  const int h = blk % g.heads;
  blk /= g.heads;
  const int win = blk % g.nwin;
  const int b = blk / g.nwin;
  const int wdi = win / (g.nwh * g.nww);
  const int wr = win - wdi * g.nwh * g.nww;
  const int whi = wr / g.nww;
  const int wwi = wr - whi * g.nww;
  const int C = g.heads * HD;

  // K and V rows of the window's tokens (zero rows past N), their codes
  for (int it = threadIdx.x; it < g.npad * 4; it += THREADS) {
    const int j = it >> 2, c = it & 3;
    bf16* kd = ks + j * KROW + c * 8;
    bf16* vd = vs + j * KROW + c * 8;
    if (j < g.n) {
      long long row;
      uint32_t code;
      token(g, b, wdi, whi, wwi, j, row, code);
      const bf16* src = qkv + row * 3LL * C + C + h * HD + c * 8;
      cp_async16(kd, src);
      cp_async16(vd, src + C);
      if (c == 0) kcode[j] = code;
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
  // codes past the padded tokens: the last chunk of 32 keys reads them (and masks them out)
  for (int j = g.n + threadIdx.x; j < g.npad + 32; j += THREADS) kcode[j] = 0;
  asm volatile("cp.async.commit_group;\n" ::);
  // this head's column of the tables, in base 2
  for (int r = threadIdx.x; r < g.table; r += THREADS) {
    const float a = t_intra[(long long)r * g.heads + h] * LOG2E;
    tab[r] = make_float2(a, GATED ? t_cross[(long long)r * g.heads + h] * LOG2E : a);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int first = warp * TILES;  // tile of the part
  const int tile0 = part * g.part_tiles + first;
  int tiles = 0;
#pragma unroll
  for (int t = 0; t < TILES; ++t) tiles += (first + t < g.part_tiles && (tile0 + t) * 16 < g.n);
  if (tiles == 2)
    attend<2, SHIFTED, GATED>(g, qkv, out, ks, vs, tab, kcode, b, wdi, whi, wwi, h, tile0, scale2);
  else if (tiles == 1)
    attend<1, SHIFTED, GATED>(g, qkv, out, ks, vs, tab, kcode, b, wdi, whi, wwi, h, tile0, scale2);
}

size_t smem_bytes(int npad, int table) {
  return sizeof(bf16) * 2 * (size_t)npad * KROW + sizeof(float2) * (size_t)table + sizeof(uint32_t) * (size_t)(npad + 32);
}

template <bool SHIFTED, bool GATED>
cudaError_t launch(const Geometry& g, const void* qkv, const void* ti, const void* tc, void* out, float scale2,
                   cudaStream_t stream) {
  static PerDevice ready;
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  const size_t most = smem_bytes(MAX_TOKENS, MAX_TABLE);
  const int err = once_per_device(ready, dev, [&] {
    return (int)cudaFuncSetAttribute(window_mha_kernel<SHIFTED, GATED>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  });
  if (err != 0) return (cudaError_t)err;
  const long long blocks = (long long)g.B * g.nwin * g.heads * g.parts;
  window_mha_kernel<SHIFTED, GATED><<<(unsigned)blocks, THREADS, smem_bytes(g.npad, g.table), stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(ti), static_cast<const float*>(tc),
      static_cast<bf16*>(out), g, scale2);
  return cudaGetLastError();
}

}  // namespace

// qkv (B, D*H*W, 3 heads 32) bf16, the tables (T, heads) f32 (t_cross ==
// t_intra without the gate), out (B, D*H*W, heads 32) bf16.  The caller
// (ops/window_attention.py) has checked the geometry.
extern "C" int relax_window_mha_bf16(const void* qkv, const void* t_intra, const void* t_cross, void* out, int B,
                                     int D, int H, int W, int wd, int wh, int ww, int sd, int sh, int sw, int heads,
                                     int patch, float scale, void* stream) {
  Geometry g;
  g.B = B, g.D = D, g.H = H, g.W = W;
  g.wd = wd, g.wh = wh, g.ww = ww;
  g.sd = sd, g.sh = sh, g.sw = sw;
  g.heads = heads, g.patch = patch;
  g.n = wd * wh * ww;
  g.npad = (g.n + 15) & ~15;
  g.nwh = H / wh, g.nww = W / ww;
  g.nwin = (D / wd) * g.nwh * g.nww;
  g.table = (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1);
  g.offset = ((wd - 1) * (2 * wh - 1) + (wh - 1)) * (2 * ww - 1) + (ww - 1);
  const int tiles = (g.n + 15) / 16;
  g.parts = (tiles + WARPS * TILES - 1) / (WARPS * TILES);
  g.part_tiles = (tiles + g.parts - 1) / g.parts;
  if (g.n > MAX_TOKENS || g.table > MAX_TABLE || B < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  const float scale2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shifted = sd || sh || sw, gated = patch > 0;
  cudaError_t e;
  if (shifted)
    e = gated ? launch<true, true>(g, qkv, t_intra, t_cross, out, scale2, st)
              : launch<true, false>(g, qkv, t_intra, t_cross, out, scale2, st);
  else
    e = gated ? launch<false, true>(g, qkv, t_intra, t_cross, out, scale2, st)
              : launch<false, false>(g, qkv, t_intra, t_cross, out, scale2, st);
  return (int)e;
}
