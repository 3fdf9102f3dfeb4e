// K3: ViT multi-head attention, for Hopper (sm_90a).
//
// Replaces the Pallas kernel relaxtpu/ops/attention.py::_mha_kernel
// (launched by fused_mha), with the numerics of the einsum form at
// relaxtpu/models/vit.py:60-64: per (image, head)
//   S = Q K^T * scale, accumulated in f32; keys >= N masked to -inf;
//   exact row softmax in f32 (max, exp, sum, divide); P normalised, then
//   cast to the activation type; O = P V accumulated in f32, written in the
//   activation type.  The score rows never leave the SM.  N <= 256 means a
//   whole score row fits on chip, so the softmax is exact, not the online
//   (flash) rescaling, which would divide after P V and so round P to bf16
//   at another place than the JAX package.
//
// What bounds it on the card: at the ViT-B/16 shape (B=48, N=197, H=12,
// D=64) one call does ~5.7 GFLOP on ~58 MB of q/k/v/o.  In bf16 the bytes
// bound it (~17 us at 3.35 TB/s against ~6 us of tensor-core work); in f32,
// with TF32 off, the FMA rate does (~85 us at 67 TFLOP/s).
//
// bf16 design (bytes first: the L2-to-SM path, not the tensor cores, is
// what a per-tile kernel saturates here): one block of 4 warps per (image,
// head, 8 query tiles of 16), so N = 197 takes 2 blocks a head and the
// head's K and V (keys padded with zero rows to 16*KT, a compile-time bucket
// >= N) are staged in shared memory twice a head, not once a 16-query tile;
// 16-byte cp.async, V landing during the first round's Q K^T; rows padded to
// D+8 elements so every ldmatrix is free of bank conflicts.  Each warp takes
// one 16-query tile a round: its Q rows by 16-byte loads, Q K^T with
// mma.sync.m16n8k16 (bf16 in, f32 out; K through ldmatrix), the 16 x 16*KT
// score tile in registers, row max and row sum by quad shuffles, then the
// normalised P packed to bf16 straight from the accumulators into the A
// operand of P V (V through ldmatrix.trans).
//
// f32 design (strict parity: no TF32; the FMA rate bounds it):
// register-blocked FMAs.  One block of 192 threads per (image, head,
// 48-query tile) stages Q and K in shared memory (rows padded to D+4
// floats); each thread computes a 4-query x 8-key micro-tile of S (12
// 16-byte shared loads feed 128 FMAs), the scores go to shared memory
// key-major, V's load into K's buffer overlaps the softmax (4 threads a
// row), and P V runs as 4-query x D/16 micro-tiles.  At N = 197 a block
// takes ~110 KB, so two share an SM.
//
// Long rows (N > 256, or a head dim other than 32 and 64: fused_mha takes
// any N and D; the wrapper pads D with zeros to the next of 32, 64, 128 and
// 256).  A score row no longer fits on chip, so in bf16 (and in f32 at D =
// 128 and 256) the softmax runs in two passes over key tiles staged in
// shared memory: pass 1 computes S tile by tile and keeps each query row's
// running max m and sum l in f32; pass 2 recomputes S with the same
// sequence of products (so its max is pass 1's to the bit), forms P =
// exp(s - m) / l in f32, casts P to the activation type, and accumulates
// P V in f32 before O is written once.  Online (flash) rescaling of O would
// divide after P V and round P at another place than the JAX package; two
// passes keep its numerics for one more Q K^T.  In f32 no cast of P exists
// to be moved, so at D = 32 and 64 the f32 entry runs one pass (below).
// What bounds it at ViT-B/16 384x384, (48, 577, 12, 64): 170 MB of
// q/k/v/o (bf16: 0.0508 ms at 3.35 TB/s) and 4 B H N^2 D = 49 GFLOP of the
// function's work plus 25 GFLOP of recomputed scores (bf16: 0.075 ms at 989
// TFLOP/s); f32 with TF32 off is bound by the FMA rate (~0.73 ms).  Past
// the tensor cores, the exact softmax costs two exponentials a score (pass
// 1's sum, pass 2's P): ~0.12 ms of the SFU's 16 a clock an SM.
//
// bf16 at D = 32 and 64 (mha_bf16_ring_kernel).  A block of 4 warps takes
// 128 queries of one (image, head), 32 rows a warp.  Against the design
// that D = 128 and 256 keep (64-query blocks of 4 x 16 rows, Q's fragments
// reloaded from shared memory at every k-step, key tiles double-buffered by
// cp.async between two __syncthreads a tile: 0.59 ms at the shape above):
//   1. L2 re-reads of K and V (each 64-query block read K twice and V once,
//      ~1.3 GB a call): 128-query blocks halve them.
//   2. shared-memory reads per MMA: each warp loads its Q fragments once, to
//      registers, for both passes; each K fragment (ldmatrix) and V fragment
//      (ldmatrix.trans) then feeds four mma.sync instead of two.
//   3. the lock-step pipeline: key tiles go round a ring of RSTAGES stages
//      with a "full" and an "empty" mbarrier a stage and no block-wide
//      barrier in the tile loop; a warp waits for its data and, before
//      refilling a stage after its tile, for the other warps to release it.
// The exponentials are base-2 with the scale folded in, c = scale log2(e):
// pass 1 sums 2^(c s - c m), pass 2 forms P = 2^(c s - c m - log2 l), one
// FMA and one ex2.approx a score (f32, within a few ulp of exp(s - m) / l;
// P is rounded to bf16 after).  Every copy is a 16-byte cp.async whose
// completion arrives on an mbarrier (cp.async.mbarrier.arrive.noinc): a
// stage's for K and V, a warp's own for its 32 Q rows.  The bulk copy
// (cp.async.bulk, the TMA without a tensor map) moves one strided token row
// a copy here, and measured on the H100 it is the slower route, for K and V
// by half again and for Q by a few per cent
// (scripts/torch_k3_ring_variants.py; PERF.md).  165 registers at D = 64
// (120 at 32), no spills, 3 blocks an SM.
//
// bf16 at D = 128 and 256 (mha_bf16_long_kernel), where 32 rows a warp
// would hold 128 or 256 f32 accumulators alone and spill: a block of 4
// warps per (image, head, 64 queries), each warp 16 queries; key
// tiles (64 keys, 32 at D = 256) double-buffered by 16-byte cp.async; Q K^T
// and P V by mma.sync.m16n8k16 through ldmatrix as in the short kernel,
// with the same per-score accumulation order.
//
// f32 at D = 32 and 64 (mha_f32_online_kernel): one pass with online
// rescaling.  Its bound at (48, 577, 12, 64): 4 B H N^2 D = 49 GFLOP of FMAs
// with TF32 off, 0.73 ms at 67 TFLOP/s (340 MB of q/k/v/o: 0.10 ms).  A
// block of 8 warps takes 128 queries; key tiles of 64, the last one cut to
// the narrowest of 32, 16 and 8 keys that holds the rest; a warp whose 16
// queries all lie past N computes nothing.  At N = 577 that is 592 x 584
// scores computed for 577 x 577, +3.8%.  Against the two-pass design that
// D = 128 and 256 keep (32-query blocks; 3.89 ms at the shape above on an
// H100 at 700 W), per cause:
//   1. recomputed scores and three transcendental-heavy steps a score: one
//      pass keeps each row's running max (scaled, mc = c max s with c =
//      scale log2(e)) and each lane's partial sum, and per key tile raises
//      the max, rescales the sums and the O accumulators by 2^(mc_old -
//      mc_new) and adds P = 2^(c s - mc) (one FMA and one ex2.approx a
//      score, within a few ulp) and P V; O is divided by the row sum once,
//      an output.  74 -> 49 GFLOP, one exponential a score, no divide.
//   2. thin micro-tiles: a thread holds 4 queries x 8 keys of S (4 x 8
//      output dims in P V).  Q is staged once a block, transposed (Q^T[d]
//      [q]: 4 queries in one 16-byte load); K and V stay token-major, so
//      cp.async stages them as they lie and one 16-byte load holds 4 dims of
//      a key.  Per 4 dims, 4 Q loads and 8 K loads feed 128 FMAs; per key, 1
//      P load and 2 V loads feed 32: 10.7 FMAs a 16-byte load in both, each
//      warp-wide load one wavefront (8 distinct rows of D + 4 floats, or 4
//      consecutive Q^T / P columns, the rest broadcast).  A row's keys lie
//      in 8 lanes of one warp: its tile max is three shuffles, S never goes
//      to shared memory, and P goes once, key-major, to the warp's own tile.
//   3. the lock-step tile loop: one K and one V buffer, each refilled by
//      16-byte cp.async while the other is read (a tile's V lands during its
//      scores, the next tile's K during its P V), with the two barriers
//      that guard their reuse.  Two buffers of each (tile t + 1's K and V
//      during tile t, one barrier) double the buffers' shared memory (one
//      block an SM at D = 64) and measured slower on the H100.
//   128-query blocks read K and V 5 times a head at N = 577, not 19.  At
//   D = 64, 106 KB of shared memory a block; at D = 32, 74 KB; 2 blocks
//   (16 warps) an SM, at most 128 registers a thread.
//   scripts/torch_k3_f32_variants.py times the choices (queries a block,
//   registers, micro-tile, buffers, expf) against this source on the card.
//
// f32 at D = 128 and 256 (mha_f32_long_kernel, two passes, where one pass's
// 4 x D/8 accumulators a thread would spill): a block of 256 threads per
// (image, head, 32 queries); a thread forms 2 queries x the tile's keys /
// 16 scores by FMAs from shared memory, and in pass 2 writes P to shared
// memory key-major and accumulates 2 queries x D/16 output dims.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_N = 256;  // whole score rows on chip

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
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
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// a / b for the b that a whole row shares, given r = 1/b correctly rounded:
// q = a r rounded, the remainder a - q b exact by FMA, then q + rem r
// rounded, which is the correctly rounded quotient for normal operands
// (Markstein), at 3 operations instead of a full division each.
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ bf16
constexpr int QB = 8;  // 16-query tiles a bf16 block: 2 rounds of 4 warps; N = 197 takes 2

template <int D, int KT>
constexpr size_t bf16_smem() {
  return sizeof(bf16) * (size_t)(2 * 16 * KT + 4 * 16) * (D + 8);
}

// q, k, v: (B, N, H, D) sharing the element strides (sb, sn, D, 1), rows
// 16-byte aligned; o: contiguous (B, N, H, D).  N <= 16 * KT.  Block
// (x, h, b) takes query tiles QB x .. QB x + QB - 1 of (image b, head h).
template <int D, int KT>
__global__ void __launch_bounds__(128)
mha_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int N, int H, long long sb,
                long long sn, float scale) {
  constexpr int LD = D + 8;  // (D+8)*2 bytes = 16 x odd: ldmatrix rows on distinct banks
  constexpr int NP = 16 * KT;
  constexpr int CH = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // NP x LD
  bf16* vs = ks + NP * LD;                       // NP x LD
  const int h = blockIdx.y;
  const long long base = (long long)blockIdx.z * sb + (long long)h * D;
  const int tid = threadIdx.x;

  // The head's K (group 0) and V (group 1), once for the block's tiles; V
  // lands during the first round's Q K^T.  Rows past N are zero-filled
  // (inputs may sit beside NaN, and 0 x NaN is NaN in P V).
  for (int part = 0; part < 2; ++part) {
    bf16* const dst0 = part ? vs : ks;
    const bf16* const src = part ? v : k;
    for (int i = tid; i < NP * CH; i += 128) {
      const int tok = i / CH, c = (i % CH) * 8;
      if (tok < N)
        cp_async16(dst0 + tok * LD + c, src + base + (long long)tok * sn + c);
      else
        *reinterpret_cast<uint4*>(dst0 + tok * LD + c) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  }
  cp_async_wait<1>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* const qs = vs + NP * LD + warp * 16 * LD;  // this warp's 16 query rows
  const int last = min((int)(blockIdx.x + 1) * QB, (N + 15) / 16);
  for (int round = 0; round < (QB + 3) / 4; ++round) {  // the same count in every warp
    const int tile = blockIdx.x * QB + 4 * round + warp;
    const bool active = tile < last;  // warp-uniform
    const int r0 = 16 * tile;         // the tile's first query row
    float s[2 * KT][4];  // 16 x NP scores: n8 tile j holds keys 8j + 2t (+1), rows g and g + 8
    if (active) {
      for (int i = lane; i < 16 * CH; i += 32) {  // rows past N as zeros
        const int row = i / CH, c = (i % CH) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r0 + row < N)
          val = *reinterpret_cast<const uint4*>(q + base + (long long)(r0 + row) * sn + c);
        *reinterpret_cast<uint4*>(qs + row * LD + c) = val;
      }
      __syncwarp();
      uint32_t qa[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qa[kk], qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t kb[4];
          ldmatrix_x4(kb, ks + (16 * nt + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * nt], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * nt + 1], qa[kk], kb[2], kb[3]);
        }
      }
      // scale, mask, exact softmax; rows g (elements 0, 1) and g + 8 (2, 3)
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
        if (8 * j + 8 > N) {  // warp-uniform: only tiles that reach past N
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t + (e & 1) >= N) s[j][e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
        s[j][0] = expf(s[j][0] - mx0);  // exp(-inf) = 0 for masked keys
        s[j][1] = expf(s[j][1] - mx0);
        s[j][2] = expf(s[j][2] - mx1);
        s[j][3] = expf(s[j][3] - mx1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      const float rs0 = __frcp_rn(sum0), rs1 = __frcp_rn(sum1);
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
        s[j][0] = div_by(s[j][0], sum0, rs0);
        s[j][1] = div_by(s[j][1], sum0, rs0);
        s[j][2] = div_by(s[j][2], sum1, rs1);
        s[j][3] = div_by(s[j][3], sum1, rs1);
      }
    }
    if (round == 0) {  // V in, for every warp
      cp_async_wait<0>();
      __syncthreads();
    }
    if (active) {
      float acc[D / 8][4];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        // the accumulators of key tiles 2kk, 2kk+1 are the A fragment of P's k-step kk
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 16 +
                                    (lane >> 4) * 8);
          mma_bf16(acc[2 * dn], pa, vb[0], vb[1]);
          mma_bf16(acc[2 * dn + 1], pa, vb[2], vb[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row >= N) continue;
        bf16* op = o + (((long long)blockIdx.z * N + row) * H + h) * D + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(op + 8 * j) =
              pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
      }
    }
    __syncwarp();  // the next tile overwrites this warp's rows
  }
}

// ------------------------------------------------------------------- f32
constexpr int QTF = 48;             // queries per f32 block: two blocks fit an SM at N=197
constexpr int NTF = QTF / 4 * 16;   // threads: 4 queries x 16 key (or dim) lanes each

template <int D>
constexpr size_t f32_smem(int n) {
  // Q tile, K (then V), the scores key-major, two reduction rows
  return sizeof(float) * ((size_t)(QTF + n) * (D + 4) + (size_t)n * (QTF + 4) + 2 * 4 * QTF);
}

// s[i][m] += Q[4ty + i] . K[kc + tx + 16m] over all D, for m < MC; key rows
// read past N are clamped to N - 1 (their scores are never stored).
template <int D, int MC>
__device__ __forceinline__ void f32_scores(const float* qs, const float* ks, float* st, int kc,
                                           int N, float scale, int ty, int tx) {
  constexpr int LD = D + 4;
  constexpr int SLD = QTF + 4;
  float s[4][MC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < MC; ++m) s[i][m] = 0.0f;
  const float* kr[MC];
#pragma unroll
  for (int m = 0; m < MC; ++m) kr[m] = ks + min(kc + tx + 16 * m, N - 1) * LD;
  const float* qr = qs + 4 * ty * LD;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[4], kv[MC];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qr + i * LD + d);
#pragma unroll
    for (int m = 0; m < MC; ++m) kv[m] = *reinterpret_cast<const float4*>(kr[m] + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < MC; ++m) {
        s[i][m] = fmaf(qv[i].x, kv[m].x, s[i][m]);
        s[i][m] = fmaf(qv[i].y, kv[m].y, s[i][m]);
        s[i][m] = fmaf(qv[i].z, kv[m].z, s[i][m]);
        s[i][m] = fmaf(qv[i].w, kv[m].w, s[i][m]);
      }
  }
#pragma unroll
  for (int m = 0; m < MC; ++m) {
    const int key = kc + tx + 16 * m;
    if (key < N)
      *reinterpret_cast<float4*>(st + key * SLD + 4 * ty) =
          make_float4(s[0][m] * scale, s[1][m] * scale, s[2][m] * scale, s[3][m] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(NTF)
mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int N, int H, long long sb,
               long long sn, float scale) {
  constexpr int LD = D + 4;   // 16-byte rows; 8 consecutive rows hit 8 distinct bank quads
  constexpr int SLD = QTF + 4;
  constexpr int CH = D / 4;   // 16-byte chunks a row
  constexpr int DT = D / 16;  // output dims a thread in P V
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;           // QTF x LD
  float* kvs = qs + QTF * LD;  // N x LD: K, then V
  float* st = kvs + N * LD;    // N x SLD: scores, then P, key-major
  float* red = st + N * SLD;   // 2 x 4 x QTF
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * QTF;
  const long long base = (long long)blockIdx.z * sb + (long long)h * D;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < (QTF + N) * CH; i += NTF) {
    const int row = i / CH, c = (i % CH) * 4;
    const bool is_q = row < QTF;
    const int tok = is_q ? q0 + row : row - QTF;
    float* dst = is_q ? qs + row * LD + c : kvs + tok * LD + c;
    if (tok < N)
      cp_async16(dst, (is_q ? q : k) + base + (long long)tok * sn + c);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // S in chunks of 128 keys; the tail in 64, then 16 (197 -> 128 + 64 + 16)
  for (int kc = 0; kc < N;) {
    const int rem = N - kc;
    if (rem >= 128) {
      f32_scores<D, 8>(qs, kvs, st, kc, N, scale, ty, tx);
      kc += 128;
    } else if (rem > 16) {
      f32_scores<D, 4>(qs, kvs, st, kc, N, scale, ty, tx);
      kc += 64;
    } else {
      f32_scores<D, 1>(qs, kvs, st, kc, N, scale, ty, tx);
      kc += 16;
    }
  }
  __syncthreads();  // K no longer read: V goes into its buffer during the softmax
  for (int i = tid; i < N * CH; i += NTF) {
    const int tok = i / CH, c = (i % CH) * 4;
    cp_async16(kvs + tok * LD + c, v + base + (long long)tok * sn + c);
  }
  cp_async_commit();

  // exact row softmax: thread (part p, query qq) takes keys p, p+4, ...
  {
    const int p = tid / QTF, qq = tid % QTF;
    float mx = -INFINITY;
    for (int j = p; j < N; j += 4) mx = fmaxf(mx, st[j * SLD + qq]);
    red[p * QTF + qq] = mx;
    __syncthreads();
    mx = fmaxf(fmaxf(red[qq], red[QTF + qq]), fmaxf(red[2 * QTF + qq], red[3 * QTF + qq]));
    float sum = 0.0f;
    for (int j = p; j < N; j += 4) {
      const float e = expf(st[j * SLD + qq] - mx);
      st[j * SLD + qq] = e;
      sum += e;
    }
    red[(4 + p) * QTF + qq] = sum;
    __syncthreads();
    sum = red[4 * QTF + qq] + red[5 * QTF + qq] + red[6 * QTF + qq] + red[7 * QTF + qq];
    const float rsum = __frcp_rn(sum);
    for (int j = p; j < N; j += 4) st[j * SLD + qq] = div_by(st[j * SLD + qq], sum, rsum);
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DT; ++e) acc[i][e] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < N; ++j) {
    const float4 pj = *reinterpret_cast<const float4*>(st + j * SLD + 4 * ty);
    const float pv[4] = {pj.x, pj.y, pj.z, pj.w};
    float vv[DT];
    if constexpr (DT == 4) {
      const float4 t4 = *reinterpret_cast<const float4*>(kvs + j * LD + DT * tx);
      vv[0] = t4.x, vv[1] = t4.y, vv[2] = t4.z, vv[3] = t4.w;
    } else {
      const float2 t2 = *reinterpret_cast<const float2*>(kvs + j * LD + DT * tx);
      vv[0] = t2.x, vv[1] = t2.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < DT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= N) continue;
    float* op = o + (((long long)blockIdx.z * N + row) * H + h) * D + DT * tx;
#pragma unroll
    for (int e = 0; e < DT; e += 2)
      *reinterpret_cast<float2*>(op + e) = make_float2(acc[i][e], acc[i][e + 1]);
  }
}

// ------------------------------------------------------------- long rows
template <int D>
__host__ __device__ constexpr int long_keys() {  // keys a tile, in both types
  return D >= 256 ? 32 : 64;
}

// rows [r0, r0 + ROWS) of a (B, N, H, D) operand into ``dst`` (row stride
// D + one 16-byte chunk; rows past N as zeros: 0 x NaN is NaN in P V), by
// 16-byte cp.async over a block of THREADS
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long base, long long sn,
                                           int r0, int N) {
  constexpr int E = 16 / sizeof(T), LD = D + E, CH = D / E;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * E;
    if (r0 + r < N)
      cp_async16(dst + r * LD + c, src + base + (long long)(r0 + r) * sn + c);
    else
      *reinterpret_cast<uint4*>(dst + r * LD + c) = make_uint4(0, 0, 0, 0);
  }
}

constexpr int LQ = 64;  // queries a long bf16 block: 4 warps x 16

template <int D>
constexpr size_t bf16_long_smem() {  // Q tile, two K tiles, two V tiles
  return sizeof(bf16) * (size_t)(LQ + 4 * long_keys<D>()) * (D + 8);
}

template <int D, int ROWS>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, long long base,
                                           long long sn, int r0, int N) {
  stage_rows<bf16, D, ROWS, 128>(dst, src, base, sn, r0, N);
}

// s = Q K^T * scale for a warp's 16 queries (rows of qs) and KN keys (rows
// of ks, the first being key ``key0``); keys >= N masked to -inf.  n8 tile
// j holds keys 8j + 2t (+1) of rows g and g + 8, as in the short kernel,
// and each score sums its k-steps in the short kernel's order.
template <int D, int KN>
__device__ __forceinline__ void long_scores(float (&s)[KN / 8][4], const bf16* qs, const bf16* ks,
                                            int key0, int N, float scale, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < KN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4];
    ldmatrix_x4(qa, qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < KN / 16; ++nt) {
      uint32_t kb[4];
      ldmatrix_x4(kb, ks + (16 * nt + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * nt], qa, kb[0], kb[1]);
      mma_bf16(s[2 * nt + 1], qa, kb[2], kb[3]);
    }
  }
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < KN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= scale;
      if (key0 + 8 * j + 2 * t + (e & 1) >= N) s[j][e] = -INFINITY;
    }
}

// q, k, v: (B, N, H, D) sharing the element strides (sb, sn, D, 1), rows
// 16-byte aligned; o: contiguous (B, N, H, D).  Block (x, h, b) takes
// queries LQ x .. LQ x + LQ - 1 of (image b, head h).
template <int D>
__global__ void __launch_bounds__(128)
mha_bf16_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int N, int H,
                     long long sb, long long sn, float scale) {
  constexpr int KN = long_keys<D>();
  constexpr int LD = D + 8;  // ldmatrix rows on distinct banks, as in the short kernel
  constexpr int NJ = KN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw);  // LQ x LD
  bf16* const kbuf = qs + LQ * LD;                     // 2 x KN x LD
  bf16* const vbuf = kbuf + 2 * KN * LD;               // 2 x KN x LD
  const int h = blockIdx.y;
  const long long base = (long long)blockIdx.z * sb + (long long)h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * LQ;
  const int tiles = (N + KN - 1) / KN;
  const bf16* const qw = qs + warp * 16 * LD;  // this warp's 16 queries

  stage_bf16<D, LQ>(qs, q, base, sn, q0, N);
  stage_bf16<D, KN>(kbuf, k, base, sn, 0, N);
  cp_async_commit();

  // pass 1: running max and sum of rows g (index 0) and g + 8 (index 1)
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {  // the next tile lands during this one
      stage_bf16<D, KN>(kbuf + ((it + 1) & 1) * KN * LD, k, base, sn, KN * (it + 1), N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[NJ][4];
    long_scores<D, KN>(s, qw, kbuf + (it & 1) * KN * LD, KN * it, N, scale, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) tm = fmaxf(tm, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
      const float m = fmaxf(mx[half], tm);  // finite: every tile holds a key < N
      float ts = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) ts += expf(s[j][2 * half] - m) + expf(s[j][2 * half + 1] - m);
      ts += __shfl_xor_sync(0xffffffffu, ts, 1);
      ts += __shfl_xor_sync(0xffffffffu, ts, 2);
      sum[half] = sum[half] * expf(mx[half] - m) + ts;
      mx[half] = m;
    }
    __syncthreads();  // the tile's buffer is free for the tile after next
  }

  // pass 2: P = exp(s - m) / l in f32, cast to bf16; O = P V in f32
  stage_bf16<D, KN>(kbuf, k, base, sn, 0, N);
  stage_bf16<D, KN>(vbuf, v, base, sn, 0, N);
  cp_async_commit();
  const float rs[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      const int nb = ((it + 1) & 1) * KN * LD;
      stage_bf16<D, KN>(kbuf + nb, k, base, sn, KN * (it + 1), N);
      stage_bf16<D, KN>(vbuf + nb, v, base, sn, KN * (it + 1), N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[NJ][4];
    long_scores<D, KN>(s, qw, kbuf + (it & 1) * KN * LD, KN * it, N, scale, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;  // exp(-inf) = 0 for masked keys
        s[j][e] = div_by(expf(s[j][e] - mx[half]), sum[half], rs[half]);
      }
    const bf16* const vs = vbuf + (it & 1) * KN * LD;
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[2 * dn], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 16 * warp + g + 8 * half;
    if (row >= N) continue;
    bf16* op = o + (((long long)blockIdx.z * N + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + 8 * j) = pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// ------------------------------------------- long bf16 at D = 32 and 64
// A block of 4 warps per (image, head, 128 queries), 32 query rows a warp
// (two m16 tiles).  Key tiles of RK keys (K alone in pass 1, K and V in
// pass 2) go round a ring of RSTAGES stages in shared memory, rows of D + 8
// elements so that ldmatrix stays free of bank conflicts.  A stage has a
// "full" mbarrier (an arrival from each thread once its cp.async copies of
// the tile have landed) and an "empty" one (an arrival from each warp that
// has finished with the tile).  After each tile a thread issues its share
// of the tile RSTAGES - 1 further on, into the stage that every warp has
// released.  Each warp copies its own 32 Q rows onto its own mbarrier.
constexpr int RQ = 128;       // queries a block: 4 warps x 32 rows
constexpr int RK = 64;        // keys a ring stage
constexpr int RS = 32;        // keys a step of a warp: S of a step is 2 x 4 n8 tiles
constexpr int RSTAGES = 3;    // ring depth: 3 blocks an SM
constexpr int RTHREADS = 128;
constexpr int RBARS = 128;    // bytes for the 2 RSTAGES + 4 mbarriers, ahead of the tiles

template <int D>
constexpr size_t bf16_ring_smem() {  // barriers, Q tile, RSTAGES x (K tile, V tile)
  return RBARS + sizeof(bf16) * (size_t)(RQ + 2 * RSTAGES * RK) * (D + 8);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// an arrival once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity ``parity`` has completed; a wait of 2^34 cycles
// (seconds: a lost arrival) traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}
// 2^x by the SFU alone (ex2.approx.ftz: 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// s = Q K^T (unscaled) for a warp's 32 queries (A fragments qa of its two
// m16 tiles) and RS keys (rows of ks, the first being key ``key0``); keys
// >= N masked to -inf.  s[mt][j] holds keys 8j + 2t (+1) of rows g and g + 8
// of m16 tile mt; each score sums its k-steps in the short kernel's order,
// and each K fragment feeds four mma.sync.
template <int D>
__device__ __forceinline__ void ring_scores(float (&s)[2][RS / 8][4], const uint32_t (&qa)[2][D / 16][4],
                                            const bf16* ks, int key0, int N, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < RS / 8; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < RS / 16; ++nt) {
      uint32_t kb[4];
      ldmatrix_x4(kb, ks + (16 * nt + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(s[mt][2 * nt], qa[mt][kk], kb[0], kb[1]);
        mma_bf16(s[mt][2 * nt + 1], qa[mt][kk], kb[2], kb[3]);
      }
    }
  }
  if (key0 + RS > N) {  // warp-uniform: only the step that reaches past N masks
    const int t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < RS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * j + 2 * t + (e & 1) >= N) s[mt][j][e] = -INFINITY;
  }
}

// q, k, v: (B, N, H, D) sharing the element strides (sb, sn, D, 1), rows
// 16-byte aligned; o: contiguous (B, N, H, D).  Block (x, h, b) takes
// queries RQ x .. RQ x + RQ - 1 of (image b, head h).
template <int D>
__global__ void __launch_bounds__(RTHREADS, 3)
mha_bf16_ring_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int N, int H,
                     long long sb, long long sn, float scale) {
  constexpr int LD = D + 8;
  constexpr int CH = D / 8;                   // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t full0 = smem_addr(smem_raw);      // full[RSTAGES]
  const uint32_t empty0 = full0 + 8 * RSTAGES;     // empty[RSTAGES]
  const uint32_t qbar0 = full0 + 16 * RSTAGES;     // Q rows of warp w landed: qbar0 + 8 w
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw + RBARS);  // RQ x LD
  bf16* const ring = qs + RQ * LD;  // stage st: K tile at ring + 2 st RK LD, its V tile RK LD further
  const int h = blockIdx.y;
  const long long base = (long long)blockIdx.z * sb + (long long)h * D;
  const int q0 = blockIdx.x * RQ;
  const int qrows = min(RQ, N - q0);
  const int tiles = (N + RK - 1) / RK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < RSTAGES; ++st) {
      mbar_init(full0 + 8 * st, RTHREADS);
      mbar_init(empty0 + 8 * st, RTHREADS / 32);
    }
    for (int w = 0; w < RTHREADS / 32; ++w) mbar_init(qbar0 + 8 * w, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Q first: each warp copies its own 32 rows, completing on its own barrier
  for (int c = lane; c < 32 * CH; c += 32) {
    const int r = 32 * warp + c / CH;
    if (r < qrows) cp_async16(qs + r * LD + (c % CH) * 8, q + base + (long long)(q0 + r) * sn + (c % CH) * 8);
  }
  cp_async_arrive(qbar0 + 8 * warp);
  // Zeros in the V buffers, once, when the last tile is ragged: a stage's
  // rows past N then hold zeros or an earlier tile's V rows, finite either
  // way (P is 0 there, and 0 x NaN is NaN in P V).  Q rows past N stay as
  // they are: a row's scores, softmax and output are its own, and its
  // output is not written.
  if (N % RK)
    for (int i = threadIdx.x; i < RSTAGES * RK * CH; i += RTHREADS) {
      const int st = i / (RK * CH), r = (i / CH) % RK;
      *reinterpret_cast<uint4*>(ring + (2 * st + 1) * RK * LD + r * LD + (i % CH) * 8) = make_uint4(0, 0, 0, 0);
    }
  __syncthreads();

  // Load l (l < 2 tiles) fills stage l % RSTAGES with key tile l % tiles: K
  // for pass 1 (l < tiles), K and V for pass 2.  A thread issues its share
  // of load l once it has computed tile l - RSTAGES + 1 and every warp has
  // released the stage (its tile l - RSTAGES), so a warp may run a tile
  // ahead of the others.  A thread copies 16 bytes of every RPASS-th row.
  constexpr int RPASS = RTHREADS / CH;
  const int lrow = threadIdx.x / CH, lcol = (threadIdx.x % CH) * 8;
  auto load = [&](int l) {
    if (l >= 2 * tiles) return;
    const int st = l % RSTAGES;
    if (l >= RSTAGES) mbar_wait(empty0 + 8 * st, (l / RSTAGES - 1) & 1);
    const bool with_v = l >= tiles;
    const int key0 = (with_v ? l - tiles : l) * RK;
    const int rows = min(RK, N - key0);
    const long long off = base + (long long)(key0 + lrow) * sn + lcol;
    bf16* const ks = ring + 2 * st * RK * LD + lrow * LD + lcol;
#pragma unroll
    for (int r = 0; r < RK / RPASS; ++r) {
      if (lrow + r * RPASS >= rows) break;
      cp_async16(ks + r * RPASS * LD, k + off + r * RPASS * sn);
      if (with_v) cp_async16(ks + (RK + r * RPASS) * LD, v + off + r * RPASS * sn);
    }
    cp_async_arrive(full0 + 8 * st);
  };
  auto release = [&](int l) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (l % RSTAGES));
  };
  for (int l = 0; l < RSTAGES - 1; ++l) load(l);

  // a thread holds rows g and g + 8 of each of its warp's m16 tiles mt = 0,
  // 1 (index 2 mt + half).  A warp whose rows all lie past N computes
  // nothing but loads and releases as the others do.
  const int g = lane >> 2, t = lane & 3;
  const bool busy = q0 + 32 * warp < N;  // warp-uniform
  uint32_t qa[2][D / 16][4];
  if (busy) {
    mbar_wait(qbar0 + 8 * warp, 0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qa[mt][kk], qs + (32 * warp + 16 * mt + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  }

  // base 2, the scale folded in: exp(scale (s - m)) = 2^(c s - c m), with m
  // the row's largest unscaled score (the scale is positive)
  const float c = scale * 1.4426950408889634f;
  // pass 1: each thread's running max and sum over its own keys of each row
  // (no shuffles in the loop), merged over the quad after the last tile
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY}, sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < tiles; ++i) {
    const int st = i % RSTAGES;
    mbar_wait(full0 + 8 * st, (i / RSTAGES) & 1);
    if (busy) {
      const bf16* const ks = ring + 2 * st * RK * LD;
#pragma unroll
      for (int step = 0; step < RK / RS; ++step) {
        const int key0 = i * RK + step * RS;
        if (key0 >= N) break;  // warp-uniform
        float s[2][RS / 8][4];
        ring_scores<D>(s, qa, ks + step * RS * LD, key0, N, lane);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int mt = r >> 1, e0 = 2 * (r & 1);
          float tm = -INFINITY;
#pragma unroll
          for (int j = 0; j < RS / 8; ++j) tm = fmaxf(tm, fmaxf(s[mt][j][e0], s[mt][j][e0 + 1]));
          const float m = fmaxf(mx[r], tm);
          const float mc = m == -INFINITY ? 0.0f : m * c;  // all of this thread's keys masked so far
          float ts = 0.0f;
#pragma unroll
          for (int j = 0; j < RS / 8; ++j)
            ts += ex2(fmaf(s[mt][j][e0], c, -mc)) + ex2(fmaf(s[mt][j][e0 + 1], c, -mc));
          sum[r] = sum[r] * ex2(fmaf(mx[r], c, -mc)) + ts;
          mx[r] = m;
        }
      }
    }
    load(i + RSTAGES - 1);
    release(i);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {  // key 0 < N lies in every row's quad: m is finite
    float m = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float l = sum[r] * ex2(fmaf(mx[r], c, -m * c));
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    mx[r] = fmaf(m, c, __log2f(l));  // from here on mx holds c m + log2 l
  }

  // pass 2: P = exp(s - m) / l in f32 (2^(c s - c m - log2 l)), cast to
  // bf16; O = P V in f32, each V fragment (ldmatrix.trans) feeding four
  // mma.sync
  float acc[2][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.0f;
  for (int i = tiles; i < 2 * tiles; ++i) {
    const int st = i % RSTAGES;
    mbar_wait(full0 + 8 * st, (i / RSTAGES) & 1);
    if (busy) {
      const bf16* const ks = ring + 2 * st * RK * LD;
      const bf16* const vs = ks + RK * LD;
#pragma unroll
      for (int step = 0; step < RK / RS; ++step) {
        const int key0 = (i - tiles) * RK + step * RS;
        if (key0 >= N) break;  // warp-uniform
        float s[2][RS / 8][4];
        ring_scores<D>(s, qa, ks + step * RS * LD, key0, N, lane);
#pragma unroll
        for (int kk = 0; kk < RS / 16; ++kk) {
          uint32_t pa[2][4];  // the accumulators of key tiles 2kk, 2kk+1: P's A fragment of k-step kk
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float p[2][4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) {  // 2^-inf = 0 for masked keys
                const int r = 2 * mt + (e >> 1);
                p[jj][e] = ex2(fmaf(s[mt][2 * kk + jj][e], c, -mx[r]));
              }
            pa[mt][0] = pack_bf16(p[0][0], p[0][1]);
            pa[mt][1] = pack_bf16(p[0][2], p[0][3]);
            pa[mt][2] = pack_bf16(p[1][0], p[1][1]);
            pa[mt][3] = pack_bf16(p[1][2], p[1][3]);
          }
#pragma unroll
          for (int dn = 0; dn < D / 16; ++dn) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vs + (step * RS + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                      dn * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][2 * dn], pa[mt], vb[0], vb[1]);
              mma_bf16(acc[mt][2 * dn + 1], pa[mt], vb[2], vb[3]);
            }
          }
        }
      }
    }
    load(i + RSTAGES - 1);
    release(i);
  }
  if (!busy) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + 32 * warp + 16 * mt + g + 8 * half;
      if (row >= N) continue;
      bf16* op = o + (((long long)blockIdx.z * N + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + 8 * j) = pack_bf16(acc[mt][j][2 * half], acc[mt][j][2 * half + 1]);
    }
}

// -------------------------------------------------------------- long f32
constexpr int LQF = 32;   // queries a long f32 block
constexpr int NTL = 256;  // threads: 16 query pairs x 16 lanes

template <int D>
constexpr size_t f32_long_smem() {  // Q tile, a K tile, a V tile, P key-major
  constexpr int KN = long_keys<D>();
  return sizeof(float) * ((size_t)(LQF + 2 * KN) * (D + 4) + (size_t)KN * (LQF + 4));
}

template <int D, int ROWS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, long long base,
                                          long long sn, int r0, int N) {
  stage_rows<float, D, ROWS, NTL>(dst, src, base, sn, r0, N);
}

// Thread (ty, tx) holds queries 2 ty, 2 ty + 1 and, of a key tile, keys
// tx + 16 m (m < KN / 16); in P V the output dims DT tx .. DT tx + DT - 1.
template <int D>
__global__ void __launch_bounds__(NTL)
mha_f32_long_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int N, int H,
                    long long sb, long long sn, float scale) {
  constexpr int KN = long_keys<D>();
  constexpr int LD = D + 4;  // 8 consecutive rows hit 8 distinct bank quads
  constexpr int SLD = LQF + 4;
  constexpr int MC = KN / 16;
  constexpr int DT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;           // LQF x LD
  float* const ks = qs + LQF * LD;  // KN x LD
  float* const vs = ks + KN * LD;   // KN x LD
  float* const ps = vs + KN * LD;   // KN x SLD
  const int h = blockIdx.y;
  const long long base = (long long)blockIdx.z * sb + (long long)h * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * LQF;
  const int tiles = (N + KN - 1) / KN;

  stage_f32<D, LQF>(qs, q, base, sn, q0, N);
  cp_async_commit();
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f}, rs[2] = {0.0f, 0.0f};
  float acc[2][DT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < DT; ++e) acc[i][e] = 0.0f;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) rs[0] = __frcp_rn(sum[0]), rs[1] = __frcp_rn(sum[1]);
    for (int it = 0; it < tiles; ++it) {
      __syncthreads();  // the last tile's K, V and P are no longer read
      stage_f32<D, KN>(ks, k, base, sn, KN * it, N);
      if (pass == 1) stage_f32<D, KN>(vs, v, base, sn, KN * it, N);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float s[2][MC];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int m = 0; m < MC; ++m) s[i][m] = 0.0f;
      const float* const qr = qs + 2 * ty * LD;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(qr + d);
        const float4 a1 = *reinterpret_cast<const float4*>(qr + LD + d);
#pragma unroll
        for (int m = 0; m < MC; ++m) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + 16 * m) * LD + d);
          s[0][m] = fmaf(a0.x, kv.x, s[0][m]);
          s[0][m] = fmaf(a0.y, kv.y, s[0][m]);
          s[0][m] = fmaf(a0.z, kv.z, s[0][m]);
          s[0][m] = fmaf(a0.w, kv.w, s[0][m]);
          s[1][m] = fmaf(a1.x, kv.x, s[1][m]);
          s[1][m] = fmaf(a1.y, kv.y, s[1][m]);
          s[1][m] = fmaf(a1.z, kv.z, s[1][m]);
          s[1][m] = fmaf(a1.w, kv.w, s[1][m]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int m = 0; m < MC; ++m) {
          s[i][m] *= scale;
          if (KN * it + tx + 16 * m >= N) s[i][m] = -INFINITY;
        }
      if (pass == 0) {
        // a query's scores of the tile lie across the 16 lanes of its half-warp
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float tm = -INFINITY;
#pragma unroll
          for (int m = 0; m < MC; ++m) tm = fmaxf(tm, s[i][m]);
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, off));
          const float mm = fmaxf(mx[i], tm);  // finite: every tile holds a key < N
          float ts = 0.0f;
#pragma unroll
          for (int m = 0; m < MC; ++m) ts += expf(s[i][m] - mm);
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) ts += __shfl_xor_sync(0xffffffffu, ts, off);
          sum[i] = sum[i] * expf(mx[i] - mm) + ts;
          mx[i] = mm;
        }
        continue;
      }
#pragma unroll
      for (int m = 0; m < MC; ++m)
        *reinterpret_cast<float2*>(ps + (tx + 16 * m) * SLD + 2 * ty) =
            make_float2(div_by(expf(s[0][m] - mx[0]), sum[0], rs[0]),
                        div_by(expf(s[1][m] - mx[1]), sum[1], rs[1]));
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < KN; ++j) {
        const float2 pj = *reinterpret_cast<const float2*>(ps + j * SLD + 2 * ty);
        const float* const vr = vs + j * LD + DT * tx;
        float vv[DT];
#pragma unroll
        for (int e = 0; e < DT; e += 2) {
          const float2 t2 = *reinterpret_cast<const float2*>(vr + e);
          vv[e] = t2.x, vv[e + 1] = t2.y;
        }
#pragma unroll
        for (int e = 0; e < DT; ++e) {
          acc[0][e] = fmaf(pj.x, vv[e], acc[0][e]);
          acc[1][e] = fmaf(pj.y, vv[e], acc[1][e]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * ty + i;
    if (row >= N) continue;
    float* op = o + (((long long)blockIdx.z * N + row) * H + h) * D + DT * tx;
#pragma unroll
    for (int e = 0; e < DT; e += 2) *reinterpret_cast<float2*>(op + e) = make_float2(acc[i][e], acc[i][e + 1]);
  }
}

// ---------------------------------------------- long f32 at D = 32 and 64
// One pass with online rescaling (mha_f32_online_kernel).  A block of
// F1_WARPS warps takes 16 F1_WARPS queries of one (image, head); lane
// (qy, kx) = (lane / 8, lane % 8) of warp w holds queries 16 w + 4 qy ..
// + 3 and, of a key tile, keys kx + 8 m (m < F1_KT / 8); in P V the same
// queries and dims 4 kx + 32 e .. + 3 (e < D / 32).  A query row's keys lie
// in the 8 lanes of one qy, so its tile max is three shuffles and a warp's
// P never leaves the warp.
constexpr int F1_WARPS = 8;             // 128 queries a block
constexpr int F1_Q = 16 * F1_WARPS;
constexpr int F1_KT = 64;               // keys a tile; F1_KT / 8 a thread
constexpr int F1_KV_TILES = 1;          // one K and one V buffer, each refilled while the other is read
constexpr int F1_PLD = 20;              // a warp's P row: 16 queries + 4, odd in 16-byte units

template <int D>
constexpr size_t f32_online_smem() {  // Q^T, F1_KV_TILES x (K tile, V tile), a P tile a warp
  return sizeof(float) *
         ((size_t)D * F1_Q + 2 * (size_t)F1_KV_TILES * F1_KT * (D + 4) + (size_t)F1_WARPS * F1_KT * F1_PLD);
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// 2^x for the softmax, the scale and log2(e) folded into its argument
__device__ __forceinline__ float f1_exp2(float x) { return ex2(x); }

// The scores of one key tile of 8 MC keys (the first being key ``key0``)
// for a warp's queries: S = Q K^T (f32 FMAs over d in order), keys >= N
// masked, the running max mc (scaled: c = scale log2(e), so P = 2^(c s -
// mc)) raised to the tile's, the accumulators and each lane's partial sums
// lp rescaled by 2^(mc_old - mc_new), P to the warp's tile pw key-major.
template <int D, int MC>
__device__ __forceinline__ void f1_scores(const float* qt, const float* ks, float* pw, float (&acc)[4][D / 8],
                                          float (&mc)[4], float (&lp)[4], int key0, int N, float c, int qq,
                                          int qy, int kx) {
  constexpr int LD = D + 4;  // rows kx + 8 m of 8 lanes: 8 distinct 16-byte bank groups
  float s[4][MC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < MC; ++m) s[i][m] = 0.0f;
  const float* const qr = qt + qq;  // Q^T[d][qq .. qq + 3]: one 16-byte load, 4 queries
  const float* const kr = ks + kx * LD;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = *reinterpret_cast<const float4*>(qr + (d + j) * F1_Q);
#pragma unroll
    for (int m = 0; m < MC; ++m) {
      const float4 b = *reinterpret_cast<const float4*>(kr + 8 * m * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][m] = fmaf(f4(a[0], i), b.x, s[i][m]);
        s[i][m] = fmaf(f4(a[1], i), b.y, s[i][m]);
        s[i][m] = fmaf(f4(a[2], i), b.z, s[i][m]);
        s[i][m] = fmaf(f4(a[3], i), b.w, s[i][m]);
      }
    }
  }
  if (key0 + 8 * MC > N) {  // block-uniform: only the tile that reaches past N masks
#pragma unroll
    for (int m = 0; m < MC; ++m)
      if (key0 + kx + 8 * m >= N)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][m] = -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float tm = s[i][0];
#pragma unroll
    for (int m = 1; m < MC; ++m) tm = fmaxf(tm, s[i][m]);
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 4));
    const float mn = fmaxf(mc[i], tm * c);  // finite: key0 < N lies in every tile
    const float alpha = f1_exp2(mc[i] - mn);  // 0 at the first tile (mc = -inf, sums and O 0)
    mc[i] = mn;
    float ts = 0.0f;
#pragma unroll
    for (int m = 0; m < MC; ++m) {
      s[i][m] = f1_exp2(fmaf(s[i][m], c, -mn));  // 2^-inf = 0 for masked keys
      ts += s[i][m];
    }
    lp[i] = fmaf(lp[i], alpha, ts);
#pragma unroll
    for (int e = 0; e < D / 8; ++e) acc[i][e] *= alpha;
  }
  // P key-major, a warp's own 16 queries: rows kx + 8 m, columns 4 qy .. + 3
#pragma unroll
  for (int m = 0; m < MC; ++m)
    *reinterpret_cast<float4*>(pw + (kx + 8 * m) * F1_PLD + 4 * qy) = make_float4(s[0][m], s[1][m], s[2][m], s[3][m]);
  __syncwarp();
}

// O += P V over the tile's 8 MC keys: 4 queries x D / 8 dims a thread
template <int D, int MC>
__device__ __forceinline__ void f1_pv(const float* vs, const float* pw, float (&acc)[4][D / 8], int qy, int kx) {
  constexpr int LD = D + 4;
#pragma unroll 8
  for (int j = 0; j < 8 * MC; ++j) {
    const float4 p = *reinterpret_cast<const float4*>(pw + j * F1_PLD + 4 * qy);
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      const float4 vv = *reinterpret_cast<const float4*>(vs + j * LD + 4 * kx + 32 * e);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * e] = fmaf(f4(p, i), vv.x, acc[i][4 * e]);
        acc[i][4 * e + 1] = fmaf(f4(p, i), vv.y, acc[i][4 * e + 1]);
        acc[i][4 * e + 2] = fmaf(f4(p, i), vv.z, acc[i][4 * e + 2]);
        acc[i][4 * e + 3] = fmaf(f4(p, i), vv.w, acc[i][4 * e + 3]);
      }
    }
  }
  __syncwarp();  // the next tile rewrites P
}

// The tile at key0, its scores and then its P V, with mid() (block-wide)
// between them; its width: F1_KT, or for a ragged last tile the narrowest
// of F1_KT / 2, / 4, ... (down to 8) that holds the N - key0 keys left
// (N = 577: 9 tiles of 64, then 8 keys for the last one).  A warp that is
// not busy runs mid() alone.
template <int D, int MC, typename Mid>
__device__ __forceinline__ void f1_tile(bool busy, const float* qt, const float* ks, const float* vs, float* pw,
                                        float (&acc)[4][D / 8], float (&mc)[4], float (&lp)[4], int key0, int N,
                                        float c, int qq, int qy, int kx, Mid&& mid) {
  if constexpr (MC > 1) {
    if (N - key0 <= 4 * MC) {
      f1_tile<D, MC / 2>(busy, qt, ks, vs, pw, acc, mc, lp, key0, N, c, qq, qy, kx, mid);
      return;
    }
  }
  if (busy) f1_scores<D, MC>(qt, ks, pw, acc, mc, lp, key0, N, c, qq, qy, kx);
  mid();
  if (busy) f1_pv<D, MC>(vs, pw, acc, qy, kx);
}

// q, k, v: (B, N, H, D) sharing the element strides (sb, sn, D, 1), rows
// 16-byte aligned; o: contiguous (B, N, H, D).  Block (x, h, b) takes
// queries F1_Q x .. F1_Q x + F1_Q - 1 of (image b, head h).
template <int D>
__global__ void __launch_bounds__(32 * F1_WARPS, 2)
mha_f32_online_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int N, int H,
                      long long sb, long long sn, float scale) {
  constexpr int LD = D + 4;
  constexpr int THREADS = 32 * F1_WARPS;
  constexpr int TILE = F1_KT * LD;
  extern __shared__ __align__(16) float smem[];
  float* const qt = smem;                      // D x F1_Q: Q^T, for the whole key loop
  float* const kb = qt + D * F1_Q;             // F1_KV_TILES x F1_KT x LD
  float* const vb = kb + F1_KV_TILES * TILE;   // F1_KV_TILES x F1_KT x LD
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const pw = vb + F1_KV_TILES * TILE + warp * F1_KT * F1_PLD;  // this warp's P, F1_KT x F1_PLD
  const int h = blockIdx.y;
  const long long base = (long long)blockIdx.z * sb + (long long)h * D;
  const int q0 = blockIdx.x * F1_Q;
  const int tiles = (N + F1_KT - 1) / F1_KT;
  const int qy = lane >> 3, kx = lane & 7;
  const int qq = 16 * warp + 4 * qy;  // the thread's first query in the block

  // K's first tile by cp.async (rows past N as zeros, here and below: 0 x
  // NaN is NaN in P V), then Q transposed through registers (rows past N as
  // zeros) meanwhile
  stage_rows<float, D, F1_KT, THREADS>(kb, k, base, sn, 0, N);
  cp_async_commit();
  for (int i = threadIdx.x; i < F1_Q * (D / 4); i += THREADS) {
    const int r = i % F1_Q, col = (i / F1_Q) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < N) x = *reinterpret_cast<const float4*>(q + base + (long long)(q0 + r) * sn + col);
    qt[col * F1_Q + r] = x.x;
    qt[(col + 1) * F1_Q + r] = x.y;
    qt[(col + 2) * F1_Q + r] = x.z;
    qt[(col + 3) * F1_Q + r] = x.w;
  }

  const bool busy = q0 + 16 * warp < N;  // warp-uniform: a warp past N only stages and waits
  const float c = scale * 1.4426950408889634f;  // exp(scale (s - m)) = 2^(c s - c m)
  float acc[4][D / 8], mc[4], lp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mc[i] = -INFINITY, lp[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < D / 8; ++e) acc[i][e] = 0.0f;
  }
  // Two barriers a tile, each guarding a buffer's reuse: V lands during the
  // tile's scores, the next tile's K during its P V.
  for (int it = 0; it < tiles; ++it) {
    const int key0 = F1_KT * it;
    cp_async_wait<0>();
    __syncthreads();  // K of tile it landed; every warp is done with V of tile it - 1
    stage_rows<float, D, F1_KT, THREADS>(vb, v, base, sn, key0, N);
    cp_async_commit();
    f1_tile<D, F1_KT / 8>(busy, qt, kb, vb, pw, acc, mc, lp, key0, N, c, qq, qy, kx, [=] {
      cp_async_wait<0>();
      __syncthreads();  // V landed; every warp is done with K
      if (it + 1 < tiles) {
        stage_rows<float, D, F1_KT, THREADS>(kb, k, base, sn, key0 + F1_KT, N);
        cp_async_commit();
      }
    });
  }
  if (!busy) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = lp[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = q0 + qq + i;
    if (row >= N) continue;
    float* const op = o + (((long long)blockIdx.z * N + row) * H + h) * D + 4 * kx;
#pragma unroll
    for (int e = 0; e < D / 32; ++e)  // one correctly rounded divide an output
      *reinterpret_cast<float4*>(op + 32 * e) =
          make_float4(__fdiv_rn(acc[i][4 * e], l), __fdiv_rn(acc[i][4 * e + 1], l),
                      __fdiv_rn(acc[i][4 * e + 2], l), __fdiv_rn(acc[i][4 * e + 3], l));
  }
}

// --------------------------------------------------------------- launch
// The dynamic shared-memory opt-in is set once per kernel function and
// device (a PerDevice static in each launcher instantiation), to the most it
// can ask for.
template <typename Kernel>
int opt_in(PerDevice& done, Kernel kernel, size_t most) {
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  return once_per_device(done, dev, [kernel, most] {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  });
}

template <int D, int KT>
int launch_bf16_kt(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
                   long long sb, long long sn, float scale, cudaStream_t stream) {
  constexpr size_t smem = bf16_smem<D, KT>();
  static PerDevice opted;
  const int attr = opt_in(opted, mha_bf16_kernel<D, KT>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((unsigned)(((N + 15) / 16 + QB - 1) / QB), (unsigned)H, (unsigned)B);
  mha_bf16_kernel<D, KT><<<grid, 128, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, N, H, sb, sn, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
                long long sb, long long sn, float scale, cudaStream_t stream) {
  // key buckets: 16, 32, 64, 128, 208 (the ViT's 197), 256
  if (N <= 16) return launch_bf16_kt<D, 1>(q, k, v, o, B, N, H, sb, sn, scale, stream);
  if (N <= 32) return launch_bf16_kt<D, 2>(q, k, v, o, B, N, H, sb, sn, scale, stream);
  if (N <= 64) return launch_bf16_kt<D, 4>(q, k, v, o, B, N, H, sb, sn, scale, stream);
  if (N <= 128) return launch_bf16_kt<D, 8>(q, k, v, o, B, N, H, sb, sn, scale, stream);
  if (N <= 208) return launch_bf16_kt<D, 13>(q, k, v, o, B, N, H, sb, sn, scale, stream);
  return launch_bf16_kt<D, 16>(q, k, v, o, B, N, H, sb, sn, scale, stream);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
               long long sb, long long sn, float scale, cudaStream_t stream) {
  static PerDevice opted;
  const int err = opt_in(opted, mha_f32_kernel<D>, f32_smem<D>(MAX_N));
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((N + QTF - 1) / QTF), (unsigned)H, (unsigned)B);
  mha_f32_kernel<D><<<grid, NTF, f32_smem<D>(N), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, N, H, sb, sn, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16_long(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
                     long long sb, long long sn, float scale, cudaStream_t stream) {
  static PerDevice opted;
  if constexpr (D <= 64) {  // the ring kernel; 32 rows a warp would spill at D = 128 and 256
    constexpr size_t smem = bf16_ring_smem<D>();
    const int attr = opt_in(opted, mha_bf16_ring_kernel<D>, smem);
    if (attr != cudaSuccess) return attr;
    dim3 grid((unsigned)((N + RQ - 1) / RQ), (unsigned)H, (unsigned)B);
    mha_bf16_ring_kernel<D><<<grid, RTHREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, N, H, sb, sn, scale);
  } else {
    constexpr size_t smem = bf16_long_smem<D>();
    const int attr = opt_in(opted, mha_bf16_long_kernel<D>, smem);
    if (attr != cudaSuccess) return attr;
    dim3 grid((unsigned)((N + LQ - 1) / LQ), (unsigned)H, (unsigned)B);
    mha_bf16_long_kernel<D><<<grid, 128, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, N, H, sb, sn, scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32_long(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
                    long long sb, long long sn, float scale, cudaStream_t stream) {
  static PerDevice opted;
  if constexpr (D <= 64) {  // one pass; at D = 128 and 256 its accumulators would spill
    constexpr size_t smem = f32_online_smem<D>();
    const int attr = opt_in(opted, mha_f32_online_kernel<D>, smem);
    if (attr != cudaSuccess) return attr;
    dim3 grid((unsigned)((N + F1_Q - 1) / F1_Q), (unsigned)H, (unsigned)B);
    mha_f32_online_kernel<D><<<grid, 32 * F1_WARPS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, N, H, sb, sn, scale);
  } else {
    constexpr size_t smem = f32_long_smem<D>();
    const int attr = opt_in(opted, mha_f32_long_kernel<D>, smem);
    if (attr != cudaSuccess) return attr;
    dim3 grid((unsigned)((N + LQF - 1) / LQF), (unsigned)H, (unsigned)B);
    mha_f32_long_kernel<D><<<grid, NTL, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, N, H, sb, sn, scale);
  }
  return (int)cudaGetLastError();
}

// 16-byte cp.async needs every row start aligned: the pointers and both
// strides (in bytes) multiples of 16.
bool rows_aligned(const void* q, const void* k, const void* v, long long sb, long long sn,
                  size_t elem) {
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  return any % 16 == 0 && (sb * (long long)elem) % 16 == 0 && (sn * (long long)elem) % 16 == 0;
}

}  // namespace

extern "C" int relax_mha_f32(const void* q, const void* k, const void* v, void* o, int B,
                             int N, int H, int D, long long sb, long long sn, float scale,
                             void* stream) {
  if (N < 1 || N > MAX_N || !rows_aligned(q, k, v, sb, sn, sizeof(float)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return launch_f32<64>(q, k, v, o, B, N, H, sb, sn, scale, s);
  if (D == 32) return launch_f32<32>(q, k, v, o, B, N, H, sb, sn, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int relax_mha_bf16(const void* q, const void* k, const void* v, void* o, int B,
                              int N, int H, int D, long long sb, long long sn, float scale,
                              void* stream) {
  if (N < 1 || N > MAX_N || !rows_aligned(q, k, v, sb, sn, sizeof(bf16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return launch_bf16<64>(q, k, v, o, B, N, H, sb, sn, scale, s);
  if (D == 32) return launch_bf16<32>(q, k, v, o, B, N, H, sb, sn, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Any N >= 1 and D in {32, 64, 128, 256} (the wrapper pads other head dims
// with zeros); layout as the short entries.
extern "C" int relax_mha_f32_long(const void* q, const void* k, const void* v, void* o, int B,
                                  int N, int H, int D, long long sb, long long sn, float scale,
                                  void* stream) {
  if (N < 1 || B > 65535 || H > 65535 || !rows_aligned(q, k, v, sb, sn, sizeof(float)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch_f32_long<32>(q, k, v, o, B, N, H, sb, sn, scale, s);
    case 64: return launch_f32_long<64>(q, k, v, o, B, N, H, sb, sn, scale, s);
    case 128: return launch_f32_long<128>(q, k, v, o, B, N, H, sb, sn, scale, s);
    case 256: return launch_f32_long<256>(q, k, v, o, B, N, H, sb, sn, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int relax_mha_bf16_long(const void* q, const void* k, const void* v, void* o, int B,
                                   int N, int H, int D, long long sb, long long sn, float scale,
                                   void* stream) {
  if (N < 1 || B > 65535 || H > 65535 || !rows_aligned(q, k, v, sb, sn, sizeof(bf16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch_bf16_long<32>(q, k, v, o, B, N, H, sb, sn, scale, s);
    case 64: return launch_bf16_long<64>(q, k, v, o, B, N, H, sb, sn, scale, s);
    case 128: return launch_bf16_long<128>(q, k, v, o, B, N, H, sb, sn, scale, s);
    case 256: return launch_bf16_long<256>(q, k, v, o, B, N, H, sb, sn, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
