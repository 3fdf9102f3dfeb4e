// K3: ViT multi-head attention, for Hopper (sm_90a).
//
// Replaces the Pallas kernel relaxtpu/ops/attention.py::_mha_kernel
// (launched by fused_mha), with the numerics of the einsum form at
// relaxtpu/models/vit.py:60-64: per (image, head)
//   S = Q K^T * scale, accumulated in f32; keys >= N masked to -inf;
//   row softmax in f32; P cast to the activation type;
//   O = P V accumulated in f32, written in the activation type.
// The score tile never leaves the SM.
//
// What bounds it on the card: at the ViT-B/16 shape (B=48, N=197, H=12,
// D=64) one call does ~5.7 GFLOP on ~58 MB of q/k/v/o in bf16, so its bound
// is the bytes (about 17 us at 3.35 TB/s) with the tensor cores nearly idle;
// in f32 without tensor cores the operations bound it (~85 us at 67 TFLOP/s).
// Design (simple first): one block per (image, head, 64-query tile).  The
// head's K and V are staged once per block in dynamic shared memory as f32
// (K rows padded to D+1 floats so 32 lanes reading 32 different keys hit 32
// banks; ~100 KB at N=197, D=64, hence the opt-in above 48 KB).  Each warp
// takes one query row at a time: the row lives in registers, lane l scores
// keys l, l+32, ... with plain FMA loops, the max and the sum are warp
// shuffles, and P.V broadcasts each probability by shuffle while each lane
// accumulates its output dims in registers.  wgmma/TMA tiling is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int QT = 64;     // queries per block
constexpr int WARPS = 8;   // warps per block
constexpr int SLOTS = 8;   // keys per lane: N <= 256

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// q, k, v: (B, N, H, D) sharing the element strides (sb, sn, D, 1);
// o: contiguous (B, N, H, D).
template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, int N, int H, long long sb, long long sn, float scale) {
  extern __shared__ float smem[];
  constexpr int KS = D + 1;
  float* ks = smem;           // N x KS
  float* vs = smem + N * KS;  // N x D
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * QT;
  const long long base = (long long)b * sb + (long long)h * D;

  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    const int j = i / D;
    const int d = i - j * D;
    const long long g = base + (long long)j * sn + d;
    ks[j * KS + d] = to_f(k[g]);
    vs[j * D + d] = to_f(v[g]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qend = min(q0 + QT, N);
  for (int qi = q0 + warp; qi < qend; qi += WARPS) {
    const T* qp = q + base + (long long)qi * sn;
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f(qp[d]);

    float s[SLOTS];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int j = t * 32 + lane;
      if (j < N) {
        const float* kr = ks + j * KS;
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) acc += qr[d] * kr[d];
        s[t] = acc * scale;
      } else {
        s[t] = -INFINITY;
      }
      mx = fmaxf(mx, s[t]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      s[t] = expf(s[t] - mx);  // exp(-inf) = 0 for masked keys
      sum += s[t];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) s[t] = to_f(from_f<T>(s[t] / sum));

    float acc[D / 32];
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      if (t * 32 >= N) break;  // warp-uniform
      const int nsrc = min(32, N - t * 32);
      for (int src = 0; src < nsrc; ++src) {
        const float pj = __shfl_sync(0xffffffffu, s[t], src);
        const float* vr = vs + (t * 32 + src) * D + lane;
#pragma unroll
        for (int i = 0; i < D / 32; ++i) acc[i] += pj * vr[32 * i];
      }
    }
    T* op = o + (((long long)b * N + qi) * H + h) * D + lane;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) op[32 * i] = from_f<T>(acc[i]);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
             long long sb, long long sn, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)N * (2 * D + 1);
  cudaError_t err = cudaFuncSetAttribute(mha_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((N + QT - 1) / QT), (unsigned)H, (unsigned)B);
  mha_kernel<T, D><<<grid, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, N, H, sb, sn, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int N, int H, int D,
           long long sb, long long sn, float scale, cudaStream_t stream) {
  if (N < 1 || N > SLOTS * 32) return (int)cudaErrorInvalidValue;
  if (D == 64) return launch_d<T, 64>(q, k, v, o, B, N, H, sb, sn, scale, stream);
  if (D == 32) return launch_d<T, 32>(q, k, v, o, B, N, H, sb, sn, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int relax_mha_f32(const void* q, const void* k, const void* v, void* o, int B,
                             int N, int H, int D, long long sb, long long sn, float scale,
                             void* stream) {
  return launch<float>(q, k, v, o, B, N, H, D, sb, sn, scale, (cudaStream_t)stream);
}

extern "C" int relax_mha_bf16(const void* q, const void* k, const void* v, void* o, int B,
                              int N, int H, int D, long long sb, long long sn, float scale,
                              void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, N, H, D, sb, sn, scale, (cudaStream_t)stream);
}
