// The serving decoder's tail on the packed grid: 3³ conv2 (nf -> nf) at
// (2S)³, ReLU, 1x1 head, bias, tanh, in one pass.
//
// Replaces the Pallas kernel `_decoder_tail_kernel` / `packed_decoder_tail`
// of retrieval_fuse_tpu/ops/pallas_decoder.py:94 and :154 (the serving
// engine's `cdec` token). Python side: ops/decoder_tail.py.
//
// Input hn (B, S+2, S+2, S+2, 8·nf): conv1's GroupNorm-applied output on the
// coarse grid, zero-padded by one, with o_idx-major channel blocks
// (o_idx = o0·4 + o1·2 + o2 is the 2x-grid sub-position). Output
// (B, S, S, S, 8) float32 = tanh(head(relu(conv2(·))) + bias) of the 2x
// grid, o_idx-minor. Output voxel 2i+o per axis reads 2x-grid taps
// y = 2i+o+k-1, k ∈ {0,1,2}, which live at packed position floor(y/2),
// block y mod 2. In bf16 the ReLU output is rounded to bf16 before the
// head, as in the JAX kernel (pallas_decoder.py:148); bias and tanh are
// float32.
//
// Design: the direct 27-tap conv, not the JAX kernel's im2col GEMM, which
// spends 64/27 = 2.37x the useful FLOPs to fill the TPU's matrix unit. One
// block owns a row of packed outputs (b, i0, i1, all i2): the 2·2·2S
// voxels of the 2x grid under it. Shared memory holds conv2's weights
// (27·nf·nf float32) and the input slab those voxels read: 4 x 4 rows of
// the 2x grid around them (of the packed neighbours i-1 and i+1 only the
// sub-position next to i is read), each 2S+2 long with the padding,
// converted to float32 and stored channel-major with an odd channel pitch,
// so that a warp's 32 neighbouring voxels read 32 neighbouring words.
// A thread owns one voxel and accumulates its nf output channels in
// registers with float32 FMAs; weights are read as broadcast float4s.
// Each block stops at the ragged edges by index; no TPU workaround is
// carried over (the sublane-aligned pad of the input's minor axis, the
// 4-group split of the im2col columns, the t0-row grid).
//
// Bound on the H100 at batch 128 (S=32, nf=16): 465 GFLOP of useful conv
// and head work, 0.47 ms at the 989 TFLOP/s bf16 tensor-core rate; 1.42 GB
// of bytes, 0.43 ms at 3.35 TB/s. A float32-FMA kernel cannot go under
// ~6.9 ms (67 TFLOP/s); an mma.sync / wgmma implicit GEMM is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmemBytes = 232448;  // per block on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__host__ __device__ constexpr int slab_cols(int s) { return 2 * s + 2; }
__host__ __device__ constexpr int channel_pitch(int s) { return 16 * slab_cols(s) + 1; }

template <int NF>
size_t smem_bytes(int s) {
  return sizeof(float) * (27 * NF * NF + NF + static_cast<size_t>(NF) * channel_pitch(s));
}

template <typename T, int NF>
__global__ void __launch_bounds__(kThreads)
decoder_tail(const T* __restrict__ hn, const float* __restrict__ w2,
             const float* __restrict__ wh, float bias, int S, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int J = slab_cols(S), CS = channel_pitch(S), P = S + 2;
  float* wsm = smem;                   // (27, NF, NF): tap, c_in, c_out
  float* whs = wsm + 27 * NF * NF;     // (NF,)
  float* slab = whs + NF;              // slab[c * CS + R * J + j], R = r0·4 + r1
  const int blk = blockIdx.x;
  const int i1 = blk % S, i0 = (blk / S) % S, b = blk / (S * S);

  for (int i = threadIdx.x; i < 27 * NF * NF; i += kThreads) wsm[i] = w2[i];
  if (threadIdx.x < NF) whs[threadIdx.x] = wh[threadIdx.x];
  // slab row r0 is 2x-grid row 2·i0 - 1 + r0: packed (padded) position
  // i0 + (r0+1)/2, block bit (r0+1) & 1; likewise r1. Slab column j is
  // 2x-grid index j - 1 along the last axis. Each (r0, r1, p2) reads the
  // two channel blocks o_idx = s0·4 + s1·2 + {0, 1}: 2·NF contiguous values.
  constexpr int kRun = 2 * NF;
  for (int i = threadIdx.x; i < 16 * P * kRun; i += kThreads) {
    const int e = i % kRun, p2 = (i / kRun) % P, R = i / (kRun * P);
    const int r0 = R >> 2, r1 = R & 3;
    const int j = 2 * p2 - 1 + e / NF;
    if (j < 0 || j >= J) continue;
    const int pp0 = i0 + ((r0 + 1) >> 1), pp1 = i1 + ((r1 + 1) >> 1);
    const int blk_off = (((r0 + 1) & 1) * 4 + ((r1 + 1) & 1) * 2) * NF;
    const size_t src = (((static_cast<size_t>(b) * P + pp0) * P + pp1) * P + p2) * (8 * NF)
                       + blk_off + e;
    slab[(e % NF) * CS + R * J + j] = to_f32(hn[src]);
  }
  __syncthreads();

  // voxel v -> sub-rows (o0, o1) = v / 2S and 2x-grid column y = v % 2S
  float* row_out = out + (static_cast<size_t>(b) * S + i0) * S * S * 8 + static_cast<size_t>(i1) * S * 8;
  for (int v = threadIdx.x; v < 8 * S; v += kThreads) {
    const int oo = v / (2 * S), y = v % (2 * S);
    const int o0 = oo >> 1, o1 = oo & 1;
    float acc[NF];
#pragma unroll
    for (int c = 0; c < NF; ++c) acc[c] = 0.f;
    for (int k0 = 0; k0 < 3; ++k0) {
      for (int k1 = 0; k1 < 3; ++k1) {
        const float* srow = slab + ((o0 + k0) * 4 + (o1 + k1)) * J + y;
#pragma unroll
        for (int k2 = 0; k2 < 3; ++k2) {
          const float* wk = wsm + ((k0 * 3 + k1) * 3 + k2) * NF * NF;
#pragma unroll 4
          for (int ci = 0; ci < NF; ++ci) {
            const float a = srow[ci * CS + k2];
            const float4* wr = reinterpret_cast<const float4*>(wk + ci * NF);
#pragma unroll
            for (int q = 0; q < NF / 4; ++q) {
              const float4 w = wr[q];
              acc[4 * q + 0] = fmaf(a, w.x, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(a, w.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(a, w.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(a, w.w, acc[4 * q + 3]);
            }
          }
        }
      }
    }
    float z = 0.f;
#pragma unroll
    for (int c = 0; c < NF; ++c) z = fmaf(round_to<T>(fmaxf(acc[c], 0.f)), whs[c], z);
    row_out[(y >> 1) * 8 + o0 * 4 + o1 * 2 + (y & 1)] = tanhf(z + bias);
  }
}

template <typename T, int NF>
int launch(const void* hn, const float* w2, const float* wh, float bias, int b, int s,
           float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<NF>(s);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decoder_tail<T, NF>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b * s * s, kThreads, smem, stream>>>(static_cast<const T*>(hn), w2, wh, bias, s, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int nf, const void* hn, const float* w2, const float* wh, float bias, int b,
             int s, float* out, cudaStream_t stream) {
  switch (nf) {
    case 4: return launch<T, 4>(hn, w2, wh, bias, b, s, out, stream);
    case 8: return launch<T, 8>(hn, w2, wh, bias, b, s, out, stream);
    case 16: return launch<T, 16>(hn, w2, wh, bias, b, s, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype 0: float32, 1: bfloat16 (hn). hn (b, s+2, s+2, s+2, 8·nf), w2
// (3, 3, 3, nf, nf) DHWIO float32 (holding values of hn's dtype), wh (nf,)
// float32 likewise, out (b, s, s, s, 8) float32. nf ∈ {4, 8, 16}; s >= 1,
// b >= 1, b·s·s < 2^31. Returns a cudaError_t value.
extern "C" int rf_decoder_tail(int dtype, const void* hn, const float* w2, const float* wh,
                               float bias, int b, int s, int nf, float* out,
                               cudaStream_t stream) {
  if (b < 1 || s < 1 || static_cast<long long>(b) * s * s > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch<float>(nf, hn, w2, wh, bias, b, s, out, stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(nf, hn, w2, wh, bias, b, s, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
