// Masked chamfer minima: for a batch of point-set pairs (a, b), the squared
// distance from each point of a to its nearest point of b, and from each
// point of b to its nearest point of a.
//
// Replaces the Pallas kernel `_chamfer_kernel` / `pallas_chamfer` of
// retrieval_fuse_tpu/ops/pallas_chamfer.py:21 and :50 (the metric of
// ops/chamfer.chamfer_batch, which Chamfer3D runs). Python side:
// ops/streaming_chamfer.py; the masked means are one torch reduction there.
//
// d(p, q) = max(|p|² + |q|² - 2 p·q, 0), as the JAX kernel writes it. On
// voxel coordinates every term is an integer below 2^24, so each minimum is
// exact and equals the plain version's bit for bit.
//
// Bound on the H100: operations. Each valid point pair costs ~10 float32
// operations (the depth-3 dot product, the sum, the clamp and the two
// minima) at the 67 TFLOP/s rate outside the tensor cores; the bytes (each
// point read once, each minimum written once) are small beside them. The
// depth-3 product gives the tensor cores nothing to do: this is an FMA
// kernel.
//
// Design: two directions in one launch (blockIdx.z: 0 writes min_ab, 1
// writes min_ba). A block owns kQ query points of one pair, four in each
// thread's registers, and streams the other set through shared memory in
// kTile-point tiles of (x, y, z, |p|²); each thread keeps its running
// minima in registers, so no (P, Q) matrix touches memory and no atomics or
// merge pass are needed. The two directions compute each pair's distance
// with the same instructions (|p|² + |q|² and the dot product are symmetric
// in p and q), so min_ba is the column minimum of the same distances. Tiles
// stop at the counts by index: capacities need no padding to a tile
// multiple (the JAX wrapper's pad was a TPU layout constraint). Entries at
// or past a count are written as kBig, as is the minimum of a point whose
// other set is empty (the 1e30 of the JAX kernel).

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kQ = kThreads * kPerThread;  // query points per block
constexpr int kTile = 512;                 // other-set points per shared tile

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

__global__ void __launch_bounds__(kThreads)
chamfer_kernel(const float* __restrict__ a, const int* __restrict__ n_a,
               const float* __restrict__ b, const int* __restrict__ n_b,
               float* __restrict__ min_ab, float* __restrict__ min_ba, int cap_a, int cap_b) {
  __shared__ float4 tile[kTile];
  const int pair = blockIdx.y;
  const bool rev = blockIdx.z == 1;
  const int cap_q = rev ? cap_b : cap_a, cap_o = rev ? cap_a : cap_b;
  const int q0 = blockIdx.x * kQ;
  if (q0 >= cap_q) return;  // grid.x covers the larger capacity
  const float* q = (rev ? b : a) + static_cast<size_t>(pair) * cap_q * 3;
  const float* o = (rev ? a : b) + static_cast<size_t>(pair) * cap_o * 3;
  const int nq = min(max((rev ? n_b : n_a)[pair], 0), cap_q);
  const int no = min(max((rev ? n_a : n_b)[pair], 0), cap_o);
  float* out = (rev ? min_ba : min_ab) + static_cast<size_t>(pair) * cap_q;

  float qx[kPerThread], qy[kPerThread], qz[kPerThread], q2[kPerThread], best[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = q0 + j * kThreads + threadIdx.x;
    qx[j] = qy[j] = qz[j] = 0.f;
    if (p < nq) {
      qx[j] = q[3 * p];
      qy[j] = q[3 * p + 1];
      qz[j] = q[3 * p + 2];
    }
    q2[j] = norm2(qx[j], qy[j], qz[j]);
    best[j] = kBig;
  }

  if (q0 < nq) {  // uniform over the block: the barriers below are safe
    for (int t0 = 0; t0 < no; t0 += kTile) {
      __syncthreads();  // the previous tile is fully read
      for (int i = threadIdx.x; i < kTile && t0 + i < no; i += kThreads) {
        const float* src = o + 3 * static_cast<size_t>(t0 + i);
        const float x = src[0], y = src[1], z = src[2];
        tile[i] = make_float4(x, y, z, norm2(x, y, z));
      }
      __syncthreads();
      const int m = min(kTile, no - t0);
      for (int i = 0; i < m; ++i) {
        const float4 v = tile[i];  // the same word for every lane: a broadcast
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const float s = __fadd_rn(q2[j], v.w);
          const float d = fmaxf(__fsub_rn(s, 2.f * dot3(qx[j], qy[j], qz[j], v.x, v.y, v.z)),
                                0.f);
          best[j] = fminf(best[j], d);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = q0 + j * kThreads + threadIdx.x;
    if (p < cap_q) out[p] = p < nq ? best[j] : kBig;
  }
}

}  // namespace

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a (batch, cap_a, 3), b (batch, cap_b, 3) float32 row-major; n_a, n_b
// (batch,) int32 counts -> min_ab (batch, cap_a), min_ba (batch, cap_b)
// float32. 1 <= batch <= 65535, cap_a, cap_b >= 1. Returns a cudaError_t
// value.
extern "C" int rf_chamfer(const float* a, const int* n_a, const float* b, const int* n_b,
                          float* min_ab, float* min_ba, int batch, int cap_a, int cap_b,
                          cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || cap_a < 1 || cap_b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = cap_a > cap_b ? cap_a : cap_b;
  const dim3 grid((cap + kQ - 1) / kQ, batch, 2);
  chamfer_kernel<<<grid, kThreads, 0, stream>>>(a, n_a, b, n_b, min_ab, min_ba, cap_a, cap_b);
  return static_cast<int>(cudaGetLastError());
}
