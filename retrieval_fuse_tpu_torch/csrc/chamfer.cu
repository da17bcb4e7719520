// Masked chamfer minima: for a batch of point-set pairs (a, b), the squared
// distance from each point of a to its nearest point of b, and from each
// point of b to its nearest point of a.
//
// Replaces the Pallas kernel `_chamfer_kernel` / `pallas_chamfer` of
// retrieval_fuse_tpu/ops/pallas_chamfer.py:21 and :50 (the metric of
// ops/chamfer.chamfer_batch, which Chamfer3D runs). Python side:
// ops/streaming_chamfer.py; the masked means are one torch reduction there.
//
// d(p, q) = max(|p|² + |q|² - 2 p·q, 0), as the JAX kernel writes it.
//
// Bound on the H100: operations, at the 67 TFLOP/s float32 rate outside the
// tensor cores; the bytes (each point read once, each minimum written once)
// are small beside them. The depth-3 product gives the tensor cores nothing
// to do: this is an FMA kernel, and what it can save is instructions a
// pair and idle SMs.
//
// Design.
//   - Two directions in one launch; a block owns kQ query points of one set
//     of one pair, kPerThread in each thread's registers, and streams points
//     of the other set through shared memory in tiles of (x, y, z, |v|²).
//     Every lane reads the same 16 bytes (a broadcast), which feed
//     kPerThread independent chains. No (P, Q) matrix touches memory.
//   - The per-pair work is three FMAs and one minimum. x -> max(|q|² + x, 0)
//     is monotone and rounds monotonically, so
//       min_i max(|q|² + (|v_i|² - 2 q·v_i), 0)
//         = max(|q|² + min_i (|v_i|² - 2 q·v_i), 0)
//     for the same inner values; with (-2qx, -2qy, -2qz) in registers the
//     inner value is fma(-2qx, vx, fma(-2qy, vy, fma(-2qz, vz, |v|²))). The
//     FMAs round once where separate products and sums round five times. On
//     voxel coordinates that changes nothing: the coordinates are integers
//     below 2^10, so every product, partial sum and |v|² is an integer of
//     magnitude below 2^24, exact in float32 in any order and with or
//     without intermediate rounding, and the minima equal the plain
//     version's bit for bit. On float coordinates they differ from it by
//     rounding only (<= 1e-5 at unit scale).
//   - One pair must fill the card (`evaluate` calls with B = 1, a target of
//     ~5K points against a prediction of ~39K: 21 query blocks stream the
//     long set, and an unsplit block would walk all of it). So the streamed
//     set is split S ways across the blocks of a thread-block cluster (S =
//     1, 2, 4 or 8, chosen from the capacities, B and the SM count: kWaves
//     blocks for every SM, S = 1 where B alone gives them; the counts are on
//     the device, so the capacities stand in for them, and buffers a few
//     times larger than their counts are why kWaves is 16). The S blocks
//     hold the same query points and run over S even runs of the streamed
//     set's valid points; each leaves its partial minima in its shared
//     memory, and after a cluster barrier block s merges the s-th share of
//     the query points from all S blocks through distributed shared memory
//     and writes them. min is associative and commutative, so the result
//     does not depend on S or on any order: one launch, no atomics, no
//     second pass, nothing to initialise.
//   - Each distance is still computed twice, once for each direction. Merging
//     column minima across threads instead would need atomics in the inner
//     loop, which this design avoids.
//   Tiles stop at the counts by index: capacities need no padding to a tile
//   multiple (the JAX wrapper's pad was a TPU layout constraint). Entries at
//   or past a count are written as kBig, as is the minimum of a point whose
//   other set is empty (the 1e30 of the JAX kernel).
//
//   Block shape: 128 threads x 2 points. Blocks of 256 to 1024 points run
//   the inner loop at the same rate whatever the ratio of shared-memory loads
//   to FMAs (one to 8 or to 32); small blocks leave a shorter tail where
//   counts are ragged, and a short set against a long one still gives
//   enough blocks to spread the long one's runs over the card.
//
// tools/torch_port_kernel_probe.py builds other block shapes
// (-DRF_PROBE_CHAMFER_THREADS, -DRF_PROBE_CHAMFER_POINTS), other targets of
// blocks per SM (-DRF_PROBE_CHAMFER_WAVES) and, with -DRF_PROBE_CHAMFER_ATOMIC=S,
// the other way to merge: no clusters, up to S splits, atomicMin on the bits
// of the clamped (non-negative) minima into outputs that a fill kernel of
// the same call initialises; -DRF_PROBE_CHAMFER_NO_MIN and
// -DRF_PROBE_CHAMFER_NO_FMA time each half of the inner loop alone (their
// minima are meaningless). Measured: PERF.md.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

#ifndef RF_PROBE_CHAMFER_THREADS
#define RF_PROBE_CHAMFER_THREADS 128
#endif
#ifndef RF_PROBE_CHAMFER_POINTS
#define RF_PROBE_CHAMFER_POINTS 2
#endif
#ifndef RF_PROBE_CHAMFER_WAVES
#define RF_PROBE_CHAMFER_WAVES 16
#endif

constexpr float kBig = 1e30f;
constexpr int kThreads = RF_PROBE_CHAMFER_THREADS;
constexpr int kPerThread = RF_PROBE_CHAMFER_POINTS;
constexpr int kQ = kThreads * kPerThread;  // query points per block
constexpr int kTile = 512;                 // other-set points per shared tile
constexpr int kUnroll = 4;                 // tile entries per step of the inner loop
constexpr int kWaves = RF_PROBE_CHAMFER_WAVES;  // blocks wanted for every SM
#ifdef RF_PROBE_CHAMFER_ATOMIC
constexpr int kMaxSplits = RF_PROBE_CHAMFER_ATOMIC;
#else
constexpr int kMaxSplits = 8;  // the portable cluster size
#endif
static_assert(kQ % kMaxSplits == 0 && kTile % kUnroll == 0, "even shares");

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

#ifdef RF_PROBE_CHAMFER_ATOMIC
__global__ void fill_big(float* __restrict__ p, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    p[i] = kBig;
}
#endif

// grid (query blocks, pairs, 2 directions x splits); kSplit: splits > 1, the
// blocks of one direction's splits are a cluster
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
chamfer_kernel(const float* __restrict__ a, const int* __restrict__ n_a,
               const float* __restrict__ b, const int* __restrict__ n_b,
               float* __restrict__ min_ab, float* __restrict__ min_ba, int cap_a, int cap_b,
               int splits) {
  __shared__ float4 tile[kTile];
  __shared__ float part[kSplit ? kQ : 1];
  const int pair = blockIdx.y;
  const bool rev = blockIdx.z / splits == 1;
  const int split = blockIdx.z % splits;
  const int cap_q = rev ? cap_b : cap_a, cap_o = rev ? cap_a : cap_b;
  const int q0 = blockIdx.x * kQ;
  if (q0 >= cap_q) return;  // grid.x covers the larger capacity; the same for a whole cluster
  const float* q = (rev ? b : a) + static_cast<size_t>(pair) * cap_q * 3;
  const float* o = (rev ? a : b) + static_cast<size_t>(pair) * cap_o * 3;
  const int nq = min(max((rev ? n_b : n_a)[pair], 0), cap_q);
  const int no = min(max((rev ? n_a : n_b)[pair], 0), cap_o);
  float* out = (rev ? min_ba : min_ab) + static_cast<size_t>(pair) * cap_q;

  if (q0 >= nq) {  // nothing valid here (the same for a whole cluster): this block's share
    const int share = kQ / splits;
    for (int i = threadIdx.x; i < share; i += kThreads) {
      const int p = q0 + split * share + i;
#ifdef RF_PROBE_CHAMFER_ATOMIC
      (void)p;  // the fill kernel wrote kBig
#else
      if (p < cap_q) out[p] = kBig;
#endif
    }
    return;
  }

  // the inner value of a pair is |v|² + mx·vx + my·vy + mz·vz with m = -2q
  float mx[kPerThread], my[kPerThread], mz[kPerThread], q2[kPerThread], best[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = q0 + j * kThreads + threadIdx.x;
    float x = 0.f, y = 0.f, z = 0.f;
    if (p < nq) {
      x = q[3 * p];
      y = q[3 * p + 1];
      z = q[3 * p + 2];
    }
    q2[j] = norm2(x, y, z);
    mx[j] = -2.f * x, my[j] = -2.f * y, mz[j] = -2.f * z;
    best[j] = kBig;
  }

  // this block's run of the other set's valid points
  const int run = (no + splits - 1) / splits;
  const int s0 = min(split * run, no), s1 = min(s0 + run, no);
  for (int t0 = s0; t0 < s1; t0 += kTile) {
    const int m = min(kTile, s1 - t0), padded = (m + kUnroll - 1) / kUnroll * kUnroll;
    __syncthreads();  // the previous tile is fully read
    for (int i = threadIdx.x; i < padded; i += kThreads) {
      if (i < m) {
        const float* src = o + 3 * static_cast<size_t>(t0 + i);
        const float x = src[0], y = src[1], z = src[2];
        tile[i] = make_float4(x, y, z, norm2(x, y, z));
      } else {
        tile[i] = make_float4(0.f, 0.f, 0.f, kBig);  // loses every minimum
      }
    }
    __syncthreads();
    for (int i = 0; i < padded; i += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 v = tile[i + u];  // the same word for every lane: a broadcast
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
#ifdef RF_PROBE_CHAMFER_NO_FMA  // the minima alone: one addition a pair
          const float inner = v.w + mx[j];
#else
          const float inner = fmaf(mx[j], v.x, fmaf(my[j], v.y, fmaf(mz[j], v.z, v.w)));
#endif
#ifdef RF_PROBE_CHAMFER_NO_MIN  // the FMAs alone: a sum in place of the minimum
          best[j] += inner;
#else
          best[j] = fminf(best[j], inner);
#endif
        }
      }
    }
  }

  // d = max(|q|² + min, 0); kBig where the run was empty or the point is padding
  float d[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = q0 + j * kThreads + threadIdx.x;
    d[j] = p < nq && best[j] < kBig ? fmaxf(__fadd_rn(q2[j], best[j]), 0.f) : kBig;
  }

  if constexpr (!kSplit) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int p = q0 + j * kThreads + threadIdx.x;
      if (p < cap_q) out[p] = d[j];
    }
  } else {
#ifdef RF_PROBE_CHAMFER_ATOMIC
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int p = q0 + j * kThreads + threadIdx.x;
      // non-negative floats order as their bits do
      if (p < nq) atomicMin(reinterpret_cast<int*>(out) + p, __float_as_int(d[j]));
    }
#else
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) part[j * kThreads + threadIdx.x] = d[j];
    cluster.sync();  // every block's partial minima are in its shared memory
    const int share = kQ / splits;
    for (int i = threadIdx.x; i < share; i += kThreads) {
      const int local = static_cast<int>(cluster.block_rank()) * share + i;
      float best_all = kBig;
      for (int s = 0; s < splits; ++s)
        best_all = fminf(best_all, cluster.map_shared_rank(part, s)[local]);
      if (q0 + local < cap_q) out[q0 + local] = best_all;
    }
    cluster.sync();  // no block leaves while another still reads its shared memory
#endif
  }
}

}  // namespace

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a (batch, cap_a, 3), b (batch, cap_b, 3) float32 row-major; n_a, n_b
// (batch,) int32 counts -> min_ab (batch, cap_a), min_ba (batch, cap_b)
// float32. 1 <= batch <= 65535, cap_a, cap_b >= 1. One kernel launch.
// Returns a cudaError_t value.
extern "C" int rf_chamfer(const float* a, const int* n_a, const float* b, const int* n_b,
                          float* min_ab, float* min_ba, int batch, int cap_a, int cap_b,
                          cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || cap_a < 1 || cap_b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cap = cap_a > cap_b ? cap_a : cap_b;
  const int qblocks = (cap + kQ - 1) / kQ;
  const long long unsplit = 2LL * qblocks * batch;
  int splits = 1;
  while (splits < kMaxSplits && unsplit * splits < static_cast<long long>(kWaves) * sms)
    splits *= 2;
  const dim3 grid(qblocks, batch, 2 * splits);
  if (splits == 1) {
    chamfer_kernel<false><<<grid, kThreads, 0, stream>>>(a, n_a, b, n_b, min_ab, min_ba, cap_a,
                                                         cap_b, 1);
    return static_cast<int>(cudaGetLastError());
  }
#ifdef RF_PROBE_CHAMFER_ATOMIC
  fill_big<<<64, 256, 0, stream>>>(min_ab, static_cast<size_t>(batch) * cap_a);
  fill_big<<<64, 256, 0, stream>>>(min_ba, static_cast<size_t>(batch) * cap_b);
  chamfer_kernel<true><<<grid, kThreads, 0, stream>>>(a, n_a, b, n_b, min_ab, min_ba, cap_a,
                                                      cap_b, splits);
  return static_cast<int>(cudaGetLastError());
#else
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = splits;  // one direction's splits: blockIdx.z / splits is shared
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, chamfer_kernel<true>, a, n_a, b, n_b, min_ab,
                                             min_ba, cap_a, cap_b, splits));
#endif
}
