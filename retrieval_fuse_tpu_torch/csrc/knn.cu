// Streaming exact cosine kNN: top-k database rows by q . row for each query,
// without materialising the (Q, N) score matrix.
//
// Replaces the Pallas kernel `_knn_kernel` (with `_topk_by_iteration`) /
// `pallas_exact_knn` of retrieval_fuse_tpu/ops/pallas_knn.py:49, :31 and
// :74 (the serving engine's kNN at query batches >= 8192). Python side:
// ops/streaming_knn.py.
//
// Bound on the H100: operations. 2 * Q * N * 64 flops (28.5 GFLOP at
// Q=8192, N=27,132) at the 67 TFLOP/s float32 rate outside the tensor cores
// is ~0.43 ms; the bytes (queries once, the 6.9 MB database once, which L2
// keeps) take ~0.01 ms. Float32 FMA, no TF32, so the ranking follows the
// plain float32 version's up to summation order.
//
// Design: a block owns kTQ queries and walks the whole database in kTN-row
// tiles staged (transposed) in shared memory; each thread scores 4 queries
// against 4 rows per tile with register FMAs and keeps a running top-K per
// query in registers; at the end the 16 threads that share a query merge
// their lists with shuffles. Because one block sees every database row of
// its queries, no second merge pass across blocks is needed. Rows >= N are
// skipped by an index test: the TPU kernel's sentinel column (an extra
// dimension of -4 on pad rows, ops/pallas_knn.py:102-112) existed only
// because its tiles could not mask, and it is not carried over; nor is the
// padding of Q and N to tile multiples. Ties go to the lower row
// (select.cuh).

#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kD = 64;     // embedding width (latent_dim)
constexpr int kTQ = 64;    // queries per block
constexpr int kTN = 64;    // database rows per shared-memory tile
constexpr int kThreads = 256;
constexpr int kLd = kTQ + 4;  // padded row of the transposed tiles
static_assert(kTQ == kTN, "load_transposed stages 64-row tiles of both");

// rows [r0, r0 + 64) of a (rows, 64) matrix -> dst[d][row], zero past `rows`
__device__ __forceinline__ void load_transposed(const float* __restrict__ src, int r0,
                                                int rows, float (*dst)[kLd]) {
  for (int t = threadIdx.x; t < kTQ * kD / 4; t += kThreads) {
    const int row = t % kTQ, chunk = t / kTQ;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < rows)
      v = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + row) * kD) + chunk);
    dst[4 * chunk + 0][row] = v.x;
    dst[4 * chunk + 1][row] = v.y;
    dst[4 * chunk + 2][row] = v.z;
    dst[4 * chunk + 3][row] = v.w;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ queries, const float* __restrict__ db,
           float* __restrict__ out_v, int* __restrict__ out_i, int q, int n) {
  __shared__ __align__(16) float qs[kD][kLd];
  __shared__ __align__(16) float ds[kD][kLd];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTQ;

  load_transposed(queries, q0, q, qs);
  rf::TopK<K> best[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) best[a].init();

  for (int n0 = 0; n0 < n; n0 += kTN) {
    __syncthreads();  // previous tile fully read (and qs written)
    load_transposed(db, n0, n, ds);
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[d][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&ds[d][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col < n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) best[i].push(acc[i][j], col);
      }
    }
  }

  // the 16 threads with equal ty are lanes 0-15 or 16-31 of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float bv[K];
    int bi[K];
    rf::warp_merge<K>(best[i], 16, bv, bi);
    const int row = q0 + 4 * ty + i;
    if (tx == 0 && row < q) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        out_v[static_cast<size_t>(row) * K + j] = bv[j];
        out_i[static_cast<size_t>(row) * K + j] = bi[j];
      }
    }
  }
}

template <int K>
void launch(const float* qr, const float* db, float* v, int* i, int q, int n,
            cudaStream_t s) {
  knn_kernel<K><<<(q + kTQ - 1) / kTQ, kThreads, 0, s>>>(qr, db, v, i, q, n);
}

}  // namespace

// queries (q, 64), db (n, 64) float32 row-major, 16-byte aligned ->
// sims (q, k) float32 and idx (q, k) int32, best first. 1 <= k <= 8,
// q >= 1, n >= k. Returns cudaGetLastError().
extern "C" int rf_knn(const float* queries, const float* db, float* sims, int* idx,
                      int q, int n, int k, cudaStream_t stream) {
  switch (k) {
    case 1: launch<1>(queries, db, sims, idx, q, n, stream); break;
    case 2: launch<2>(queries, db, sims, idx, q, n, stream); break;
    case 3: launch<3>(queries, db, sims, idx, q, n, stream); break;
    case 4: launch<4>(queries, db, sims, idx, q, n, stream); break;
    case 5: launch<5>(queries, db, sims, idx, q, n, stream); break;
    case 6: launch<6>(queries, db, sims, idx, q, n, stream); break;
    case 7: launch<7>(queries, db, sims, idx, q, n, stream); break;
    case 8: launch<8>(queries, db, sims, idx, q, n, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
