// Exact top-k of each row of a float32 score matrix, in one pass over it.
//
// Replaces the Pallas kernel `_topk_kernel` / `pallas_topk` of
// retrieval_fuse_tpu/ops/pallas_topk.py:32 and :59 (the dense kNN select of
// the serving engine's `topk1p` token). Python side: ops/topk.py.
//
// Bound on the H100: bytes. The function must read the (Q, N) scores once
// (444.5 MB at Q=4096, N=27,132: ~0.13 ms at 3.35 TB/s) and does about one
// compare per score, far below the card's rates.
//
// Design: one warp per row. Each lane walks the row's columns at a stride
// of 32 float4s (16 B per lane, neighbouring lanes on neighbouring
// addresses) with several loads in flight, and keeps a sorted top-K in
// registers; a warp butterfly then merges the 32 lists. The Pallas grid
// carried its running top-k across column tiles in the output block, which
// needs its grid to run in order; CUDA blocks run in no order, so the whole
// column loop lives inside one warp instead and no block depends on another.
// The ragged right edge needs no -inf masking: a lane simply stops at N.
// Ties go to the lower column (select.cuh).

#include <cuda_runtime.h>
#include <cstdint>

#include "select.cuh"

namespace {

constexpr int kWarps = 8;

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
topk_rows(const float* __restrict__ sims, float* __restrict__ out_v,
          int* __restrict__ out_i, int q, int n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= q) return;  // whole warp leaves together
  const float* r = sims + static_cast<size_t>(row) * n;

  rf::TopK<K> t;
  t.init();
  const bool vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(r) % 16 == 0);
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(r);
    const int n4 = n / 4;
    int c = lane;
    for (; c + 96 < n4; c += 128) {
      float4 a = __ldcs(r4 + c), b = __ldcs(r4 + c + 32);
      float4 d = __ldcs(r4 + c + 64), e = __ldcs(r4 + c + 96);
      const float4 v4[4] = {a, b, d, e};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = 4 * (c + 32 * u);
        t.push(v4[u].x, col);
        t.push(v4[u].y, col + 1);
        t.push(v4[u].z, col + 2);
        t.push(v4[u].w, col + 3);
      }
    }
    for (; c < n4; c += 32) {
      float4 a = __ldcs(r4 + c);
      t.push(a.x, 4 * c);
      t.push(a.y, 4 * c + 1);
      t.push(a.z, 4 * c + 2);
      t.push(a.w, 4 * c + 3);
    }
  } else {
    for (int c = lane; c < n; c += 32) t.push(__ldcs(r + c), c);
  }

  float bv[K];
  int bi[K];
  rf::warp_merge<K>(t, 32, bv, bi);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out_v[static_cast<size_t>(row) * K + j] = bv[j];
      out_i[static_cast<size_t>(row) * K + j] = bi[j];
    }
  }
}

template <int K>
void launch(const float* sims, float* v, int* i, int q, int n, cudaStream_t s) {
  topk_rows<K><<<(q + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(sims, v, i, q, n);
}

}  // namespace

// sims (q, n) float32 row-major -> vals (q, k) float32, idx (q, k) int32,
// best first. 1 <= k <= 8, q >= 1, n >= k. Returns cudaGetLastError().
extern "C" int rf_topk(const float* sims, float* vals, int* idx, int q, int n, int k,
                       cudaStream_t stream) {
  switch (k) {
    case 1: launch<1>(sims, vals, idx, q, n, stream); break;
    case 2: launch<2>(sims, vals, idx, q, n, stream); break;
    case 3: launch<3>(sims, vals, idx, q, n, stream); break;
    case 4: launch<4>(sims, vals, idx, q, n, stream); break;
    case 5: launch<5>(sims, vals, idx, q, n, stream); break;
    case 6: launch<6>(sims, vals, idx, q, n, stream); break;
    case 7: launch<7>(sims, vals, idx, q, n, stream); break;
    case 8: launch<8>(sims, vals, idx, q, n, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
