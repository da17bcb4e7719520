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
//
// k <= 8, the engine's K in every shipped config, has an instance of its
// own (a K-slot list a lane). Every other k up to 32 takes the general
// instance of 16 or 32 slots, KP >= k: under the total order of select.cuh
// the top k is the first k of the top KP, so writing those k gives the same
// values and indices, ties included. What bounds it on the card is the same
// read of the scores; the longer lists cost registers (2 x KP a lane, and
// the merge's 2 x KP) and one compare-and-swap pass of KP slots for each
// score that beats a lane's KP-th. A warp runs that pass whenever any of its
// lanes takes a score, and with 16 or 32 slots a lane some lane does at
// almost every column (measured on an H100: 0.557 ms at k 12, 1.676 ms at
// k 32, against 0.154 at k 4). So the general instances also keep a warp-wide
// threshold: after rounds 2, 6 and 18 of the column loop the warp merges a
// copy of its lists to the row's k-th best so far, and a lane takes only
// what beats it. Exact: the lists hold the row's top k so far (a score that
// was rejected had k better ones already), so nothing rejected is in the
// final top k. `n >= k` is all it needs of N: slots past N stay (-inf,
// INT_MAX) and are never among the k written.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "select.cuh"

namespace {

constexpr int kWarps = 8;

// K slots a lane; the merged list is written whole (k = K), or with
// kPrefix (the general instances) its first k
template <int K, bool kPrefix>
__global__ void __launch_bounds__(kWarps * 32)
topk_rows(const float* __restrict__ sims, float* __restrict__ out_v,
          int* __restrict__ out_i, int q, int n, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= q) return;  // whole warp leaves together
  const float* r = sims + static_cast<size_t>(row) * n;

  rf::TopK<K> t;
  t.init();
  // the general instances' warp-wide threshold: the row's k-th best so far
  float tv = -INFINITY;
  int ti = INT_MAX;
  auto push = [&](float val, int idx) {
    if (kPrefix && !rf::better(val, idx, tv, ti)) return;
    t.push(val, idx);
  };
  const bool vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(r) % 16 == 0);
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(r);
    const int n4 = n / 4;
    int c = lane;
    for (int round = 0; c + 96 < n4; c += 128, ++round) {
      // every lane is at this round where lane 31 is (the test holds for the
      // warp or for none of it)
      if (kPrefix && (round == 2 || round == 6 || round == 18) && 128 * round + 127 < n4)
        rf::warp_kth(t, k, tv, ti);
      float4 a = __ldcs(r4 + c), b = __ldcs(r4 + c + 32);
      float4 d = __ldcs(r4 + c + 64), e = __ldcs(r4 + c + 96);
      const float4 v4[4] = {a, b, d, e};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = 4 * (c + 32 * u);
        push(v4[u].x, col);
        push(v4[u].y, col + 1);
        push(v4[u].z, col + 2);
        push(v4[u].w, col + 3);
      }
    }
    for (; c < n4; c += 32) {
      float4 a = __ldcs(r4 + c);
      push(a.x, 4 * c);
      push(a.y, 4 * c + 1);
      push(a.z, 4 * c + 2);
      push(a.w, 4 * c + 3);
    }
  } else {
    for (int c = lane; c < n; c += 32) push(__ldcs(r + c), c);
  }

  float bv[K];
  int bi[K];
  rf::warp_merge<K>(t, 32, bv, bi);
  if (lane == 0) {
    const int kw = kPrefix ? k : K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (kPrefix && j >= k) break;
      out_v[static_cast<size_t>(row) * kw + j] = bv[j];
      out_i[static_cast<size_t>(row) * kw + j] = bi[j];
    }
  }
}

template <int K, bool kPrefix = false>
void launch(const float* sims, float* v, int* i, int q, int n, int k, cudaStream_t s) {
  topk_rows<K, kPrefix><<<(q + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(sims, v, i, q, n, k);
}

}  // namespace

// sims (q, n) float32 row-major -> vals (q, k) float32, idx (q, k) int32,
// best first. 1 <= k <= 32, q >= 1, n >= k: k <= 8 launches its own
// instance, 9 <= k <= 16 the general instance of 16 slots, 17 <= k <= 32
// that of 32. Returns cudaGetLastError().
extern "C" int rf_topk(const float* sims, float* vals, int* idx, int q, int n, int k,
                       cudaStream_t stream) {
  switch (k) {
    case 1: launch<1>(sims, vals, idx, q, n, k, stream); break;
    case 2: launch<2>(sims, vals, idx, q, n, k, stream); break;
    case 3: launch<3>(sims, vals, idx, q, n, k, stream); break;
    case 4: launch<4>(sims, vals, idx, q, n, k, stream); break;
    case 5: launch<5>(sims, vals, idx, q, n, k, stream); break;
    case 6: launch<6>(sims, vals, idx, q, n, k, stream); break;
    case 7: launch<7>(sims, vals, idx, q, n, k, stream); break;
    case 8: launch<8>(sims, vals, idx, q, n, k, stream); break;
    default:
      if (k < 1 || k > 32) return static_cast<int>(cudaErrorInvalidValue);
      if (k <= 16)
        launch<16, true>(sims, vals, idx, q, n, k, stream);
      else
        launch<32, true>(sims, vals, idx, q, n, k, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
