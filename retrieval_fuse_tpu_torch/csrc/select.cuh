// Exact top-k selection helpers shared by topk.cu and knn.cu.
//
// A candidate is a (value, index) pair. The order is: larger value first,
// and among equal values the lower index first -- the tie rule of
// jax.lax.top_k and of the plain iterative_topk. Comparing pairs under this
// total order makes the result independent of the order in which a thread
// or a warp sees the candidates, which a CUDA grid does not fix.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace rf {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// A per-thread running top-K list, sorted best first. Empty slots hold
// (-inf, INT_MAX), which every real candidate beats, -inf values included.
template <int K>
struct TopK {
  float v[K];
  int i[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = -INFINITY;
      i[j] = INT_MAX;
    }
  }

  __device__ __forceinline__ void push(float val, int idx) {
    if (!better(val, idx, v[K - 1], i[K - 1])) return;
    v[K - 1] = val;
    i[K - 1] = idx;
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (better(v[j], i[j], v[j - 1], i[j - 1])) {
        float tv = v[j]; v[j] = v[j - 1]; v[j - 1] = tv;
        int ti = i[j]; i[j] = i[j - 1]; i[j - 1] = ti;
      }
    }
  }

  __device__ __forceinline__ void pop_front() {
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
      v[j] = v[j + 1];
      i[j] = i[j + 1];
    }
    v[K - 1] = -INFINITY;
    i[K - 1] = INT_MAX;
  }
};

// Merge the lists of `width` neighbouring lanes (width a power of two <= 32,
// every lane of the warp taking part): K rounds, each a butterfly max over
// the list heads, after which the lane holding the winner drops it. Every
// lane of the group ends with the same (out_v, out_i), best first. Indices
// are unique across lanes, so exactly one lane pops each round.
template <int K>
__device__ __forceinline__ void warp_merge(TopK<K>& t, int width, float (&out_v)[K],
                                           int (&out_i)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float bv = t.v[0];
    int bi = t.i[0];
    for (int off = width >> 1; off > 0; off >>= 1) {
      float ov = __shfl_xor_sync(kFullMask, bv, off);
      int oi = __shfl_xor_sync(kFullMask, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    out_v[r] = bv;
    out_i[r] = bi;
    if (t.i[0] == bi && t.v[0] == bv) t.pop_front();
  }
}

// The k-th best (k <= K) of the union of the lists of a warp's 32 lanes
// into (kv, ki) in every lane, the lists left as they were: warp_merge's
// rounds on a copy (topk.cu's warp-wide threshold). Every lane takes part.
template <int K>
__device__ __forceinline__ void warp_kth(const TopK<K>& t, int k, float& kv, int& ki) {
  TopK<K> u = t;
  for (int r = 0; r < k; ++r) {
    float bv = u.v[0];
    int bi = u.i[0];
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_xor_sync(kFullMask, bv, off);
      int oi = __shfl_xor_sync(kFullMask, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    kv = bv;
    ki = bi;
    if (u.i[0] == bi && u.v[0] == bv) u.pop_front();
  }
}

}  // namespace rf

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
