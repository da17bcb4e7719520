// K-way patch attention over one tile of up to 64 rows: the body shared by
// the three attention kernels (gathered_attention.cu, gathered_attention_v1.cu,
// patch_attention.cu). They differ only in where a tile's rows come from,
// which each kernel describes by a row source (StridedRows or BankRows)
// before it calls `attend_tile`.
//
// For each row r (F = nf·e³ features: 32, 64, 96, 128 at nf 4, 8, 12, 16) and each
// of its K candidate rows p_k:
//   xf = l2norm(theta(x)), pf_k = l2norm(phi(p_k)); theta and phi are
//   F->128->128->128->C MLPs with LeakyReLU 0.01 (C = cf_feat = 32)
//   s_k = xf . pf_k, switch = relu(max_k s_k)
//   w = onehot(argmax_k 25 s_k) (hard) or softmax(sharpness s) (soft)
//   out = x (1 - switch) + (sum_k w_k p_k) switch
//
// Arithmetic follows the JAX `_mlp` (retrieval_fuse_tpu/ops/
// pallas_attention.py:30-43): each GEMM multiplies values of the input dtype
// with float32 accumulation, the bias is float32, and in bf16 the hidden
// activations are rounded back to bf16 between layers. Norms, scores,
// selection and blend are float32.
//
// Three bodies compute this, chosen by a kernel from its element type and
// instance. The shipped instances are templates on F, built for the widths
// of `with_width` (32 to 128): only layer 0's contraction, the row loads and
// the blend change with it; hidden 128 and C 32 are the attention module's
// own and do not depend on nf.
//
// bf16, the shipped instances of gathered_attention.cu and
// patch_attention.cu: attention_wgmma.cuh's body on Hopper's warpgroup MMA,
// a warpgroup a 64-row tile, put together from the per-warp pieces below
// (its header says what bounds it and what it measured).
//
// bf16 on mma.sync.m16n8k16, 16 rows a warp (the pieces below;
// gathered_attention_v1.cu puts them together around its staged
// candidates and keeps only phi resident, attention_general.cuh around
// layer 0 read from L1/L2): bf16 products with float32 sums are what
// mma.sync.m16n8k16.bf16 computes, so only the order of the sums differs
// from the plain version. The pieces:
//   - Weights in shared memory for the life of the block, laid out once in
//     the order the B fragments are read (`stage_fragments`: one 16-byte
//     load a lane for a k16 step of two n8 tiles), with the 2 x 416 float32
//     biases; one block per SM, so the launches are persistent.
//   - The layer chain stays in registers. A warp owns 16 rows. The float32
//     C fragments of a layer (64 registers a thread), after bias, LeakyReLU
//     and the round to bf16, are the A fragments of the next layer's k16
//     steps (`hidden_to_fragments`, mma.cuh), so no activation goes through
//     shared memory. wgmma's per-warp A fragments and accumulators have the
//     same layouts, which is why the wgmma body reuses this.
//   - The input rows need no staging either: a sum over k may take k in any
//     order, so layer 0's weights are laid out for a permuted k, in which a
//     lane's A fragments of two k16 steps are one 16-byte run of its row.
//     A lane reads its rows from global memory with F/16 16-byte loads
//     (`load_rows16`; 8 at F = 128, 6 at F = 96: layer 0 is F/16 k16
//     steps), every 32-byte sector used in full, and candidate k+1's loads
//     are started before candidate k's MLP, so they arrive under it.
//   - A row's 32 embedding values lie in the four lanes of a quad: norms and
//     scores are partial sums and two shuffles (`score_mma`). Scores pass
//     through shared memory to the lane that selects for a row
//     (`select_mma`); the blend is the float32 body's arithmetic, per warp,
//     its row loads batched (`blend_mma`).
//   What holds a 16-row warp is shared-memory reads beside the mma.sync
//   rate: each B fragment feeds one m16 tile, so a hidden layer's 128 mma of
//   a warp need 64 16-byte loads (~2 shared-memory cycles per tensor cycle),
//   and more warps change little. The shipped instances ran on these pieces
//   at 1.12-1.15 ms at F = 128, Q = 8192, K = 4 on an H100, 4x their bound;
//   wgmma reads each B tile once for 64 rows.
//
// float32 FMAs (`attend_tile`; the float32 launches of the three kernels):
// float32 on the tensor cores would be TF32 (~3 decimal digits). One block
// of 256 threads per tile. The
// tile's rows are brought into a shared-memory activation buffer (float32),
// and each MLP layer is a shared-memory-tiled GEMM: 32-row chunks of the
// weight matrix (read from global memory, where the 213 KB of theta + phi
// weights stay L2-resident) are staged in shared memory and every thread
// accumulates a 4x8 (or 1x8) register tile with float32 FMAs. theta runs
// once, then phi once per candidate, each reusing the same two 33 KB
// activation buffers (rows of kH floats: layer 0 reads the first F); only
// the scores stay. The blend re-reads x and the
// selected candidates from where they came from. Rows past the tile's valid
// count are zero in the activations and are never written.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace rf_attention {

constexpr int kT = 64;       // rows per tile
constexpr int kH = 128;      // MLP hidden width
constexpr int kC = 32;       // embedding width (cf_feat)
constexpr int kMaxK = 8;
constexpr int kThreads = 256;
constexpr int kLd = kH + 4;  // padded activation row, in floats (F <= kH)
constexpr int kKc = 32;      // weight rows per staged chunk

// The layout of one MLP's packed weights at row width F: fc0 (F, H), fc1
// (H, H), fc2 (H, H), out (H, C), each (in, out) row-major, at element
// offsets 0, kW1, kW2, kW3; packed biases: fc0, fc1, fc2 (H each), out (C).
template <int F>
struct Width {
  static_assert(F % 32 == 0 && F >= 32 && F <= kH, "whole 16-byte runs of two k16 steps");
  static constexpr int kW1 = F * kH, kW2 = kW1 + kH * kH, kW3 = kW2 + kH * kH;
};

// Calls fn(std::integral_constant<int, F>{}) for the row width f, one of
// the widths the kernels are built for (F = nf·e³ at e = 2: nf 4, 8, 12 and
// 16, the nf the decoder tail takes); returns cudaErrorInvalidValue for any
// other.
template <typename Fn>
int with_width(int f, Fn fn) {
  switch (f) {
    case 32: return fn(std::integral_constant<int, 32>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 96: return fn(std::integral_constant<int, 96>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr size_t kSmemFloats =
    2 * kT * kLd        // activation buffers
    + kKc * kH          // staged weight chunk
    + kT * (kC + 1)     // normalised theta embedding
    + 2 * kT * kMaxK    // scores, selection weights
    + kT;               // switch
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kSmemBytes % 16 == 0, "a staging area after it stays 16-byte aligned");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype in JAX
}

// Where a tile's rows are, as a row source: x row i at x + i*F; candidate
// k's row i at cand(k) + i*stride; rows [0, n) are valid. A policy type,
// not an array of K pointers, so that nothing is indexed at run time in
// local memory.

// candidate k's rows start at cand0 + k*k_step (pre-gathered rows in global
// memory, or tiles staged in shared memory)
template <typename T>
struct StridedRows {
  const T* x;
  const T* cand0;
  size_t k_step;
  size_t stride;
  int n;
  int K;
  __device__ __forceinline__ const T* cand(int k) const { return cand0 + k * k_step; }
};

// candidate k is the (kT, F) bank tile idx[k]
template <typename T, int F>
struct BankRows {
  const T* x;
  const T* bank;
  const int* idx;
  int n;
  int K;
  static constexpr size_t stride = F;
  __device__ __forceinline__ const T* cand(int k) const {
    return bank + static_cast<size_t>(idx[k]) * kT * F;
  }
};

// ---- float32 FMAs ----

// rows [0, n) of a tile whose row i (F values) starts at src + i*stride ->
// act[i*kLd + c] as float32; rows [n, kT) are zero
template <typename T, int F>
__device__ __forceinline__ void load_rows(const T* src, size_t stride, int n, float* act) {
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte load
  for (int v = threadIdx.x; v < kT * F / kE; v += kThreads) {
    const int e0 = v * kE, row = e0 / F, col = e0 % F;
    float* dst = act + row * kLd + col;
    if (row < n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + row * stride + col);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kE; ++e) dst[e] = to_f32(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) dst[e] = 0.f;
    }
  }
}

// out[:, :NOUT] = act(in[:, :NIN] @ W + b), W (NIN, NOUT) of type T in
// global memory. `hidden`: LeakyReLU 0.01, then round to T.
template <typename T, int NIN, int NOUT>
__device__ __forceinline__ void dense(const float* in, float* out, const T* __restrict__ w,
                                      const float* __restrict__ bias, float* wbuf,
                                      bool hidden) {
  constexpr int kCg = NOUT / 8;             // column groups
  constexpr int kRm = kT * kCg / kThreads;  // rows per thread
  static_assert(kRm >= 1 && kT * kCg % kThreads == 0, "tile mapping");
  static_assert(NIN % kKc == 0, "whole staged chunks");
  const int tx = threadIdx.x % kCg, ty = threadIdx.x / kCg;
  // a thread's 8 columns: 4 at tx*4 and 4 at NOUT/2 + tx*4, so 16
  // neighbouring threads read 256 contiguous bytes of the weight chunk
  const int c0 = tx * 4, c1 = NOUT / 2 + tx * 4;
  float acc[kRm][8];
#pragma unroll
  for (int r = 0; r < kRm; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < NIN; k0 += kKc) {
    __syncthreads();  // wbuf free; `in` complete
    for (int i = threadIdx.x; i < kKc * NOUT; i += kThreads)
      wbuf[i] = to_f32(w[k0 * NOUT + i]);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKc; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(&wbuf[kk * NOUT + c0]);
      const float4 w1 = *reinterpret_cast<const float4*>(&wbuf[kk * NOUT + c1]);
#pragma unroll
      for (int r = 0; r < kRm; ++r) {
        const float a = in[(ty * kRm + r) * kLd + k0 + kk];
        acc[r][0] = fmaf(a, w0.x, acc[r][0]);
        acc[r][1] = fmaf(a, w0.y, acc[r][1]);
        acc[r][2] = fmaf(a, w0.z, acc[r][2]);
        acc[r][3] = fmaf(a, w0.w, acc[r][3]);
        acc[r][4] = fmaf(a, w1.x, acc[r][4]);
        acc[r][5] = fmaf(a, w1.y, acc[r][5]);
        acc[r][6] = fmaf(a, w1.z, acc[r][6]);
        acc[r][7] = fmaf(a, w1.w, acc[r][7]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRm; ++r) {
    const int row = ty * kRm + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? c0 + j : c1 + j - 4;
      float v = acc[r][j] + bias[col];
      if (hidden) v = to_f32(from_f32<T>(v >= 0.f ? v : 0.01f * v));
      out[row * kLd + col] = v;
    }
  }
}

// the 4-layer MLP on the (kT, F) rows in act0; leaves the (kT, kC) result in act0
template <typename T, int F>
__device__ __forceinline__ void mlp(float* act0, float* act1, const T* __restrict__ w,
                                    const float* __restrict__ b, float* wbuf) {
  using W = Width<F>;
  dense<T, F, kH>(act0, act1, w, b, wbuf, true);
  dense<T, kH, kH>(act1, act0, w + W::kW1, b + kH, wbuf, true);
  dense<T, kH, kH>(act0, act1, w + W::kW2, b + 2 * kH, wbuf, true);
  dense<T, kH, kC>(act1, act0, w + W::kW3, b + 3 * kH, wbuf, false);
  __syncthreads();
}

// max(||row||, 1e-12) over the first kC values of an activation row
__device__ __forceinline__ float row_norm(const float* row) {
  float ss = 0.f;
#pragma unroll 8
  for (int c = 0; c < kC; ++c) ss = fmaf(row[c], row[c], ss);
  return fmaxf(sqrtf(ss), 1e-12f);
}

// Attention over the tile of row source `r` (rows of F values); writes its
// valid rows to out (rows F apart) and, if sel_out is not null, each row's
// argmax candidate to sel_out[i]. `before_phi` runs once after theta, before
// the first candidate is read (a kernel that stages candidates waits there).
template <typename T, int F, bool kHard, typename Rows, typename BeforePhi>
__device__ __forceinline__ void attend_tile(const Rows& r, float* smem,
                                            const T* __restrict__ w_theta,
                                            const float* __restrict__ b_theta,
                                            const T* __restrict__ w_phi,
                                            const float* __restrict__ b_phi, float sharpness,
                                            T* __restrict__ out, int* __restrict__ sel_out,
                                            BeforePhi before_phi) {
  float* act0 = smem;
  float* act1 = act0 + kT * kLd;
  float* wbuf = act1 + kT * kLd;
  float* xf = wbuf + kKc * kH;
  float* score = xf + kT * (kC + 1);
  float* wsel = score + kT * kMaxK;
  float* sw = wsel + kT * kMaxK;
  const int t = threadIdx.x;
  const int K = r.K;

  load_rows<T, F>(r.x, F, r.n, act0);
  mlp<T, F>(act0, act1, w_theta, b_theta, wbuf);
  if (t < kT) {
    const float* row = act0 + t * kLd;
    const float d = row_norm(row);
#pragma unroll 8
    for (int c = 0; c < kC; ++c) xf[t * (kC + 1) + c] = row[c] / d;
  }
  before_phi();

  for (int k = 0; k < K; ++k) {
    __syncthreads();  // act0 free again; staged candidates visible
    load_rows<T, F>(r.cand(k), r.stride, r.n, act0);
    mlp<T, F>(act0, act1, w_phi, b_phi, wbuf);
    if (t < kT) {
      const float* row = act0 + t * kLd;
      const float d = row_norm(row);
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < kC; ++c) s = fmaf(xf[t * (kC + 1) + c], row[c] / d, s);
      score[t * kMaxK + k] = s;
    }
  }

  if (t < kT) {
    const float* s = score + t * kMaxK;
    float mx = s[0];
    int best = 0;
    for (int k = 1; k < K; ++k) {
      mx = fmaxf(mx, s[k]);
      if (s[k] * 25.f > s[best] * 25.f) best = k;  // first maximum wins
    }
    sw[t] = fmaxf(mx, 0.f);
    if (kHard) {
      for (int k = 0; k < K; ++k) wsel[t * kMaxK + k] = k == best ? 1.f : 0.f;
    } else {
      float m = sharpness * s[0];
      for (int k = 1; k < K; ++k) m = fmaxf(m, sharpness * s[k]);
      float sum = 0.f;
      for (int k = 0; k < K; ++k) {
        const float e = expf(sharpness * s[k] - m);
        wsel[t * kMaxK + k] = e;
        sum += e;
      }
      for (int k = 0; k < K; ++k) wsel[t * kMaxK + k] /= sum;
    }
    if (sel_out != nullptr && t < r.n) sel_out[t] = best;
  }
  __syncthreads();

  // blend, 16 bytes of T per step
  constexpr int kE = 16 / sizeof(T);
  for (int v = t; v < kT * F / kE; v += kThreads) {
    const int e0 = v * kE, row = e0 / F, col = e0 % F;
    if (row >= r.n) break;  // rows grow with v
    const uint4 xraw = *reinterpret_cast<const uint4*>(r.x + e0);
    const T* xv = reinterpret_cast<const T*>(&xraw);
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wk = wsel[row * kMaxK + k];
      if (wk == 0.f) continue;  // exact: 0 * p adds nothing
      const uint4 praw =
          *reinterpret_cast<const uint4*>(r.cand(k) + row * r.stride + col);
      const T* pv = reinterpret_cast<const T*>(&praw);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] += wk * to_f32(pv[e]);
    }
    const float s = sw[row];
    uint4 oraw;
    T* ov = reinterpret_cast<T*>(&oraw);
#pragma unroll
    for (int e = 0; e < kE; ++e)
      ov[e] = from_f32<T>(to_f32(xv[e]) * (1.f - s) + acc[e] * s);
    *reinterpret_cast<uint4*>(out + e0) = oraw;
  }
}

// ---- bf16 on the tensor cores ----

// threads of a persistent block of the mma.sync bodies (v1, the general
// instances) and of the wgmma body (kWgGroups = threads / 128 warpgroups):
// 12 warps, three on each scheduler (the mma.sync body of the shipped
// instances, measured on an H100 at F = 128: 8 warps 1.26 ms, 10 1.31, 12
// 1.17, 16 with 128 registers 1.38; the wgmma body: attention_wgmma.cuh).
// tools/torch_port_kernel_probe.py builds other sizes with
// -DRF_PROBE_ATTN_THREADS=n.
#ifndef RF_PROBE_ATTN_THREADS
#define RF_PROBE_ATTN_THREADS 384
#endif
constexpr int kMmaThreads = RF_PROBE_ATTN_THREADS;
static_assert(kMmaThreads % 32 == 0 && kMmaThreads >= 32 && kMmaThreads <= 1024, "whole warps");
constexpr int kWarps = kMmaThreads / 32;
constexpr int kSlice = 16;                   // rows per warp: one m16 tile
constexpr int kSlicesPerTile = kT / kSlice;
constexpr int kLayerWords = kH * kH / 2;     // 32-bit words of a hidden layer's fragments
constexpr int kHSteps = kH / 16;             // k16 steps of a hidden layer
constexpr int kBiases = 3 * kH + kC;
constexpr int kScoreLd = kMaxK + 1;          // a row's K scores (then weights) and its switch
static_assert(kH == 128 && kC == 32, "the fragment layouts below");

// The tensor-core body's sizes at row width F: layer 0 is F/16 k16 steps,
// whose A fragments a lane reads as F/32 16-byte runs of each of its rows.
template <int F>
struct MmaWidth : Width<F> {
  static constexpr int kSteps0 = F / 16;
  static constexpr int kL0Words = F * kH / 2;  // 32-bit words of layer 0's fragments
  static constexpr int kMlpWords = kL0Words + 2 * kLayerWords + kH * kC / 2;
  static constexpr size_t kSmemBytes = 2 * kMlpWords * sizeof(uint32_t)
                                       + 2 * kBiases * sizeof(float)
                                       + kWarps * kSlice * kScoreLd * sizeof(float);
  static_assert(kSmemBytes <= 232448, "theta and phi resident in one block's shared memory");
};

// One MLP's packed weights ((in, out) row-major per layer) -> B-fragment
// order, layer after layer. Word r of (layer, k16 step s, n8-tile pair jp,
// lane) holds W[k, k+1][n] with n = 8·(2jp + r/2) + g and, in the standard
// order, k = 16s + 8·(r&1) + 2t. Layer 0 takes the k permutation of
// `load_rows16`: k = 32·(s/2) + 8t + 4·(s&1) + 2·(r&1).
template <int F>
__device__ __forceinline__ void stage_fragments(const __nv_bfloat16* __restrict__ w,
                                                uint32_t* dst) {
  using W = MmaWidth<F>;
  for (int i = threadIdx.x; i < W::kMlpWords; i += kMmaThreads) {
    const int j = i - W::kL0Words;
    const int layer = j < 0 ? 0 : min(1 + j / kLayerWords, 3);
    const int rem = j < 0 ? i : j - (layer - 1) * kLayerWords;
    const int nout = layer == 3 ? kC : kH, pairs = nout / 16;
    const int r = rem & 3, lane = (rem >> 2) & 31, sj = rem >> 7;
    const int jp = sj % pairs, s = sj / pairs;
    const int g = lane >> 2, t = lane & 3, u = r & 1;
    const int n = 8 * (2 * jp + (r >> 1)) + g;
    const int k = layer == 0 ? 32 * (s >> 1) + 8 * t + 4 * (s & 1) + 2 * u
                             : 16 * s + 8 * u + 2 * t;
    const __nv_bfloat16* wl = w + (layer == 0 ? 0 : W::kW1 + (layer - 1) * kH * kH);
    dst[i] = rf_mma::pack_bf16(wl[k * nout + n], wl[(k + 1) * nout + n]);
  }
}

// Rows row0 + g and row0 + g + 8 of a tile (row i at src + i*stride, F
// values) as the A fragments of layer 0's F/16 k16 steps; rows at or past n
// are zero. Lane (g, t) reads the 16-byte runs at columns 32c + 8t,
// c = 0..F/32-1, of its two rows: elements 0-3 are its a0|a2 (row g) or
// a1|a3 (row g+8) of step 2c, elements 4-7 those of step 2c+1.
template <int F>
struct RowLoads {
  uint4 raw[2][F / 32];
};

template <int F>
__device__ __forceinline__ void load_rows16(const __nv_bfloat16* src, size_t stride, int row0,
                                            int n, int lane, RowLoads<F>& ld) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    const uint4* p = reinterpret_cast<const uint4*>(src + row * stride + 8 * t);
#pragma unroll
    for (int c = 0; c < F / 32; ++c)
      ld.raw[h][c] = row < n ? __ldg(p + 4 * c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// layer 0's F/16 k16 steps of A fragments, in a[0 .. F/16)
template <int F>
__device__ __forceinline__ void to_fragments(const RowLoads<F>& ld, uint32_t (&a)[kHSteps][4]) {
#pragma unroll
  for (int c = 0; c < F / 32; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[2 * c][h] = ld.raw[h][c].x;
      a[2 * c][2 + h] = ld.raw[h][c].y;
      a[2 * c + 1][h] = ld.raw[h][c].z;
      a[2 * c + 1][2 + h] = ld.raw[h][c].w;
    }
  }
}

// acc (16 rows x 8·NT columns) = a (16 x 16·STEPS) @ W, W's fragments at `w`
template <int NT, int STEPS>
__device__ __forceinline__ void layer_mma(const uint32_t (&a)[kHSteps][4], const uint4* w,
                                          int lane, float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      const uint4 b = w[(s * (NT / 2) + jp) * 32 + lane];
      rf_mma::mma_m16n8k16(acc[2 * jp], a[s], b.x, b.y);
      rf_mma::mma_m16n8k16(acc[2 * jp + 1], a[s], b.z, b.w);
    }
  }
}

// A hidden layer's epilogue: bias, LeakyReLU 0.01, round to bf16; the C
// fragments become the next layer's A fragments in `a`
__device__ __forceinline__ void hidden_to_fragments(const float (&acc)[kH / 8][4],
                                                    const float* bias, int lane,
                                                    uint32_t (&a)[kHSteps][4]) {
  const float* b = bias + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kH / 8; ++j) {
    const float2 bj = *reinterpret_cast<const float2*>(b + 8 * j);
    float v[4] = {acc[j][0] + bj.x, acc[j][1] + bj.y, acc[j][2] + bj.x, acc[j][3] + bj.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = v[e] >= 0.f ? v[e] : 0.01f * v[e];
    a[j / 2][(j & 1) * 2] = rf_mma::pack_bf16(v[0], v[1]);      // row g
    a[j / 2][(j & 1) * 2 + 1] = rf_mma::pack_bf16(v[2], v[3]);  // row g + 8
  }
}

// The 4-layer MLP on the 16 rows in `a` (layer 0's F/16 steps of fragments;
// overwritten by the hidden activations). Leaves the (16, kC) float32 result
// in out: out[j][0..1] are row g, columns 8j + 2t, +1; out[j][2..3] row g + 8.
template <int F>
__device__ __forceinline__ void mlp_mma(uint32_t (&a)[kHSteps][4], const uint32_t* w,
                                        const float* bias, int lane, float (&out)[kC / 8][4]) {
  using W = MmaWidth<F>;
  {
    float acc[kH / 8][4];
    layer_mma<kH / 8, W::kSteps0>(a, reinterpret_cast<const uint4*>(w), lane, acc);
    hidden_to_fragments(acc, bias, lane, a);
  }
#pragma unroll 1
  for (int layer = 1; layer < 3; ++layer) {
    float acc[kH / 8][4];
    layer_mma<kH / 8, kHSteps>(
        a, reinterpret_cast<const uint4*>(w + W::kL0Words + (layer - 1) * kLayerWords), lane,
        acc);
    hidden_to_fragments(acc, bias + layer * kH, lane, a);
  }
  layer_mma<kC / 8, kHSteps>(
      a, reinterpret_cast<const uint4*>(w + W::kL0Words + 2 * kLayerWords), lane, out);
  const float* b = bias + 3 * kH + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kC / 8; ++j) {
    const float2 bj = *reinterpret_cast<const float2*>(b + 8 * j);
    out[j][0] += bj.x;
    out[j][1] += bj.y;
    out[j][2] += bj.x;
    out[j][3] += bj.y;
  }
}

// max(||row||, 1e-12) of rows g (h = 0) and g + 8 (h = 1) of an MLP result
__device__ __forceinline__ float row_norm_mma(const float (&e)[kC / 8][4], int h) {
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kC / 8; ++j) {
    ss = fmaf(e[j][2 * h], e[j][2 * h], ss);
    ss = fmaf(e[j][2 * h + 1], e[j][2 * h + 1], ss);
  }
  return fmaxf(sqrtf(rf_mma::quad_sum(ss)), 1e-12f);
}

// The staged counterpart of `load_rows16`: rows row0 + g and row0 + g + 8 of a
// whole (kT, F) tile in shared memory. The quarter-warps' 16-byte loads meet
// two to a bank (rows are 2F bytes apart); at F/16 loads per ~400 mma that
// does not show.
template <int F>
__device__ __forceinline__ void staged_rows16(const __nv_bfloat16* tile, int row0, int lane,
                                              RowLoads<F>& ld) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __nv_bfloat16* p = tile + (row0 + g + 8 * h) * F + 8 * t;
#pragma unroll
    for (int c = 0; c < F / 32; ++c) ld.raw[h][c] = rf_mma::load_shared16(p + 32 * c);
  }
}

// an MLP result of rows g and g + 8, scaled to unit length in place
__device__ __forceinline__ void normalise_mma(float (&e)[kC / 8][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float d = row_norm_mma(e, h);
#pragma unroll
    for (int j = 0; j < kC / 8; ++j) {
      e[j][2 * h] /= d;
      e[j][2 * h + 1] /= d;
    }
  }
}

// scores[row][k] = xf . l2norm(emb) for the warp's rows g and g + 8; xf is
// the rows' normalised theta embedding, emb candidate k's MLP result; a row's
// scores are LD floats apart
template <int LD = kScoreLd>
__device__ __forceinline__ void score_mma(const float (&xf)[kC / 8][4],
                                          const float (&emb)[kC / 8][4], float* scores, int k,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float d = row_norm_mma(emb, h);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kC / 8; ++j) {
      s = fmaf(xf[j][2 * h], emb[j][2 * h] / d, s);
      s = fmaf(xf[j][2 * h + 1], emb[j][2 * h + 1] / d, s);
    }
    s = rf_mma::quad_sum(s);
    if (t == 0) scores[(g + 8 * h) * LD + k] = s;
  }
}

// Lane i selects for row row0 + i of a tile with n valid rows: its K scores
// (row i's LD floats: K < LD scores, the last its switch) become its blend
// weights and scores[i][LD - 1] its switch; its argmax candidate goes to
// sel_out[row0 + i] if sel_out is not null. The warp's scores must be
// visible (__syncwarp) before, and its weights after.
template <bool kHard, int LD = kScoreLd>
__device__ __forceinline__ void select_mma(float* scores, int K, float sharpness, int lane,
                                           int row0, int n, int* __restrict__ sel_out) {
  if (lane < kSlice) {
    float* s = scores + lane * LD;
    float mx = s[0];
    int best = 0;
    for (int k = 1; k < K; ++k) {
      mx = fmaxf(mx, s[k]);
      if (s[k] * 25.f > s[best] * 25.f) best = k;  // first maximum wins
    }
    if (kHard) {
      for (int k = 0; k < K; ++k) s[k] = k == best ? 1.f : 0.f;
    } else {
      float top = sharpness * s[0];
      for (int k = 1; k < K; ++k) top = fmaxf(top, sharpness * s[k]);
      float sum = 0.f;
      for (int k = 0; k < K; ++k) {
        const float e = expf(sharpness * s[k] - top);
        s[k] = e;
        sum += e;
      }
      for (int k = 0; k < K; ++k) s[k] /= sum;
    }
    s[LD - 1] = fmaxf(mx, 0.f);
    if (sel_out != nullptr && row0 + lane < n) sel_out[row0 + lane] = best;
  }
}

// out = x (1 - switch) + (sum_k w_k p_k) switch for rows [row0, row0 + 16) of
// the tile of row source `r`, by one warp, from the original rows (F values)
// in global memory and the weights `select_mma` left. A lane takes 16-byte
// runs of bf16, kBatch runs a round trip: with kHard (one weight is 1, the
// others 0) x's run and the selected candidate's together, else x's, then
// one load a candidate. On an H100 (700 W) at F = 128, Q = 8192, K = 4,
// batching took the wgmma body from 0.785-0.799 ms to 0.719-0.739 (PERF.md).
template <int F, bool kHard = false, typename Rows>
__device__ __forceinline__ void blend_mma(const Rows& r, int row0, const float* scores, int lane,
                                          __nv_bfloat16* __restrict__ out) {
  using T = __nv_bfloat16;
  constexpr int kE = 8, kRowRuns = F / kE, kRuns = kSlice * kRowRuns / 32;
  constexpr int kBatch = kRuns % 4 == 0 ? 4 : kRuns % 3 == 0 ? 3 : kRuns;
  static_assert(kSlice * kRowRuns % 32 == 0 && kRuns % kBatch == 0, "whole runs a lane");
  const int K = r.K;
#pragma unroll
  for (int i0 = 0; i0 < kRuns; i0 += kBatch) {
    int row[kBatch], col[kBatch];
    const float* ws[kBatch];
    uint4 xr[kBatch];
    float acc[kBatch][kE];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int v = lane + 32 * (i0 + i);
      row[i] = row0 + v / kRowRuns;
      col[i] = v % kRowRuns * kE;
      ws[i] = scores + (v / kRowRuns) * kScoreLd;
      xr[i] = row[i] < r.n ? __ldg(reinterpret_cast<const uint4*>(r.x + row[i] * F + col[i]))
                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[i][e] = 0.f;
    }
    if constexpr (kHard) {
      uint4 pr[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        int best = 0;
        for (int k = 1; k < K; ++k)
          if (ws[i][k] != 0.f) best = k;
        pr[i] = row[i] < r.n ? __ldg(reinterpret_cast<const uint4*>(
                                   r.cand(best) + row[i] * r.stride + col[i]))
                             : make_uint4(0u, 0u, 0u, 0u);
        const T* pv = reinterpret_cast<const T*>(&pr[i]);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[i][e] += ws[i][best] * to_f32(pv[e]);
      }
    } else {
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const float wk = ws[i][k];
          if (wk == 0.f || row[i] >= r.n) continue;  // exact: 0 * p adds nothing
          const uint4 praw = __ldg(reinterpret_cast<const uint4*>(
              r.cand(k) + row[i] * r.stride + col[i]));
          const T* pv = reinterpret_cast<const T*>(&praw);
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[i][e] += wk * to_f32(pv[e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (row[i] >= r.n) continue;
      const float sw = ws[i][kMaxK];
      const T* xv = reinterpret_cast<const T*>(&xr[i]);
      uint4 oraw;
      T* ov = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int e = 0; e < kE; ++e)
        ov[e] = from_f32<T>(to_f32(xv[e]) * (1.f - sw) + acc[i][e] * sw);
      *reinterpret_cast<uint4*>(out + row[i] * F + col[i]) = oraw;
    }
  }
}

// the current device's SMs; 0 if the device cannot be asked
inline int sm_count(cudaError_t* err) {
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return *err == cudaSuccess ? sms : 0;
}

struct NoWait {
  __device__ void operator()() const {}
};

// A kernel's launch: raise the dynamic shared-memory limit to `smem`, launch
// `blocks` blocks of `threads` on `stream`, return the cudaError_t as an int.
template <typename Kernel, typename... Args>
int launch_blocks(Kernel kernel, int blocks, int threads, size_t smem, cudaStream_t stream,
                  Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rf_attention

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
