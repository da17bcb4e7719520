// K-way patch attention over one tile of up to 64 rows: the body shared by
// the three attention kernels (gathered_attention.cu, gathered_attention_v1.cu,
// patch_attention.cu). They differ only in where a tile's rows come from,
// which each kernel describes by a row source (StridedRows or BankRows)
// before it calls `attend_tile`.
//
// For each row r (F=128 features) and each of its K candidate rows p_k:
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
// Design: one block of 256 threads per tile. The tile's rows are brought
// into a shared-memory activation buffer (float32), and each MLP layer is a
// shared-memory-tiled GEMM: 32-row chunks of the weight matrix (read from
// global memory, where the 213 KB of theta + phi weights stay L2-resident)
// are staged in shared memory and every thread accumulates a 4x8 (or 1x8)
// register tile with float32 FMAs. theta runs once, then phi once per
// candidate, each reusing the same two 33 KB activation buffers; only the
// scores stay. The blend re-reads x and the selected candidates from where
// they came from. Rows past the tile's valid count are zero in the
// activations and are never written.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace rf_attention {

constexpr int kT = 64;       // rows per tile
constexpr int kF = 128;      // features per row (nf * e^3)
constexpr int kH = 128;      // MLP hidden width
constexpr int kC = 32;       // embedding width (cf_feat)
constexpr int kMaxK = 8;
constexpr int kThreads = 256;
constexpr int kLd = kF + 4;  // padded activation row, in floats
constexpr int kKc = 32;      // weight rows per staged chunk
static_assert(kF == kH, "layer 0 reuses the hidden-layer GEMM");

// per-MLP packed weights: fc0 (F, H), fc1 (H, H), fc2 (H, H), out (H, C),
// each (in, out) row-major; packed biases: fc0, fc1, fc2 (H each), out (C)
constexpr int kW1 = kF * kH, kW2 = kW1 + kH * kH, kW3 = kW2 + kH * kH;

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

// Where a tile's rows are, as a row source: x row i at x + i*kF; candidate
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

// candidate k is the (kT, kF) bank tile idx[k]
template <typename T>
struct BankRows {
  const T* x;
  const T* bank;
  const int* idx;
  int n;
  int K;
  static constexpr size_t stride = kF;
  __device__ __forceinline__ const T* cand(int k) const {
    return bank + static_cast<size_t>(idx[k]) * kT * kF;
  }
};

// rows [0, n) of a tile whose row i starts at src + i*stride -> act[i*kLd + c]
// as float32; rows [n, kT) are zero
template <typename T>
__device__ __forceinline__ void load_rows(const T* src, size_t stride, int n, float* act) {
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte load
  for (int v = threadIdx.x; v < kT * kF / kE; v += kThreads) {
    const int e0 = v * kE, row = e0 / kF, col = e0 % kF;
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

// out[:, :NOUT] = act(in[:, :128] @ W + b), W (128, NOUT) of type T in
// global memory. `hidden`: LeakyReLU 0.01, then round to T.
template <typename T, int NOUT>
__device__ __forceinline__ void dense(const float* in, float* out, const T* __restrict__ w,
                                      const float* __restrict__ bias, float* wbuf,
                                      bool hidden) {
  constexpr int kCg = NOUT / 8;             // column groups
  constexpr int kRm = kT * kCg / kThreads;  // rows per thread
  static_assert(kRm >= 1 && kT * kCg % kThreads == 0, "tile mapping");
  const int tx = threadIdx.x % kCg, ty = threadIdx.x / kCg;
  // a thread's 8 columns: 4 at tx*4 and 4 at NOUT/2 + tx*4, so 16
  // neighbouring threads read 256 contiguous bytes of the weight chunk
  const int c0 = tx * 4, c1 = NOUT / 2 + tx * 4;
  float acc[kRm][8];
#pragma unroll
  for (int r = 0; r < kRm; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < kH; k0 += kKc) {
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

// the 4-layer MLP on the rows in act0; leaves the (kT, kC) result in act0
template <typename T>
__device__ __forceinline__ void mlp(float* act0, float* act1, const T* __restrict__ w,
                                    const float* __restrict__ b, float* wbuf) {
  dense<T, kH>(act0, act1, w, b, wbuf, true);
  dense<T, kH>(act1, act0, w + kW1, b + kH, wbuf, true);
  dense<T, kH>(act0, act1, w + kW2, b + 2 * kH, wbuf, true);
  dense<T, kC>(act1, act0, w + kW3, b + 3 * kH, wbuf, false);
  __syncthreads();
}

// max(||row||, 1e-12) over the first kC values of an activation row
__device__ __forceinline__ float row_norm(const float* row) {
  float ss = 0.f;
#pragma unroll 8
  for (int c = 0; c < kC; ++c) ss = fmaf(row[c], row[c], ss);
  return fmaxf(sqrtf(ss), 1e-12f);
}

// Attention over the tile of row source `r`; writes its valid rows to out
// (rows kF apart) and, if sel_out is not null, each row's argmax candidate
// to sel_out[i]. `before_phi` runs once after theta, before the first
// candidate is read (a kernel that stages candidates waits there).
template <typename T, bool kHard, typename Rows, typename BeforePhi>
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

  load_rows(r.x, kF, r.n, act0);
  mlp(act0, act1, w_theta, b_theta, wbuf);
  if (t < kT) {
    const float* row = act0 + t * kLd;
    const float d = row_norm(row);
#pragma unroll 8
    for (int c = 0; c < kC; ++c) xf[t * (kC + 1) + c] = row[c] / d;
  }
  before_phi();

  for (int k = 0; k < K; ++k) {
    __syncthreads();  // act0 free again; staged candidates visible
    load_rows(r.cand(k), r.stride, r.n, act0);
    mlp(act0, act1, w_phi, b_phi, wbuf);
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
  for (int v = t; v < kT * kF / kE; v += kThreads) {
    const int e0 = v * kE, row = e0 / kF, col = e0 % kF;
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

struct NoWait {
  __device__ void operator()() const {}
};

// A kernel's launch: raise the dynamic shared-memory limit to `smem`, launch
// q blocks of kThreads on `stream`, return the cudaError_t as an int.
template <typename Kernel, typename... Args>
int launch_blocks(Kernel kernel, int blocks, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rf_attention

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
