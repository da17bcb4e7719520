// Fused gather + K-way patch attention over tile-major rows.
//
// Replaces the Pallas kernel `_gathered_kernel_v2` /
// `pallas_gathered_patch_attention_v2` of
// retrieval_fuse_tpu/ops/pallas_attention.py:249 and :327 (the serving
// engine's `pallasg2` token). Python side: ops/patch_attention.py. The
// attention body is attention.cuh's; this kernel's rows are tile q of xt
// and, for each of its K retrieved bank rows idx[q, k], that (T, F) bank
// tile, read from global memory. No (Q, K, T, F) tensor exists. Rows are
// F = nf·e³ values, F one of attention.cuh's `with_width` (32, 64, 96 or
// 128; the entry point takes f and dispatches).
//
// bf16 runs attention_wgmma.cuh's body as a persistent launch (one block per
// SM with theta's and phi's shared-memory images resident, each warpgroup
// walking over 64-row tiles on wgmma, reading candidate k+1's bank rows by
// index while candidate k's MLP runs); float32 keeps the float32-FMA body,
// one block per tile, two blocks on an SM (97 KB of shared memory each).
//
// Bound on the H100: at Q=8192 (batch 128) the MLPs are (Q T + Q K T) rows
// x 106,496 flops = 279 GFLOP, 0.282 ms at the 989 TFLOP/s bf16 tensor-core
// rate; the ~0.8 GB of bf16 rows it must move (x, the gathered candidates,
// out) take ~0.24 ms at 3.35 TB/s. Measured on an H100 (700 W), bf16, F =
// 128, K = 4: 0.710-0.739 ms (the mma.sync body 1.14-1.15), 2.5-2.6x the
// bound; attention_wgmma.cuh says what holds it, PERF.md has the readings.
//
// The TPU version's workarounds are not carried over: the flattened 1-D
// index operand (SMEM lane padding), the GROUP-tile grid steps (grid
// overhead) and the padding of Q to a GROUP multiple; a tile's K indices are
// read where it is computed, and any Q works.

#include <type_traits>

#include "attention_general.cuh"
#include "attention_wgmma.cuh"

namespace {

using namespace rf_attention;

template <typename T, int F, bool kHard>
__global__ void __launch_bounds__(kThreads, 2)
gathered_attention(const T* __restrict__ xt, const T* __restrict__ bank,
                   const int* __restrict__ idx, int K,
                   const T* __restrict__ w_theta, const float* __restrict__ b_theta,
                   const T* __restrict__ w_phi, const float* __restrict__ b_phi,
                   float sharpness, T* __restrict__ out, int* __restrict__ sel_out) {
  extern __shared__ __align__(16) float smem[];
  const size_t q = blockIdx.x;
  const BankRows<T, F> r{xt + q * kT * F, bank, idx + q * K, kT, K};
  attend_tile<T, F, kHard>(r, smem, w_theta, b_theta, w_phi, b_phi, sharpness,
                           out + q * kT * F, sel_out == nullptr ? nullptr : sel_out + q * kT,
                           NoWait{});
}

template <int F, bool kHard>
__global__ void __launch_bounds__(kWgThreads, 1)
gathered_attention_wgmma(const __nv_bfloat16* __restrict__ xt,
                         const __nv_bfloat16* __restrict__ bank, const int* __restrict__ idx,
                         int Q, int K, const __nv_bfloat16* __restrict__ img_theta,
                         const __nv_bfloat16* __restrict__ img_phi, float sharpness,
                         __nv_bfloat16* __restrict__ out, int* __restrict__ sel_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto tile_rows = [=](size_t q) {
    return BankRows<__nv_bfloat16, F>{xt + q * kT * F, bank, idx + q * K, kT, K};
  };
  attend_tiles_wgmma<F, kHard>(tile_rows, Q, smem_raw, img_theta, img_phi, sharpness, out,
                               sel_out);
}

template <typename T, int F, bool kHard>
int launch(const void* xt, const void* bank, const int* idx, int q, int k,
           const void* w_theta, const float* b_theta, const void* w_phi,
           const float* b_phi, float sharpness, void* out, int* sel, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    cudaError_t err;
    const int blocks = wgmma_blocks(q, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_blocks(gathered_attention_wgmma<F, kHard>, blocks, kWgThreads,
                         WgImage<F>::kSmemBytes, s, static_cast<const T*>(xt),
                         static_cast<const T*>(bank), idx, q, k,
                         static_cast<const T*>(w_theta), static_cast<const T*>(w_phi),
                         sharpness, static_cast<T*>(out), sel);
  } else {
    return launch_blocks(gathered_attention<T, F, kHard>, q, kThreads, kSmemBytes, s,
                         static_cast<const T*>(xt), static_cast<const T*>(bank), idx, k,
                         static_cast<const T*>(w_theta), b_theta,
                         static_cast<const T*>(w_phi), b_phi, sharpness, static_cast<T*>(out),
                         sel);
  }
}

// ---- the general instance (attention_general.cuh): any F, K, T ----

template <bool kHard>
__global__ void __launch_bounds__(kThreads, 2)
gathered_attention_general(const float* __restrict__ xt, const float* __restrict__ bank,
                           const int* __restrict__ idx, int Q, int T, int K, int F,
                           const float* __restrict__ w_theta, const float* __restrict__ b_theta,
                           const float* __restrict__ w_phi, const float* __restrict__ b_phi,
                           float sharpness, float* __restrict__ out, int* __restrict__ sel_out) {
  extern __shared__ __align__(16) float smem[];
  const auto r = BankSlices<float, kT>{xt, bank, idx, Q, T, K, F}(blockIdx.x);
  attend_tile_general<float, kHard, false>(r, F, smem, w_theta, b_theta, w_phi, b_phi,
                                           sharpness, out + r.row0 * F,
                                           sel_out == nullptr ? nullptr : sel_out + r.row0);
}

template <bool kHard>
__global__ void __launch_bounds__(kMmaThreads, 1)
gathered_attention_general_mma(const __nv_bfloat16* __restrict__ xt,
                               const __nv_bfloat16* __restrict__ bank,
                               const int* __restrict__ idx, int Q, int T, int K, int F,
                               const __nv_bfloat16* __restrict__ w_theta,
                               const float* __restrict__ b_theta,
                               const __nv_bfloat16* __restrict__ w_phi,
                               const float* __restrict__ b_phi, float sharpness,
                               __nv_bfloat16* __restrict__ out, int* __restrict__ sel_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attend_slices_general<kHard, false>(BankSlices<__nv_bfloat16, kSlice>{xt, bank, idx, Q, T, K, F},
                                      F, smem_raw, w_theta, b_theta, w_phi, b_phi, sharpness,
                                      out, sel_out);
}

template <bool kHard>
int launch_general(int dtype, const void* xt, const void* bank, const int* idx, int q, int k,
                   int f, int t, const void* w_theta, const float* b_theta, const void* w_phi,
                   const float* b_phi, float sharpness, void* out, int* sel, cudaStream_t s) {
  if (dtype == 0) {
    const long long tiles = BankSlices<float, kT>{nullptr, nullptr, nullptr, q, t, k, f}.count();
    return launch_blocks(gathered_attention_general<kHard>, static_cast<int>(tiles), kThreads,
                         kGSmemBytes, s, static_cast<const float*>(xt),
                         static_cast<const float*>(bank), idx, q, t, k, f,
                         static_cast<const float*>(w_theta), b_theta,
                         static_cast<const float*>(w_phi), b_phi, sharpness,
                         static_cast<float*>(out), sel);
  }
  using T = __nv_bfloat16;
  cudaError_t err;
  const int blocks = general_blocks(
      BankSlices<T, kSlice>{nullptr, nullptr, nullptr, q, t, k, f}.count(), &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_blocks(gathered_attention_general_mma<kHard>, blocks, kMmaThreads,
                       general_mma_smem<false>(), s, static_cast<const T*>(xt),
                       static_cast<const T*>(bank), idx, q, t, k, f,
                       static_cast<const T*>(w_theta), b_theta, static_cast<const T*>(w_phi),
                       b_phi, sharpness, static_cast<T*>(out), sel);
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (xt, bank, out, packed weights).
// xt (q, t, f), bank (n, t, f), idx (q, k) int32 in [0, n), b_* (128*3 +
// 32) float32; sel (q, t) int32 or null (argmax candidate of each row);
// q >= 1; xt, bank and out 16-byte aligned. general 0, the shipped
// instances: f in {32, 64, 96, 128}, t = 64, 1 <= k <= 8; float32: w_*
// packed (f*128 + 128*128*2 + 128*32) in (in, out) layout; bfloat16: w_*
// each MLP's shared-memory image (attention_wgmma.cuh's WgImage<f>, its
// biases inside; 16-byte aligned) and b_* unused. general 1
// (attention_general.cuh): 1 <= f <= 1024, 1 <= t <= 512, 1 <= k <= 32, w_*
// packed as rf_patch_attention's general operands. bfloat16 runs the
// tensor-core bodies, float32 the FMA bodies. Returns a cudaError_t value.
extern "C" int rf_gathered_attention(int dtype, const void* xt, const void* bank,
                                     const int* idx, int q, int k, int f, int t, int general,
                                     const void* w_theta, const float* b_theta,
                                     const void* w_phi, const float* b_phi, int hard,
                                     float sharpness, void* out, int* sel,
                                     cudaStream_t stream) {
  if (q < 1 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (general) {
    if (k < 1 || k > kGMaxK || f < 1 || f > kGMaxF || t < 1 || t > kGMaxT)
      return static_cast<int>(cudaErrorInvalidValue);
    return hard ? launch_general<true>(dtype, xt, bank, idx, q, k, f, t, w_theta, b_theta,
                                       w_phi, b_phi, sharpness, out, sel, stream)
                : launch_general<false>(dtype, xt, bank, idx, q, k, f, t, w_theta, b_theta,
                                        w_phi, b_phi, sharpness, out, sel, stream);
  }
  if (k < 1 || k > kMaxK || t != kT) return static_cast<int>(cudaErrorInvalidValue);
  return with_width(f, [&](auto width) {
    constexpr int F = decltype(width)::value;
    if (dtype == 0)
      return hard ? launch<float, F, true>(xt, bank, idx, q, k, w_theta, b_theta, w_phi,
                                           b_phi, sharpness, out, sel, stream)
                  : launch<float, F, false>(xt, bank, idx, q, k, w_theta, b_theta, w_phi,
                                            b_phi, sharpness, out, sel, stream);
    return hard ? launch<__nv_bfloat16, F, true>(xt, bank, idx, q, k, w_theta, b_theta,
                                                 w_phi, b_phi, sharpness, out, sel, stream)
                : launch<__nv_bfloat16, F, false>(xt, bank, idx, q, k, w_theta, b_theta,
                                                  w_phi, b_phi, sharpness, out, sel, stream);
  });
}
