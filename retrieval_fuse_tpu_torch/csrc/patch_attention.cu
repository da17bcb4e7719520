// K-way patch attention over pre-gathered candidate rows.
//
// Replaces the Pallas kernel `_attention_kernel` / `pallas_patch_attention`
// of retrieval_fuse_tpu/ops/pallas_attention.py:46 and :87 (the serving
// engine's `pallas`, `pallasp` and `flatg` tokens). Python side:
// ops/patch_attention.py. The same MLP, score, switch, select and blend as
// gathered_attention.cu (the bodies of attention.cuh and
// attention_wgmma.cuh); only the source of the candidate rows differs:
// candidate k of row i is p[i, k, :], so a tile's candidate-k rows lie
// K*F elements apart.
//
// Rows are F = nf·e³ values. The shipped widths (32, 64, 96 or 128,
// attention.cuh's `with_width`) at K <= 8 run the instances below;
// any other F in 1..1024 and K in 1..32 runs the general instance of
// attention_general.cuh, in tiles of 64 rows (float32) or slices of 16
// (bf16) of the row array. The wrapper chooses, by shape.
//
// A tile is 64 consecutive rows of x; N need not be a multiple of 64: the
// last tile's missing rows are zero in the MLPs and never written. The TPU
// version's padding of N to 512-row tiles is not carried over.
//
// bf16 runs attention_wgmma.cuh's body as a persistent launch (one block per
// SM with theta's and phi's shared-memory images resident, each warpgroup
// walking over 64-row tiles on wgmma); float32 keeps the float32-FMA body,
// one block per tile.
//
// Bound on the H100 at `pallasp` batch 128 (N = 524,288 rows, K=4, bf16):
// N (1 + K) rows x 106,496 MLP flops = 279 GFLOP, 0.282 ms at the
// 989 TFLOP/s bf16 tensor-core rate; x, p and out are 805 MB, ~0.24 ms at
// 3.35 TB/s. Measured on an H100 (700 W), bf16, F = 128, K = 4: 0.716-0.731
// ms (the mma.sync body 1.10-1.11), 2.5-2.6x the bound; attention_wgmma.cuh
// says what holds it, PERF.md has the readings.

#include <type_traits>

#include "attention_general.cuh"
#include "attention_wgmma.cuh"

namespace {

using namespace rf_attention;

template <typename T, int F, bool kHard>
__global__ void __launch_bounds__(kThreads, 2)
patch_attention(const T* __restrict__ x, const T* __restrict__ p, int n, int K,
                const T* __restrict__ w_theta, const float* __restrict__ b_theta,
                const T* __restrict__ w_phi, const float* __restrict__ b_phi,
                float sharpness, T* __restrict__ out, int* __restrict__ sel_out) {
  extern __shared__ __align__(16) float smem[];
  const size_t r0 = static_cast<size_t>(blockIdx.x) * kT;
  const size_t stride = static_cast<size_t>(K) * F;
  const StridedRows<T> r{x + r0 * F, p + r0 * stride, F, stride,
                         min(kT, static_cast<int>(n - r0)), K};
  attend_tile<T, F, kHard>(r, smem, w_theta, b_theta, w_phi, b_phi, sharpness, out + r0 * F,
                           sel_out == nullptr ? nullptr : sel_out + r0, NoWait{});
}

template <int F, bool kHard>
__global__ void __launch_bounds__(kWgThreads, 1)
patch_attention_wgmma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ p,
                      int n, int K, const __nv_bfloat16* __restrict__ img_theta,
                      const __nv_bfloat16* __restrict__ img_phi, float sharpness,
                      __nv_bfloat16* __restrict__ out, int* __restrict__ sel_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t stride = static_cast<size_t>(K) * F;
  auto tile_rows = [=](size_t q) {
    const size_t r0 = q * kT;
    return StridedRows<__nv_bfloat16>{x + r0 * F, p + r0 * stride, F, stride,
                                      min(kT, static_cast<int>(n - r0)), K};
  };
  attend_tiles_wgmma<F, kHard>(tile_rows, (n + kT - 1) / kT, smem_raw, img_theta, img_phi,
                               sharpness, out, sel_out);
}

template <typename T, int F, bool kHard>
int launch(const void* x, const void* p, int n, int k, const void* w_theta,
           const float* b_theta, const void* w_phi, const float* b_phi, float sharpness,
           void* out, int* sel, cudaStream_t s) {
  const int tiles = (n + kT - 1) / kT;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    cudaError_t err;
    const int blocks = wgmma_blocks(tiles, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_blocks(patch_attention_wgmma<F, kHard>, blocks, kWgThreads,
                         WgImage<F>::kSmemBytes, s, static_cast<const T*>(x),
                         static_cast<const T*>(p), n, k, static_cast<const T*>(w_theta),
                         static_cast<const T*>(w_phi), sharpness, static_cast<T*>(out), sel);
  } else {
    return launch_blocks(patch_attention<T, F, kHard>, tiles, kThreads, kSmemBytes, s,
                         static_cast<const T*>(x), static_cast<const T*>(p), n, k,
                         static_cast<const T*>(w_theta), b_theta,
                         static_cast<const T*>(w_phi), b_phi, sharpness, static_cast<T*>(out),
                         sel);
  }
}

// ---- the general instance (attention_general.cuh): any F, K ----

template <bool kHard>
__global__ void __launch_bounds__(kThreads, 2)
patch_attention_general(const float* __restrict__ x, const float* __restrict__ p, int n, int K,
                        int F, const float* __restrict__ w_theta,
                        const float* __restrict__ b_theta, const float* __restrict__ w_phi,
                        const float* __restrict__ b_phi, float sharpness,
                        float* __restrict__ out, int* __restrict__ sel_out) {
  extern __shared__ __align__(16) float smem[];
  const auto r = PatchSlices<float, kT>{x, p, n, K, F}(blockIdx.x);
  attend_tile_general<float, kHard, false>(r, F, smem, w_theta, b_theta, w_phi, b_phi,
                                           sharpness, out + r.row0 * F,
                                           sel_out == nullptr ? nullptr : sel_out + r.row0);
}

template <bool kHard>
__global__ void __launch_bounds__(kMmaThreads, 1)
patch_attention_general_mma(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ p, int n, int K, int F,
                            const __nv_bfloat16* __restrict__ w_theta,
                            const float* __restrict__ b_theta,
                            const __nv_bfloat16* __restrict__ w_phi,
                            const float* __restrict__ b_phi, float sharpness,
                            __nv_bfloat16* __restrict__ out, int* __restrict__ sel_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attend_slices_general<kHard, false>(PatchSlices<__nv_bfloat16, kSlice>{x, p, n, K, F}, F,
                                      smem_raw, w_theta, b_theta, w_phi, b_phi, sharpness, out,
                                      sel_out);
}

template <bool kHard>
int launch_general(int dtype, const void* x, const void* p, int n, int k, int f,
                   const void* w_theta, const float* b_theta, const void* w_phi,
                   const float* b_phi, float sharpness, void* out, int* sel, cudaStream_t s) {
  if (dtype == 0) {
    const long long tiles = PatchSlices<float, kT>{nullptr, nullptr, n, k, f}.count();
    return launch_blocks(patch_attention_general<kHard>, static_cast<int>(tiles), kThreads,
                         kGSmemBytes, s, static_cast<const float*>(x),
                         static_cast<const float*>(p), n, k, f,
                         static_cast<const float*>(w_theta), b_theta,
                         static_cast<const float*>(w_phi), b_phi, sharpness,
                         static_cast<float*>(out), sel);
  }
  using T = __nv_bfloat16;
  cudaError_t err;
  const int blocks =
      general_blocks(PatchSlices<T, kSlice>{nullptr, nullptr, n, k, f}.count(), &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_blocks(patch_attention_general_mma<kHard>, blocks, kMmaThreads,
                       general_mma_smem<false>(), s, static_cast<const T*>(x),
                       static_cast<const T*>(p), n, k, f, static_cast<const T*>(w_theta),
                       b_theta, static_cast<const T*>(w_phi), b_phi, sharpness,
                       static_cast<T*>(out), sel);
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (x, p, out, packed weights).
// x (n, f), p (n, k, f), b_* (128*3 + 32) float32; sel (n,) int32 or null
// (argmax candidate of each row); n >= 1; x, p and out 16-byte aligned.
// general 0, the shipped instances: f in {32, 64, 96, 128}, 1 <= k <= 8;
// float32: w_* packed (f*128 + 128*128*2 + 128*32) in (in, out) layout;
// bfloat16: w_* each MLP's shared-memory image (attention_wgmma.cuh's
// WgImage<f>, its biases inside; 16-byte aligned) and b_* unused. general 1
// (attention_general.cuh): 1 <= f <= 1024, 1 <= k <= 32, w_* packed at
// fp = f rounded up to 32 (fc0's rows past f zero): fc0 in (in, out) layout
// for float32, in B-fragment order for bfloat16, then fc1, fc2, out in
// (in, out) layout. bfloat16 runs the tensor-core bodies, float32 the FMA
// bodies. Returns a cudaError_t value.
extern "C" int rf_patch_attention(int dtype, const void* x, const void* p, int n, int k, int f,
                                  int general, const void* w_theta, const float* b_theta,
                                  const void* w_phi, const float* b_phi, int hard,
                                  float sharpness, void* out, int* sel,
                                  cudaStream_t stream) {
  if (n < 1 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (general) {
    if (k < 1 || k > kGMaxK || f < 1 || f > kGMaxF) return static_cast<int>(cudaErrorInvalidValue);
    return hard ? launch_general<true>(dtype, x, p, n, k, f, w_theta, b_theta, w_phi, b_phi,
                                       sharpness, out, sel, stream)
                : launch_general<false>(dtype, x, p, n, k, f, w_theta, b_theta, w_phi, b_phi,
                                        sharpness, out, sel, stream);
  }
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  return with_width(f, [&](auto width) {
    constexpr int F = decltype(width)::value;
    if (dtype == 0)
      return hard ? launch<float, F, true>(x, p, n, k, w_theta, b_theta, w_phi, b_phi,
                                           sharpness, out, sel, stream)
                  : launch<float, F, false>(x, p, n, k, w_theta, b_theta, w_phi, b_phi,
                                            sharpness, out, sel, stream);
    return hard ? launch<__nv_bfloat16, F, true>(x, p, n, k, w_theta, b_theta, w_phi, b_phi,
                                                 sharpness, out, sel, stream)
                : launch<__nv_bfloat16, F, false>(x, p, n, k, w_theta, b_theta, w_phi,
                                                  b_phi, sharpness, out, sel, stream);
  });
}
