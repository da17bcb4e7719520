// Fused gather + K-way patch attention, one tile per block with all K
// candidate tiles staged in shared memory.
//
// Replaces the Pallas kernel `_gathered_kernel` /
// `pallas_gathered_patch_attention` of
// retrieval_fuse_tpu/ops/pallas_attention.py:151 and :188 (the serving
// engine's `pallasg` token), v1 of gathered_attention.cu's kernel: the same
// function, and what sets it apart is its structure. Each Pallas grid step
// held all K index-mapped candidate blocks of its tile before it computed;
// here each block copies its tile's K candidate (T, F) bank tiles into
// shared memory up front with cp.async, runs theta on x while the copies
// are in flight, waits, and then phi and the blend read the candidates from
// shared memory instead of global memory. Python side:
// ops/patch_attention.py; the attention body is attention.cuh's.
//
// Shared memory: attention.cuh's 96,768 bytes plus K * 64 * 128 elements of
// staging: 64 KB in bf16 at K=4 (161 KB in all), 128 KB in float32 at K=4
// (227,840 bytes, under the 232,448 a block can have). So K <= 8 in bf16
// and K <= 4 in float32; the wrapper raises beyond. One block per SM.
//
// Bound on the H100: as gathered_attention.cu, 0.282 ms at Q=8192, K=4,
// bf16 (279 GFLOP of MLP GEMMs at 989 TFLOP/s). This kernel keeps
// attention.cuh's float32-FMA body in both types: its staged candidate
// tiles cannot share an SM with the 213 KB of weights that the tensor-core
// body keeps resident.

#include "attention.cuh"

namespace {

using namespace rf_attention;

constexpr size_t kMaxSmemBytes = 232448;  // per block on sm_90

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

struct WaitStaged {  // this thread's copies have landed; the caller's barrier publishes them
  __device__ void operator()() const {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  }
};

template <typename T, bool kHard>
__global__ void __launch_bounds__(kThreads, 1)
gathered_attention_v1(const T* __restrict__ xt, const T* __restrict__ bank,
                      const int* __restrict__ idx, int K,
                      const T* __restrict__ w_theta, const float* __restrict__ b_theta,
                      const T* __restrict__ w_phi, const float* __restrict__ b_phi,
                      float sharpness, T* __restrict__ out, int* __restrict__ sel_out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kE = 16 / sizeof(T);
  T* stage = reinterpret_cast<T*>(smem + kSmemFloats);
  const size_t q = blockIdx.x;
  for (int k = 0; k < K; ++k) {
    const T* src = bank + static_cast<size_t>(idx[q * K + k]) * kT * kF;
    T* dst = stage + k * kT * kF;
    for (int v = threadIdx.x; v < kT * kF / kE; v += kThreads)
      cp_async16(dst + v * kE, src + v * kE);
  }
  const StridedRows<T> r{xt + q * kT * kF, stage, static_cast<size_t>(kT) * kF, kF, kT, K};
  attend_tile<T, kHard>(r, smem, w_theta, b_theta, w_phi, b_phi, sharpness, out + q * kT * kF,
                        sel_out == nullptr ? nullptr : sel_out + q * kT, WaitStaged{});
}

template <typename T, bool kHard>
int launch(const void* xt, const void* bank, const int* idx, int q, int k,
           const void* w_theta, const float* b_theta, const void* w_phi,
           const float* b_phi, float sharpness, void* out, int* sel, cudaStream_t s) {
  const size_t smem = kSmemBytes + static_cast<size_t>(k) * kT * kF * sizeof(T);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  return launch_blocks(gathered_attention_v1<T, kHard>, q, kThreads, smem, s,
                       static_cast<const T*>(xt), static_cast<const T*>(bank), idx, k,
                       static_cast<const T*>(w_theta), b_theta,
                       static_cast<const T*>(w_phi), b_phi, sharpness, static_cast<T*>(out),
                       sel);
}

}  // namespace

// The operands of rf_gathered_attention (gathered_attention.cu); in
// addition k * 64 * 128 * sizeof(element) must fit the staging budget
// (k <= 4 in float32, k <= 8 in bfloat16). Returns a cudaError_t value.
extern "C" int rf_gathered_attention_v1(int dtype, const void* xt, const void* bank,
                                        const int* idx, int q, int k, const void* w_theta,
                                        const float* b_theta, const void* w_phi,
                                        const float* b_phi, int hard, float sharpness,
                                        void* out, int* sel, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || q < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return hard ? launch<float, true>(xt, bank, idx, q, k, w_theta, b_theta, w_phi, b_phi,
                                      sharpness, out, sel, stream)
                : launch<float, false>(xt, bank, idx, q, k, w_theta, b_theta, w_phi,
                                       b_phi, sharpness, out, sel, stream);
  return hard ? launch<__nv_bfloat16, true>(xt, bank, idx, q, k, w_theta, b_theta, w_phi,
                                            b_phi, sharpness, out, sel, stream)
              : launch<__nv_bfloat16, false>(xt, bank, idx, q, k, w_theta, b_theta,
                                             w_phi, b_phi, sharpness, out, sel, stream);
}
