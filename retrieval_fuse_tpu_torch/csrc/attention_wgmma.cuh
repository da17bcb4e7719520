// The bf16 attention body of the shipped instances of gathered_attention.cu
// and patch_attention.cu, on Hopper's warpgroup MMA (wgmma): one warpgroup
// (four warps) a 64-row tile. The function is attention.cuh's (theta on x,
// phi on each of the K candidates, normalised scores, ReLU-of-max switch,
// hard argmax(25 s) or softmax(sharpness s) selection, blend); so is the
// arithmetic: bf16 products with float32 sums, float32 biases, hidden
// activations rounded to bf16 between layers, float32 norms, scores,
// selection and blend. Only the order of the sums differs from the plain
// version.
//
// What the design does:
//   - Each MLP layer is a chain of wgmma.mma_async m64n128k16 (the output
//     layer m64n32k16) in the RS form: A from registers, B from shared
//     memory through a matrix descriptor. A tile is exactly wgmma's M = 64
//     rows, so each B tile is read from shared memory once for 64 rows (the
//     mma.sync body of attention.cuh read each B fragment once for 16).
//   - Per warp of the warpgroup, wgmma's A fragments and accumulators are
//     mma.sync.m16n8k16's A and C fragments (warp w holds rows 16w..16w+15),
//     so the pieces of attention.cuh carry over: `load_rows16` (16-byte
//     __ldg runs of a lane's two rows, layer 0's k permuted so that a run is
//     the A fragments of two k16 steps), `hidden_to_fragments` (bias,
//     LeakyReLU 0.01, round to bf16: a layer's accumulators become the next
//     layer's A fragments in registers), `score_mma`, `select_mma` and
//     `blend_mma`, per warp.
//   - Candidate k+1's row loads are issued as soon as candidate k's layer-0
//     products are done, so they land under its layers 1-3 (after its
//     wait: see mlp_wgmma), and the next tile's x rows under the last
//     candidate.
//   - The weights stay in shared memory for the life of the block, in the
//     layout the descriptors read: `_pack_wgmma` (ops/patch_attention.py)
//     writes each MLP's exact shared-memory image on the host (WgImage:
//     layers 0-3, then the float32 biases), and a block brings theta's and
//     phi's images in with one cp.async.bulk each onto one mbarrier. Two
//     images are 2 x 108,160 bytes at F = 128; with the warps' scores that
//     is one block an SM, so the launch is persistent: warpgroup g of block
//     b walks over tiles b·G + g, then every gridDim.x·G-th.
//
// The layout (no swizzle, K-major B): a layer of Kin (logical k) x N is
// 8x8 core matrices of 128 contiguous bytes (8 rows n of 16 bytes, 8 k a
// row); the core of k-block kb and n-block nb lies at kb·(N/8)·128 +
// nb·128 bytes. So the k16 step s starts at s·N·32 bytes, the next 8 k lie
// kLbo(N) = N·16 bytes on (the descriptor's leading-dimension byte offset)
// and the next 8 n kCoreBytes = 128 on (its stride-dimension byte offset).
// Layer 0 holds W[perm(k)][n] at logical k, perm(16s + 8u + 2t + e) =
// 32·(s/2) + 8t + 4·(s&1) + 2u + e (load_rows16's order). The Python mirror
// of this address formula is ops/patch_attention.py's `wgmma_b_address`,
// held against the image by tests/test_torch_port_wgmma_layout.py.
//
// Replaces, with its kernels, the Pallas `_gathered_kernel_v2`
// (retrieval_fuse_tpu/ops/pallas_attention.py:249) and `_attention_kernel`
// (:46). Bound on the H100: at Q = 8192 tiles, K = 4, F = 128, the MLPs are
// 279 GFLOP, 0.282 ms at the 989 TFLOP/s bf16 tensor-core rate (the rows'
// bytes take ~0.24 ms at 3.35 TB/s). Measured on an H100 (700 W) there:
// 0.710-0.739 ms for the two kernels (the mma.sync body: 1.10-1.15),
// 1.47-1.61x faster than the mma.sync body at every shipped F, 2.3-2.6x
// the bound; half the bound is not reached at any F. What holds it: a warpgroup's layers run one after the
// other, each waiting for the last one's epilogue (bias, LeakyReLU, bf16
// round of 64 accumulators a thread), so the tensor cores work only while
// another warpgroup has products in flight; more warpgroups do not fit (see
// kWgGroups). PERF.md has the readings.

#pragma once

#include "attention.cuh"

namespace rf_attention {

// warpgroups of a persistent block: G = threads / 128 (RF_PROBE_ATTN_THREADS,
// which also sizes the mma.sync bodies' blocks; tools/torch_port_kernel_probe.py
// builds other G with -DRF_PROBE_ATTN_THREADS=128·G). G = 3, measured on an
// H100 (700 W) at F = 128, Q = 8192, K = 4 (two readings each, in the
// probe's harness): G 2 0.838 / 0.841 ms (180 registers at F = 128), G 3
// 0.703 / 0.700 (168, a 24-byte stack frame at F = 128), G 4 0.933 (128
// registers: ptxas spills and serializes the wgmma).
constexpr int kWgGroups = kMmaThreads / 128;
static_assert(kMmaThreads % 128 == 0, "whole warpgroups");
constexpr int kWgThreads = 128 * kWgGroups;
constexpr int kWgWarps = 4 * kWgGroups;

constexpr int kCoreBytes = 128;  // an 8x8 bf16 core matrix; the descriptor's SBO
constexpr int kCoreRowBytes = 16;
// the descriptor's LBO (the next 8 k) and a k16 step's bytes, for a layer N wide
__host__ __device__ constexpr int kLbo(int n) { return n * 16; }
__host__ __device__ constexpr int kStepBytes(int n) { return n * 32; }

// One MLP's shared-memory image at row width F, in bytes: layer 0 (F x 128),
// layers 1, 2 (128 x 128), the output layer (128 x 32), then the 416 float32
// biases (fc0, fc1, fc2, out).
template <int F>
struct WgImage {
  static constexpr int kL0 = 0;
  static constexpr int kL1 = kL0 + F * kH * 2;
  static constexpr int kL2 = kL1 + kH * kH * 2;
  static constexpr int kL3 = kL2 + kH * kH * 2;
  static constexpr int kBias = kL3 + kH * kC * 2;
  static constexpr int kBytes = kBias + kBiases * 4;
  static constexpr size_t kScoreBytes = static_cast<size_t>(kWgWarps) * kSlice * kScoreLd * 4;
  static constexpr size_t kSmemBytes = 2 * static_cast<size_t>(kBytes) + kScoreBytes + 8;
  static_assert(kBytes % kCoreBytes == 0, "each image and its layers 128-byte aligned");
  static_assert(kSmemBytes <= 232448, "theta and phi resident in one block's shared memory");
};

// a no-swizzle matrix descriptor: start address, LBO and SBO in 16-byte units
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// after wg_wait_all: the accumulators change there, for the compiler too,
// so that no read of them is moved above the wait
template <int NT>
__device__ __forceinline__ void wg_fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// the same for the A fragments of a wgmma chain, before its wgmma.fence and
// after its wait (CUTLASS's warpgroup_fence_operand): a wgmma in flight
// reads its A registers until the wait, so the compiler must keep them, and
// move no write of them, between the two
template <int STEPS>
__device__ __forceinline__ void wg_fence_operand(uint32_t (&a)[kHSteps][4]) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
}

#define RF_WG_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d (+)= a (64 x 16, this warp's A fragments) . B (16 x 128 at desc);
// accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : RF_WG_D4(0), RF_WG_D4(1), RF_WG_D4(2), RF_WG_D4(3), RF_WG_D4(4), RF_WG_D4(5),
        RF_WG_D4(6), RF_WG_D4(7), RF_WG_D4(8), RF_WG_D4(9), RF_WG_D4(10), RF_WG_D4(11),
        RF_WG_D4(12), RF_WG_D4(13), RF_WG_D4(14), RF_WG_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// the same for B 16 x 32 (the output layer)
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : RF_WG_D4(0), RF_WG_D4(1), RF_WG_D4(2), RF_WG_D4(3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

#undef RF_WG_D4

// Issue and commit one layer: d = A (STEPS k16 steps of fragments in a) .
// the layer of N columns whose image starts at shared address b. The caller
// waits (wg_wait, below) before it reads d or writes a.
template <int N, int STEPS>
__device__ __forceinline__ void wg_layer(uint32_t (&a)[kHSteps][4], uint32_t b,
                                         float (&d)[N / 8][4]) {
  static_assert(N == kH || N == kC, "the MLP's widths");
  wg_fence_operand<STEPS>(a);
  wg_fence();
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const uint64_t desc = wg_desc(b + s * kStepBytes(N), kLbo(N), kCoreBytes);
    if constexpr (N == kH)
      wgmma_n128(d, a[s], desc, s > 0);
    else
      wgmma_n32(d, a[s], desc, s > 0);
  }
  wg_commit();
}

// Wait for the layer that wg_layer<N, STEPS> issued: its accumulators d are
// then final and its A fragments a free, for the compiler too.
template <int N, int STEPS>
__device__ __forceinline__ void wg_wait(uint32_t (&a)[kHSteps][4], float (&d)[N / 8][4]) {
  wg_wait_all();
  wg_fence_acc(d);
  wg_fence_operand<STEPS>(a);
}

// The 4-layer MLP on the warpgroup's 64 rows (this warp's 16 in `a`, layer
// 0's F/16 steps of fragments; overwritten by the hidden activations), with
// the image at shared address `img` and its biases at `bias`. Leaves this
// warp's (16, kC) float32 result in out (mlp_mma's layout). `after_layer0`
// runs once layer 0's products are done, under layers 1-3: its loads may
// write the registers that layer 0's A fragments came from (`to_fragments`
// is register moves).
template <int F, typename AfterLayer0>
__device__ __forceinline__ void mlp_wgmma(uint32_t (&a)[kHSteps][4], uint32_t img,
                                          const float* bias, int lane, float (&out)[kC / 8][4],
                                          AfterLayer0 after_layer0) {
  using I = WgImage<F>;
  {
    float acc[kH / 8][4];
    wg_layer<kH, F / 16>(a, img + I::kL0, acc);
    wg_wait<kH, F / 16>(a, acc);
    after_layer0();
    hidden_to_fragments(acc, bias, lane, a);
  }
#pragma unroll 1
  for (int layer = 1; layer < 3; ++layer) {
    float acc[kH / 8][4];
    wg_layer<kH, kHSteps>(a, img + I::kL1 + (layer - 1) * (I::kL2 - I::kL1), acc);
    wg_wait<kH, kHSteps>(a, acc);
    hidden_to_fragments(acc, bias + layer * kH, lane, a);
  }
  wg_layer<kC, kHSteps>(a, img + I::kL3, out);
  wg_wait<kC, kHSteps>(a, out);
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

// Attention over the 64-row tile of row source `r`, by one warpgroup: this
// warp takes rows 16w..16w+15 (w its rank in the warpgroup) in every
// product, and scores, selects and blends them. Rows at or past r.n are
// zero in the MLPs and never written. `ld` holds the tile's x rows (loads
// in flight); under the last candidate's MLP it is given the x rows of
// `next` if `has_next`. theta's image at shared address wt (biases bt),
// phi's at wp (bp); `scores` is this warp's (kSlice, kScoreLd).
template <int F, bool kHard, typename Rows>
__device__ __forceinline__ void attend_tile_wgmma(const Rows& r, const Rows& next, bool has_next,
                                                  RowLoads<F>& ld, uint32_t wt, const float* bt,
                                                  uint32_t wp, const float* bp, float* scores,
                                                  float sharpness,
                                                  __nv_bfloat16* __restrict__ out,
                                                  int* __restrict__ sel_out) {
  const int lane = threadIdx.x & 31;
  const int row0 = ((threadIdx.x >> 5) & 3) * kSlice;
  const int K = r.K;
  uint32_t a[kHSteps][4];
  float emb[kC / 8][4], xf[kC / 8][4];

  to_fragments<F>(ld, a);
  mlp_wgmma<F>(a, wt, bt, lane, xf, [&] {  // candidate 0's rows under theta
    load_rows16<F>(r.cand(0), r.stride, row0, r.n, lane, ld);
  });
  normalise_mma(xf);

  for (int k = 0; k < K; ++k) {
    to_fragments<F>(ld, a);
    mlp_wgmma<F>(a, wp, bp, lane, emb, [&] {
      if (k + 1 < K)
        load_rows16<F>(r.cand(k + 1), r.stride, row0, r.n, lane, ld);
      else if (has_next)
        load_rows16<F>(next.x, F, row0, next.n, lane, ld);
    });
    score_mma(xf, emb, scores, k, lane);
  }
  __syncwarp();
  select_mma<kHard>(scores, K, sharpness, lane, row0, r.n, sel_out);
  __syncwarp();
  blend_mma<F, kHard>(r, row0, scores, lane, out);
  __syncwarp();  // the scores are free for the warp's next tile
}

// The persistent body of the two kernels: bring theta's and phi's images
// (WgImage<F>, 16-byte aligned in global memory) into shared memory by one
// bulk copy each, then let warpgroup g walk over tiles blockIdx.x·G + g,
// then every gridDim.x·G-th, of [0, tiles), each tile's x rows loaded under
// the tile before. `tile_rows(q)` is tile q's row source; its rows go to
// out + q·kT·F and its selections to sel_out + q·kT.
template <int F, bool kHard, typename TileRows>
__device__ __forceinline__ void attend_tiles_wgmma(TileRows tile_rows, long long tiles,
                                                   unsigned char* smem,
                                                   const __nv_bfloat16* __restrict__ img_theta,
                                                   const __nv_bfloat16* __restrict__ img_phi,
                                                   float sharpness,
                                                   __nv_bfloat16* __restrict__ out,
                                                   int* __restrict__ sel_out) {
  using I = WgImage<F>;
  unsigned char* wt = smem;
  unsigned char* wp = smem + I::kBytes;
  float* scores = reinterpret_cast<float*>(smem + 2 * I::kBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * I::kBytes + I::kScoreBytes);
  if (threadIdx.x == 0) {
    rf_mma::mbar_init(bar, 1);
    rf_mma::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    rf_mma::mbar_arrive_expect_tx(bar, 2 * I::kBytes);
    rf_mma::bulk_copy_to_shared(wt, img_theta, I::kBytes, bar);
    rf_mma::bulk_copy_to_shared(wp, img_phi, I::kBytes, bar);
  }

  const int group = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 3) * kSlice;
  const long long step = static_cast<long long>(gridDim.x) * kWgGroups;
  long long q = static_cast<long long>(blockIdx.x) * kWgGroups + group;
  RowLoads<F> ld;
  auto r = tile_rows(q < tiles ? q : 0);
  if (q < tiles) load_rows16<F>(r.x, F, row0, r.n, lane, ld);  // under the bulk copies
  rf_mma::mbar_wait(bar, 0);

  const uint32_t st = rf_mma::shared_address(wt), sp = rf_mma::shared_address(wp);
  const float* bt = reinterpret_cast<const float*>(wt + I::kBias);
  const float* bp = reinterpret_cast<const float*>(wp + I::kBias);
  float* my_scores = scores + warp * kSlice * kScoreLd;
  for (; q < tiles; q += step) {
    const bool has_next = q + step < tiles;
    const auto next = tile_rows(has_next ? q + step : q);
    attend_tile_wgmma<F, kHard>(r, next, has_next, ld, st, bt, sp, bp, my_scores, sharpness,
                                out + q * kT * F, sel_out == nullptr ? nullptr : sel_out + q * kT);
    r = next;
  }
}

// the persistent grid for `tiles` tiles: one block per SM, or fewer where
// the tiles do not fill their warpgroups; 0 if the device cannot be asked
inline int wgmma_blocks(long long tiles, cudaError_t* err) {
  const int sms = sm_count(err);
  const long long want = (tiles + kWgGroups - 1) / kWgGroups;
  return static_cast<int>(want < sms ? want : sms);
}

}  // namespace rf_attention
