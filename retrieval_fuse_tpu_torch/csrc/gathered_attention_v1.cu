// Fused gather + K-way patch attention whose candidate tiles are staged in
// shared memory by bulk asynchronous copies.
//
// Replaces the Pallas kernel `_gathered_kernel` /
// `pallas_gathered_patch_attention` of
// retrieval_fuse_tpu/ops/pallas_attention.py:151 and :188 (the serving
// engine's `pallasg` token), v1 of gathered_attention.cu's kernel: the same
// function, and what sets it apart is its structure. Each Pallas grid step
// held all K index-mapped candidate blocks of its tile in on-chip memory,
// brought in by the pipeline while the step before computed. The Hopper
// counterpart of that is the bulk asynchronous copy: a candidate is one
// contiguous run of the bank (bank + idx·64·F elements), so one thread
// starts `cp.async.bulk` for the whole tile, the copy engine reports its
// arrival to an mbarrier, and the compute warps spend no instruction on the
// bytes. Python side: ops/patch_attention.py; the attention arithmetic is
// attention.cuh's, the copy and barrier wrappers are mma.cuh's. Rows are
// F = nf·e³ values, F one of attention.cuh's `with_width` (32, 64, 96 or
// 128; the entry point takes f and dispatches); a slot is one (64, F) tile.
// Those shapes at T = 64, K <= 8 (float32: K <= the staging budget below)
// run the instances described here; every other F in 1..1024, K in 1..32
// and T in 1..512 runs the general instance (attention_general.cuh), which
// stages in chunks: bf16 copies each lane's runs of a 32-column chunk one
// chunk ahead into a double buffer of the warp's by cp.async, float32 a
// tile's rows 128 columns at a time into the activation buffer. The
// wrapper chooses, by shape.
//
// Bound on the H100: as gathered_attention.cu, 0.282 ms at Q=8192, K=4,
// bf16 (279 GFLOP of MLP GEMMs at 989 TFLOP/s).
//
// bf16, on the tensor cores (`gathered_attention_v1_mma`). The obstacle is
// shared memory: theta's and phi's B fragments (2 x 106,496 bytes at F = 128)
// leave no
// room to stage. So a persistent block (one per SM, 12 warps) owns tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... and works in two phases, with phi
// resident throughout:
//   A. The rest of shared memory holds theta's fragments. Each warp runs
//      theta on 16-row slices of the block's own tiles (attention.cuh's
//      register chain) and writes the normalised embeddings, float32, in
//      fragment order to a scratch tensor of the wrapper's (Q·64·32 floats:
//      ~0.04 ms of traffic at Q = 8192). A block reads back only what it
//      wrote, so a block barrier suffices: no grid-wide one.
//   B. The same bytes become rings of 16 KB slots (12 KB at F = 96), one
//      candidate tile a
//      slot. Four warps (a group) own a tile, 16 rows each; each of the
//      three groups has kSlots slots with a full and an empty mbarrier a
//      slot, and its first lane is its producer: it starts the copy of the
//      group's candidate j + kSlots as soon as all four warps have taken
//      candidate j's rows into registers, which is before they compute on
//      them, so a copy has kSlots MLPs (~10 us each) to land. A warp's 8
//      16-byte loads from the slot are its layer-0 A fragments, as from
//      global memory in gathered_attention.cu. Scores, selection and blend
//      are that kernel's; the blend re-reads the selected rows from global
//      memory (in L2 since their copy), as their slot is long recycled.
//   The ring is candidate-granular, so K is not capped by staging: K <= 8.
//
// float32, on FMAs (`gathered_attention_v1`; TF32 would cost ~3 decimal
// digits): attention.cuh's `attend_tile`, one block a tile, whose K
// candidate tiles (K·256·F bytes beside the body's 96,768 bytes: K <= 4 at
// F = 128, K <= 5 at F = 96, K <= 8 at F = 64 and 32; the wrapper sends a
// larger K to the general instance) are copied up front
// by one thread, in flight under theta; phi and the blend read them from
// shared memory.

#include "attention_general.cuh"

namespace {

using namespace rf_attention;

constexpr size_t kMaxSmemBytes = 232448;  // per block on sm_90

// ---- float32 ----

struct WaitStaged {  // the tile's K candidate copies have landed
  uint64_t* bar;
  __device__ void operator()() const { rf_mma::mbar_wait(bar, 0); }
};

template <int F, bool kHard>
__global__ void __launch_bounds__(kThreads, 1)
gathered_attention_v1(const float* __restrict__ xt, const float* __restrict__ bank,
                      const int* __restrict__ idx, int K,
                      const float* __restrict__ w_theta, const float* __restrict__ b_theta,
                      const float* __restrict__ w_phi, const float* __restrict__ b_phi,
                      float sharpness, float* __restrict__ out, int* __restrict__ sel_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  constexpr unsigned kTileBytes = kT * F * sizeof(float);
  float* stage = smem + kSmemFloats;
  const size_t q = blockIdx.x;
  if (threadIdx.x == 0) {
    rf_mma::mbar_init(&bar, 1);
    rf_mma::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    rf_mma::mbar_arrive_expect_tx(&bar, K * kTileBytes);
    for (int k = 0; k < K; ++k)
      rf_mma::bulk_copy_to_shared(stage + k * kT * F,
                                  bank + static_cast<size_t>(idx[q * K + k]) * kT * F,
                                  kTileBytes, &bar);
  }
  const StridedRows<float> r{xt + q * kT * F, stage, static_cast<size_t>(kT) * F, F, kT, K};
  attend_tile<float, F, kHard>(r, smem, w_theta, b_theta, w_phi, b_phi, sharpness,
                               out + q * kT * F, sel_out == nullptr ? nullptr : sel_out + q * kT,
                               WaitStaged{&bar});
}

// ---- bf16 ----

// candidate slots in a group's ring (tools/torch_port_kernel_probe.py builds
// 1 with -DRF_PROBE_V1_SLOTS=1: a copy then starts only when the candidate
// before it has been taken, and has one MLP to land)
#ifndef RF_PROBE_V1_SLOTS
#define RF_PROBE_V1_SLOTS 2
#endif
constexpr int kSlots = RF_PROBE_V1_SLOTS;
constexpr int kGroupWarps = kSlicesPerTile;    // a tile's four 16-row slices
constexpr int kGroups = kWarps / kGroupWarps;
static_assert(kWarps % kGroupWarps == 0 && kGroups >= 1, "whole groups of four warps");

// the bf16 kernel's shared memory at row width F: theta's fragments, then
// in their place the rings; phi's fragments, the biases, the scores, the
// rings' barriers
template <int F>
struct V1Layout {
  static constexpr unsigned kSlotBytes = kT * F * sizeof(__nv_bfloat16);
  static constexpr size_t kRingBytes = static_cast<size_t>(kGroups) * kSlots * kSlotBytes;
  static constexpr size_t kThetaBytes = MmaWidth<F>::kMlpWords * sizeof(uint32_t);
  static constexpr size_t kRegionBytes = kRingBytes > kThetaBytes ? kRingBytes : kThetaBytes;
  static constexpr size_t kBarOffset = kRegionBytes + kThetaBytes + 2 * kBiases * sizeof(float)
                                       + kWarps * kSlice * kScoreLd * sizeof(float);
  static constexpr size_t kSmemBytes = kBarOffset + 2 * kGroups * kSlots * sizeof(uint64_t);
  static_assert(kSlots >= 1 && kSmemBytes <= kMaxSmemBytes, "phi and the rings in one block");
  static_assert(kBarOffset % 8 == 0, "the barriers' alignment");
};

template <int F, bool kHard>
__global__ void __launch_bounds__(kMmaThreads, 1)
gathered_attention_v1_mma(const __nv_bfloat16* __restrict__ xt,
                          const __nv_bfloat16* __restrict__ bank, const int* __restrict__ idx,
                          int Q, int K, const __nv_bfloat16* __restrict__ w_theta,
                          const float* __restrict__ b_theta,
                          const __nv_bfloat16* __restrict__ w_phi,
                          const float* __restrict__ b_phi, float sharpness,
                          float* xf_scratch,  // written in phase A, read in phase B: no __ldg
                          __nv_bfloat16* __restrict__ out, int* __restrict__ sel_out) {
  using T = __nv_bfloat16;
  using L = V1Layout<F>;
  constexpr unsigned kSlotBytes = L::kSlotBytes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint32_t* wt = reinterpret_cast<uint32_t*>(smem_raw);  // theta's fragments, then the rings
  uint32_t* wp = reinterpret_cast<uint32_t*>(smem_raw + L::kRegionBytes);
  float* bt = reinterpret_cast<float*>(wp + MmaWidth<F>::kMlpWords);
  float* bp = bt + kBiases;
  float* scores = bp + kBiases + (threadIdx.x >> 5) * kSlice * kScoreLd;  // this warp's
  uint64_t* bars = reinterpret_cast<uint64_t*>(bp + kBiases + kWarps * kSlice * kScoreLd);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stage_fragments<F>(w_theta, wt);
  stage_fragments<F>(w_phi, wp);
  for (int i = threadIdx.x; i < kBiases; i += kMmaThreads) {
    bt[i] = b_theta[i];
    bp[i] = b_phi[i];
  }
  if (threadIdx.x == 0) {
    for (int g = 0; g < kGroups; ++g)
      for (int s = 0; s < kSlots; ++s) {
        rf_mma::mbar_init(bars + (2 * g) * kSlots + s, 1);                 // full: the producer
        rf_mma::mbar_init(bars + (2 * g + 1) * kSlots + s, kGroupWarps);   // empty: each warp
      }
    rf_mma::mbar_init_fence();
  }
  __syncthreads();

  // the block's tiles: blockIdx.x + i·gridDim.x, i in [0, tiles)
  const int tiles = (Q - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1)
                    / static_cast<int>(gridDim.x);
  auto tile_of = [&](int i) { return blockIdx.x + static_cast<size_t>(i) * gridDim.x; };
  uint32_t a[kHSteps][4];
  RowLoads<F> ld;
  float xf[kC / 8][4];

  // A: theta on the 16-row slices of the block's tiles, the next slice's
  // rows in flight under this one's MLP
  const int slices = tiles * kSlicesPerTile;
  if (warp < slices)
    load_rows16<F>(xt + tile_of(warp / kSlicesPerTile) * kT * F, F,
                   warp % kSlicesPerTile * kSlice, kT, lane, ld);
  for (int s = warp; s < slices; s += kWarps) {
    to_fragments<F>(ld, a);
    const int next = s + kWarps;
    if (next < slices)
      load_rows16<F>(xt + tile_of(next / kSlicesPerTile) * kT * F, F,
                     next % kSlicesPerTile * kSlice, kT, lane, ld);
    mlp_mma<F>(a, wt, bt, lane, xf);
    normalise_mma(xf);
    float4* dst = reinterpret_cast<float4*>(
        xf_scratch + ((tile_of(s / kSlicesPerTile) * kSlicesPerTile + s % kSlicesPerTile) * 32
                      + lane) * (kC / 2));
#pragma unroll
    for (int j = 0; j < kC / 8; ++j) dst[j] = make_float4(xf[j][0], xf[j][1], xf[j][2], xf[j][3]);
  }
  rf_mma::fence_proxy_async();  // theta's fragments were read; the copy engine may overwrite
  __syncthreads();              // and the block's embeddings are visible to the block

  // B: phi over the staged candidates of the group's tiles: the block's
  // group + i·kGroups-th, i in [0, group_tiles). The group's candidates in
  // order are its items; item j uses slot j % kSlots for the j / kSlots-th time.
  const int group = warp / kGroupWarps, row0 = warp % kGroupWarps * kSlice;
  const int group_tiles = tiles > group ? (tiles - group + kGroups - 1) / kGroups : 0;
  const int items = group_tiles * K;
  const T* ring = reinterpret_cast<const T*>(smem_raw + group * kSlots * kSlotBytes);
  uint64_t* full = bars + (2 * group) * kSlots;
  uint64_t* empty = full + kSlots;
  const bool producer = warp % kGroupWarps == 0 && lane == 0;
  auto start_copy = [&](int item) {
    const size_t q = tile_of(group + item / K * kGroups);
    const int slot = item % kSlots;
    rf_mma::mbar_arrive_expect_tx(full + slot, kSlotBytes);
    rf_mma::bulk_copy_to_shared(const_cast<T*>(ring) + slot * kT * F,
                                bank + static_cast<size_t>(idx[q * K + item % K]) * kT * F,
                                kSlotBytes, full + slot);
  };
  if (producer)
    for (int item = 0; item < kSlots && item < items; ++item) start_copy(item);

  int item = 0;
  for (int i = 0; i < group_tiles; ++i) {
    const size_t q = tile_of(group + i * kGroups);
    const float4* src = reinterpret_cast<const float4*>(
        xf_scratch + ((q * kSlicesPerTile + warp % kGroupWarps) * 32 + lane) * (kC / 2));
#pragma unroll
    for (int j = 0; j < kC / 8; ++j) {
      const float4 v = src[j];
      xf[j][0] = v.x, xf[j][1] = v.y, xf[j][2] = v.z, xf[j][3] = v.w;
    }
    for (int k = 0; k < K; ++k, ++item) {
      const int slot = item % kSlots;
      const unsigned parity = (item / kSlots) & 1;
      rf_mma::mbar_wait(full + slot, parity);
      staged_rows16<F>(ring + slot * kT * F, row0, lane, ld);
      to_fragments<F>(ld, a);
      __syncwarp();  // every lane has its rows: the warp is done with the slot
      if (lane == 0) rf_mma::mbar_arrive(empty + slot);
      if (producer && item + kSlots < items) {
        rf_mma::mbar_wait(empty + slot, parity);  // all four warps are done with it
        start_copy(item + kSlots);
      }
      __syncwarp();
      float emb[kC / 8][4];
      mlp_mma<F>(a, wp, bp, lane, emb);
      score_mma(xf, emb, scores, k, lane);
    }
    const BankRows<T, F> r{xt + q * kT * F, bank, idx + q * K, kT, K};
    __syncwarp();
    select_mma<kHard>(scores, K, sharpness, lane, row0, kT,
                      sel_out == nullptr ? nullptr : sel_out + q * kT);
    __syncwarp();
    blend_mma<F>(r, row0, scores, lane, out + q * kT * F);
    __syncwarp();  // the scores are free for the warp's next tile
  }
}

template <int F, bool kHard>
int launch_f32(const void* xt, const void* bank, const int* idx, int q, int k,
               const void* w_theta, const float* b_theta, const void* w_phi,
               const float* b_phi, float sharpness, void* out, int* sel, cudaStream_t s) {
  const size_t smem = kSmemBytes + static_cast<size_t>(k) * kT * F * sizeof(float);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  return launch_blocks(gathered_attention_v1<F, kHard>, q, kThreads, smem, s,
                       static_cast<const float*>(xt), static_cast<const float*>(bank), idx, k,
                       static_cast<const float*>(w_theta), b_theta,
                       static_cast<const float*>(w_phi), b_phi, sharpness,
                       static_cast<float*>(out), sel);
}

template <int F, bool kHard>
int launch_bf16(const void* xt, const void* bank, const int* idx, int q, int k,
                const void* w_theta, const float* b_theta, const void* w_phi,
                const float* b_phi, float sharpness, void* out, int* sel, float* scratch,
                cudaStream_t s) {
  using T = __nv_bfloat16;
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const int sms = sm_count(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int want = (q + kGroups - 1) / kGroups;  // a tile for every group first
  return launch_blocks(gathered_attention_v1_mma<F, kHard>, want < sms ? want : sms,
                       kMmaThreads, V1Layout<F>::kSmemBytes, s, static_cast<const T*>(xt),
                       static_cast<const T*>(bank),
                       idx, q, k, static_cast<const T*>(w_theta), b_theta,
                       static_cast<const T*>(w_phi), b_phi, sharpness, scratch,
                       static_cast<T*>(out), sel);
}

// ---- the general instance (attention_general.cuh): any F, K, T, staged in chunks ----

template <bool kHard>
__global__ void __launch_bounds__(kThreads, 2)
gathered_attention_v1_general(const float* __restrict__ xt, const float* __restrict__ bank,
                              const int* __restrict__ idx, int Q, int T, int K, int F,
                              const float* __restrict__ w_theta,
                              const float* __restrict__ b_theta,
                              const float* __restrict__ w_phi, const float* __restrict__ b_phi,
                              float sharpness, float* __restrict__ out,
                              int* __restrict__ sel_out) {
  extern __shared__ __align__(16) float smem[];
  const auto r = BankSlices<float, kT>{xt, bank, idx, Q, T, K, F}(blockIdx.x);
  attend_tile_general<float, kHard, true>(r, F, smem, w_theta, b_theta, w_phi, b_phi,
                                          sharpness, out + r.row0 * F,
                                          sel_out == nullptr ? nullptr : sel_out + r.row0);
}

template <bool kHard>
__global__ void __launch_bounds__(kMmaThreads, 1)
gathered_attention_v1_general_mma(const __nv_bfloat16* __restrict__ xt,
                                  const __nv_bfloat16* __restrict__ bank,
                                  const int* __restrict__ idx, int Q, int T, int K, int F,
                                  const __nv_bfloat16* __restrict__ w_theta,
                                  const float* __restrict__ b_theta,
                                  const __nv_bfloat16* __restrict__ w_phi,
                                  const float* __restrict__ b_phi, float sharpness,
                                  __nv_bfloat16* __restrict__ out, int* __restrict__ sel_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attend_slices_general<kHard, true>(BankSlices<__nv_bfloat16, kSlice>{xt, bank, idx, Q, T, K, F},
                                     F, smem_raw, w_theta, b_theta, w_phi, b_phi, sharpness, out,
                                     sel_out);
}

template <bool kHard>
int launch_general(int dtype, const void* xt, const void* bank, const int* idx, int q, int k,
                   int f, int t, const void* w_theta, const float* b_theta, const void* w_phi,
                   const float* b_phi, float sharpness, void* out, int* sel, cudaStream_t s) {
  if (dtype == 0) {
    const long long tiles = BankSlices<float, kT>{nullptr, nullptr, nullptr, q, t, k, f}.count();
    return launch_blocks(gathered_attention_v1_general<kHard>, static_cast<int>(tiles), kThreads,
                         kGSmemBytes, s, static_cast<const float*>(xt),
                         static_cast<const float*>(bank), idx, q, t, k, f,
                         static_cast<const float*>(w_theta), b_theta,
                         static_cast<const float*>(w_phi), b_phi, sharpness,
                         static_cast<float*>(out), sel);
  }
  using E = __nv_bfloat16;
  cudaError_t err;
  const int blocks = general_blocks(
      BankSlices<E, kSlice>{nullptr, nullptr, nullptr, q, t, k, f}.count(), &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_blocks(gathered_attention_v1_general_mma<kHard>, blocks, kMmaThreads,
                       general_mma_smem<true>(), s, static_cast<const E*>(xt),
                       static_cast<const E*>(bank), idx, q, t, k, f,
                       static_cast<const E*>(w_theta), b_theta, static_cast<const E*>(w_phi),
                       b_phi, sharpness, static_cast<E*>(out), sel);
}

}  // namespace

// The operands of rf_gathered_attention (gathered_attention.cu), and
// `scratch`: q * 64 * 32 float32 for the shipped bfloat16 instance (the
// theta embeddings between the kernel's phases), unused otherwise. general
// 0: bfloat16 runs on the tensor cores with 1 <= k <= 8; float32 on FMAs
// with k * 64 * f * 4 bytes of staging (k <= 4 at f = 128, k <= 5 at
// f = 96, k <= 8 at f = 64 and 32); t = 64. general 1: 1 <= f <= 1024,
// 1 <= t <= 512, 1 <= k <= 32, staged in chunks. Returns a cudaError_t value.
extern "C" int rf_gathered_attention_v1(int dtype, const void* xt, const void* bank,
                                        const int* idx, int q, int k, int f, int t, int general,
                                        const void* w_theta, const float* b_theta,
                                        const void* w_phi, const float* b_phi, int hard,
                                        float sharpness, void* out, int* sel, float* scratch,
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
      return hard ? launch_f32<F, true>(xt, bank, idx, q, k, w_theta, b_theta, w_phi, b_phi,
                                        sharpness, out, sel, stream)
                  : launch_f32<F, false>(xt, bank, idx, q, k, w_theta, b_theta, w_phi, b_phi,
                                         sharpness, out, sel, stream);
    return hard ? launch_bf16<F, true>(xt, bank, idx, q, k, w_theta, b_theta, w_phi, b_phi,
                                       sharpness, out, sel, scratch, stream)
                : launch_bf16<F, false>(xt, bank, idx, q, k, w_theta, b_theta, w_phi, b_phi,
                                        sharpness, out, sel, scratch, stream);
  });
}
