// The serving decoder's tail on the packed grid: 3³ conv2 (nf -> nf) at
// (2S)³, ReLU, 1x1 head, bias, tanh, in one pass.
//
// Replaces the Pallas kernel `_decoder_tail_kernel` / `packed_decoder_tail`
// of retrieval_fuse_tpu/ops/pallas_decoder.py:94 and :154 (the serving
// engine's `cdec` token). Python side: ops/decoder_tail.py.
//
// Input hn (B, S+2, S+2, S+2, 8·nf): conv1's GroupNorm-applied output on the
// coarse grid, zero-padded by one, with o_idx-major channel blocks
// (o_idx = o0·4 + o1·2 + o2 is the 2x-grid sub-position). Output
// (B, S, S, S, 8) float32 = tanh(head(relu(conv2(·))) + bias) of the 2x
// grid, o_idx-minor. Output voxel 2i+o per axis reads 2x-grid taps
// y = 2i+o+k-1, k ∈ {0,1,2}, which live at packed position floor(y/2),
// block y mod 2. In bf16 the ReLU output is rounded to bf16 before the
// head, as in the JAX kernel (pallas_decoder.py:148); bias and tanh are
// float32.
//
// Both bodies are the direct 27-tap conv read through the packed layout,
// not the JAX kernel's im2col GEMM over the 64 packed offsets, which spends
// 64/27 = 2.37x the useful FLOPs to fill the TPU's matrix unit. No TPU
// workaround is carried over (the sublane-aligned pad of the input's minor
// axis, the 4-group split of the im2col columns, the t0-row grid); ragged
// edges stop by index.
//
// bf16 at nf = 16 (the flagship width) and nf = 12 (the surface-
// reconstruction configs): an implicit GEMM on the tensor cores,
// `decoder_tail_mma`. Per output voxel the conv is a product of
// depth 27·16 and width 16: M is 16 neighbouring voxels of a 2x-grid row,
// one tap is one k16 step, the width is two n8 tiles of
// mma.sync.m16n8k16.bf16 with float32 sums. A tile is 2 x 2 packed
// positions (i0, i1) and all of i2: 4 x 4 rows of the 2x grid. Its slab, the
// 6 x 6 rows around them (the halo is read once for 16 output rows), stays
// in bf16, voxel-major and channel-minor (32 bytes a voxel), filled by
// cp.async in 16-byte halves of a voxel; a voxel's two halves are swapped
// where (voxel / 4) is odd, so that the eight 16-byte rows of each ldmatrix
// phase fall in eight different bank groups. The A fragment of tap
// (k0, k1, k2) is then one ldmatrix at an offset of k2 voxels in slab row
// (o0 + k0, o1 + k1): no im2col matrix exists. A compute warp owns the four
// output rows of one packed (i0, i1) over 32 voxels (64 float32 sums a
// thread) and walks the 4 x 4 slab rows under them, so each A fragment is
// loaded once for the up to four (output row, tap) pairs that read it. The
// weights sit in shared memory in B-fragment order (one 16-byte load a lane
// and tap). The epilogue rounds relu to bf16, takes the head as a partial
// sum over a lane's four channels and two shuffles, and the four lanes of a
// quad store the four rows' values of a voxel, so a warp's store fills whole
// 32-byte sectors of the o_idx-minor output.
//   The launch is persistent (one block on an SM, walking over tiles), so
// the weights are laid out once per block, and the block is split by role:
// 8 warps compute, 4 warps only copy the next tile's slab into a second
// buffer. Measured on an NVIDIA H100 80GB HBM3 at 700 W (B=128, S=32;
// tools/torch_port_kernel_probe.py): the conv alone takes ~1.2 ms and the
// copies alone 0.7-0.9 ms; run by the same warps they added up (1.7-1.8
// ms, two blocks on an SM or two buffers alike), because a warp whose
// cp.async waits on the memory system starts no mma; with copy warps the
// two overlap (1.4 ms).
//
// At nf = 12 a voxel's 12 channels are zero-padded to 16 in the slab (the
// pad bytes are zeroed once a block and no copy writes them) and the
// weights' extra rows and columns are zero, so one tap is still one k16
// step and the sums are exact; a third of the products are of zeros. A
// voxel's channels are then 24 bytes of the source, so the copies take 8
// bytes at a time (cp.async.ca) where nf = 16 takes 16.
//
// float32, and nf ∈ {4, 8}: `decoder_tail`, float32 FMAs (float32 on the
// tensor cores would be TF32, ~3 decimal digits). One block per packed row
// (b, i0, i1); a float32 slab of 4 x 4 rows of the 2x grid, channel-major
// with an odd pitch; one thread per output voxel, weights read as broadcast
// float4s.
//
// Every other nf in bf16 up to 32 runs the general tensor-core instance,
// `decoder_tail_mma_g`, where its slabs fit (described above it). Every
// other nf in 1..64, in both types, runs `decoder_tail_general` (the
// wrapper chooses the instance by shape), the
// float32-FMA body with its conv width a
// template multiple of 8, NFP = nf rounded up to 8 (the weights' extra
// columns are zero, so the extra sums are exact zeros and the head skips
// nothing it needs). What bounds the FMA body past nf 16 is shared memory:
// its float32 slab of all nf channels (nf·(16·(2S+2)+1)·4 bytes, 270 KB at
// nf 64, S = 32) and 27·nf² weights (442 KB at nf 64) do not fit a block.
// So a block walks the input channels in chunks of kGCi = 8: it stages the
// chunk's slab and its 27·8·NFP weights (138.5 KB at S = 80, NFP = 64),
// and each thread keeps its voxel's NFP sums in registers across the
// chunks; where 8·S voxels outnumber the block's threads (S > 32) the
// chunks are staged again for each round of voxels. The tensor-core body
// stops at nf 32 (and S 32 there): its B fragments of all taps
// (27·(NFP/16)²·512 bytes, 221 KB at NFP 64) and its bf16 slab of 6 x 6
// rows (36·pitch·2·NFP bytes) leave no room past that, so a bf16 input
// there runs the FMA body, on products of bf16 values that are exact in
// float32, as the shipped nf 4 and 8 do. It is held by its FMA rate:
// 27·nf² FMAs a voxel at the 67 TFLOP/s float32 peak.
//
// Bound on the H100 at batch 128 (S=32, nf=16, bf16): 465 GFLOP of useful
// conv and head work, 0.47 ms at the 989 TFLOP/s bf16 tensor-core rate;
// 1.42 GB of bytes, 0.43 ms at 3.35 TB/s. What holds the mma body is the
// conv loop itself: 432 mma.sync of a warp tile with their 96 ldmatrix.x4
// and 108 16-byte weight loads (keeping the weights in registers instead
// changed nothing: 1.77 against 1.69 ms), two warps on each scheduler.
// Measured times: PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmemBytes = 232448;  // per block on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---- float32, and nf ∈ {4, 8}: float32 FMAs ----

__host__ __device__ constexpr int slab_cols(int s) { return 2 * s + 2; }
__host__ __device__ constexpr int channel_pitch(int s) { return 16 * slab_cols(s) + 1; }

template <int NF>
size_t smem_bytes(int s) {
  return sizeof(float) * (27 * NF * NF + NF + static_cast<size_t>(NF) * channel_pitch(s));
}

template <typename T, int NF>
__global__ void __launch_bounds__(kThreads)
decoder_tail(const T* __restrict__ hn, const float* __restrict__ w2,
             const float* __restrict__ wh, float bias, int S, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int J = slab_cols(S), CS = channel_pitch(S), P = S + 2;
  float* wsm = smem;                   // (27, NF, NF): tap, c_in, c_out
  float* whs = wsm + 27 * NF * NF;     // (NF,)
  float* slab = whs + NF;              // slab[c * CS + R * J + j], R = r0·4 + r1
  const int blk = blockIdx.x;
  const int i1 = blk % S, i0 = (blk / S) % S, b = blk / (S * S);

  for (int i = threadIdx.x; i < 27 * NF * NF; i += kThreads) wsm[i] = w2[i];
  if (threadIdx.x < NF) whs[threadIdx.x] = wh[threadIdx.x];
  // slab row r0 is 2x-grid row 2·i0 - 1 + r0: packed (padded) position
  // i0 + (r0+1)/2, block bit (r0+1) & 1; likewise r1. Slab column j is
  // 2x-grid index j - 1 along the last axis. Each (r0, r1, p2) reads the
  // two channel blocks o_idx = s0·4 + s1·2 + {0, 1}: 2·NF contiguous values.
  constexpr int kRun = 2 * NF;
  for (int i = threadIdx.x; i < 16 * P * kRun; i += kThreads) {
    const int e = i % kRun, p2 = (i / kRun) % P, R = i / (kRun * P);
    const int r0 = R >> 2, r1 = R & 3;
    const int j = 2 * p2 - 1 + e / NF;
    if (j < 0 || j >= J) continue;
    const int pp0 = i0 + ((r0 + 1) >> 1), pp1 = i1 + ((r1 + 1) >> 1);
    const int blk_off = (((r0 + 1) & 1) * 4 + ((r1 + 1) & 1) * 2) * NF;
    const size_t src = (((static_cast<size_t>(b) * P + pp0) * P + pp1) * P + p2) * (8 * NF)
                       + blk_off + e;
    slab[(e % NF) * CS + R * J + j] = to_f32(hn[src]);
  }
  __syncthreads();

  // voxel v -> sub-rows (o0, o1) = v / 2S and 2x-grid column y = v % 2S
  float* row_out = out + (static_cast<size_t>(b) * S + i0) * S * S * 8 + static_cast<size_t>(i1) * S * 8;
  for (int v = threadIdx.x; v < 8 * S; v += kThreads) {
    const int oo = v / (2 * S), y = v % (2 * S);
    const int o0 = oo >> 1, o1 = oo & 1;
    float acc[NF];
#pragma unroll
    for (int c = 0; c < NF; ++c) acc[c] = 0.f;
    for (int k0 = 0; k0 < 3; ++k0) {
      for (int k1 = 0; k1 < 3; ++k1) {
        const float* srow = slab + ((o0 + k0) * 4 + (o1 + k1)) * J + y;
#pragma unroll
        for (int k2 = 0; k2 < 3; ++k2) {
          const float* wk = wsm + ((k0 * 3 + k1) * 3 + k2) * NF * NF;
#pragma unroll 4
          for (int ci = 0; ci < NF; ++ci) {
            const float a = srow[ci * CS + k2];
            const float4* wr = reinterpret_cast<const float4*>(wk + ci * NF);
#pragma unroll
            for (int q = 0; q < NF / 4; ++q) {
              const float4 w = wr[q];
              acc[4 * q + 0] = fmaf(a, w.x, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(a, w.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(a, w.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(a, w.w, acc[4 * q + 3]);
            }
          }
        }
      }
    }
    float z = 0.f;
#pragma unroll
    for (int c = 0; c < NF; ++c) z = fmaf(round_to<T>(fmaxf(acc[c], 0.f)), whs[c], z);
    row_out[(y >> 1) * 8 + o0 * 4 + o1 * 2 + (y & 1)] = tanhf(z + bias);
  }
}

// ---- bf16, nf ∈ {12, 16}: implicit GEMM on the tensor cores ----

constexpr int kNf = 16;          // the mma body's width: one k16 step per tap
constexpr int kTile = 2;         // packed positions per tile along i0 and along i1
constexpr int kSlabSide = 2 * kTile + 2;  // slab rows along each of the two axes
constexpr int kWarpVoxels = 32;  // voxels of a 2x-grid row per warp tile (two m16 tiles)
constexpr int kVoxelBytes = kNf * 2;
constexpr int kWFragBytes = 27 * 32 * 16;  // per tap and lane: b0, b1 of both n8 tiles
constexpr int kComputeWarps = 8;           // warps that run the conv
constexpr int kCopyWarps = 4;              // warps that only copy slabs
constexpr int kMmaThreads = 32 * (kComputeWarps + kCopyWarps);

// Probes of tools/torch_port_kernel_probe.py: built with -DRF_PROBE_NO_COPY
// the kernel copies no slab, with -DRF_PROBE_NO_CONV it runs no conv (its
// output is then meaningless): what each half costs alone.
#ifdef RF_PROBE_NO_COPY
constexpr bool kCopies = false;
#else
constexpr bool kCopies = true;
#endif
#ifdef RF_PROBE_NO_CONV
constexpr bool kConvs = false;
#else
constexpr bool kConvs = true;
#endif

// slab row pitch in voxels: the row's 2S + 2, rounded so that the last warp
// tile's reads (32 voxels + 2 taps) stay inside the row
__host__ __device__ constexpr int mma_pitch(int s) {
  return (2 * s + kWarpVoxels - 1) / kWarpVoxels * kWarpVoxels + 2;
}

__host__ __device__ constexpr int slab_bytes(int s) {
  return kSlabSide * kSlabSide * mma_pitch(s) * kVoxelBytes;
}

size_t mma_smem_bytes(int s, int slabs) {
  return kWFragBytes + kNf * sizeof(float) + static_cast<size_t>(slabs) * slab_bytes(s);
}

// byte offset of half `h` (channels 8h..8h+7) of slab voxel j in its row
__device__ __forceinline__ int voxel_half_offset(int j, int h) {
  return j * kVoxelBytes + ((h ^ ((j >> 2) & 1)) << 4);
}

// tile `index` of the (B, ceil(S/2), ceil(S/2)) tiles: its batch item, first
// packed position and count of valid packed positions along i0 and i1
struct Tile {
  int b, i0, i1, n0, n1;
  __device__ Tile(int index, int S) {
    const int tiles = (S + kTile - 1) / kTile;
    i1 = index % tiles * kTile;
    i0 = index / tiles % tiles * kTile;
    b = index / (tiles * tiles);
    n0 = min(kTile, S - i0);
    n1 = min(kTile, S - i1);
  }
};

// The copies of a tile's slab (cp.async), by the block's copy warps.
// Slab row (r0, r1) is 2x-grid row (2·i0 - 1 + r0, 2·i1 - 1 + r1): packed
// (padded) position i0 + (r0+1)/2, block bit (r0+1) & 1; likewise r1. Slab
// voxel j is 2x-grid index j - 1 along the last axis. Each (r0, r1, p2)
// reads the two channel blocks o_idx = s0·4 + s1·2 + {0, 1}: 2·NF
// contiguous values of voxels 2·p2 - 1 and 2·p2, in chunks of 8 channels
// (16 bytes, NF = 16: four chunks, a half-voxel each) or of 4 (8 bytes,
// NF = 12: six chunks, three a voxel). A warp takes a slab row at a time, a
// lane a chunk; returns when this lane's copies have landed (a barrier
// publishes them).
template <int NF>
__device__ __forceinline__ void fill_slab(const Tile& tl, const __nv_bfloat16* __restrict__ hn,
                                          int S, unsigned char* slab) {
  constexpr int kChunk = NF % 8 == 0 ? 8 : 4;  // channels a copy
  constexpr int kRunChunks = 2 * NF / kChunk;
  static_assert(NF % kChunk == 0 && NF <= kNf, "whole chunks of a voxel that fits the slab");
  const int P = S + 2, J = 2 * S + 2, pitch = mma_pitch(S) * kVoxelBytes;
  const int warp = (threadIdx.x >> 5) - kComputeWarps, lane = threadIdx.x & 31;
  const int rows1 = kCopies ? 2 * tl.n1 + 2 : 0;
  for (int R = warp; R < (2 * tl.n0 + 2) * rows1; R += kCopyWarps) {
    const int r1 = R % rows1, r0 = R / rows1;
    const int pp0 = tl.i0 + ((r0 + 1) >> 1), pp1 = tl.i1 + ((r1 + 1) >> 1);
    const int blk_off = (((r0 + 1) & 1) * 4 + ((r1 + 1) & 1) * 2) * NF;
    const __nv_bfloat16* src = hn + ((static_cast<size_t>(tl.b) * P + pp0) * P + pp1) * P
                                        * (8 * NF) + blk_off;
    unsigned char* dst = slab + (r0 * kSlabSide + r1) * pitch;
    for (int c = lane; c < kRunChunks * P; c += 32) {
      const int e = c % kRunChunks * kChunk, p2 = c / kRunChunks;
      const int ch = e % NF, j = 2 * p2 - 1 + e / NF;
      if (j < 0 || j >= J) continue;
      unsigned char* d = dst + voxel_half_offset(j, ch >> 3) + (ch & 7) * 2;
      if constexpr (kChunk == 8)
        rf_mma::cp_async16(d, src + p2 * (8 * NF) + e);
      else
        rf_mma::cp_async8(d, src + p2 * (8 * NF) + e);
    }
  }
  rf_mma::cp_async_wait_all();
}

// One warp tile: the four output rows (o0, o1) of packed position
// (i0 + l0, i1 + l1) over the 32 voxels from m0 of the 2x grid's last axis,
// from the slab at shared address `slab`: conv, relu, head, tanh, store.
__device__ __forceinline__ void conv_warp_tile(unsigned slab, const uint4* wfrag,
                                               const float* whs, float bias, int S, int l0,
                                               int l1, int m0, float* __restrict__ row_out) {
  using namespace rf_mma;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pitch = mma_pitch(S) * kVoxelBytes;
  // ldmatrix: lane l gives row l % 8 of matrix l / 8; matrices 0, 1 are
  // voxels 0-7 and 8-15 of channels 0-7, matrices 2, 3 of channels 8-15
  unsigned lane_addr[3];
#pragma unroll
  for (int k2 = 0; k2 < 3; ++k2)
    lane_addr[k2] = slab + (2 * l0 * kSlabSide + 2 * l1) * pitch
                    + voxel_half_offset(m0 + k2 + (lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4);

  float acc[4][2][2][4];  // [output row o0·2 + o1][m16 tile][n8 tile]
#pragma unroll
  for (int i = 0; i < 64; ++i) (&acc[0][0][0][0])[i] = 0.f;
#pragma unroll
  for (int r0 = 0; r0 < 4; ++r0) {
#pragma unroll
    for (int r1 = 0; r1 < 4; ++r1) {
      const unsigned row = (r0 * kSlabSide + r1) * pitch;
#pragma unroll
      for (int k2 = 0; k2 < 3; ++k2) {
        uint32_t a[2][4];
        ldmatrix_x4(a[0], lane_addr[k2] + row);
        ldmatrix_x4(a[1], lane_addr[k2] + row + 16 * kVoxelBytes);
#pragma unroll
        for (int o0 = 0; o0 < 2; ++o0) {
#pragma unroll
          for (int o1 = 0; o1 < 2; ++o1) {
            const int k0 = r0 - o0, k1 = r1 - o1;
            if (k0 < 0 || k0 > 2 || k1 < 0 || k1 > 2) continue;
            const uint4 w = wfrag[((k0 * 3 + k1) * 3 + k2) * 32 + lane];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_m16n8k16(acc[o0 * 2 + o1][mt][0], a[mt], w.x, w.y);
              mma_m16n8k16(acc[o0 * 2 + o1][mt][1], a[mt], w.z, w.w);
            }
          }
        }
      }
    }
  }

  const float wh[4] = {whs[2 * t], whs[2 * t + 1], whs[8 + 2 * t], whs[9 + 2 * t]};
  // relu, round to bf16, head over a lane's channels 2t, 2t+1, 8+2t, 9+2t,
  // then over the quad; lane t of a quad stores output row t of its voxel
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mine = 0.f;
#pragma unroll
      for (int oo = 0; oo < 4; ++oo) {
        const float(&c)[2][4] = acc[oo][mt];
        float z = round_to<__nv_bfloat16>(fmaxf(c[0][2 * half], 0.f)) * wh[0];
        z = fmaf(round_to<__nv_bfloat16>(fmaxf(c[0][2 * half + 1], 0.f)), wh[1], z);
        z = fmaf(round_to<__nv_bfloat16>(fmaxf(c[1][2 * half], 0.f)), wh[2], z);
        z = fmaf(round_to<__nv_bfloat16>(fmaxf(c[1][2 * half + 1], 0.f)), wh[3], z);
        z = quad_sum(z);
        if (oo == t) mine = z;
      }
      const int y = m0 + mt * 16 + half * 8 + g;
      if (y < 2 * S) row_out[(y >> 1) * 8 + t * 2 + (y & 1)] = tanhf(mine + bias);
    }
  }
}

// Persistent, one block on an SM: block x takes tiles x, x + gridDim.x, ….
// The weights are laid out once per block, zero-padded to 16 channels in and
// out where NF < 16, as the slabs' channels are. Warps are specialised: the copy
// warps bring in the next tile's slab while the compute warps run the conv on
// this one (kSlabs = 2), so that a copy held up by the memory system holds up
// no mma; one barrier per tile hands the slabs over. With kSlabs = 1 (a slab
// past half the shared memory) a tile is copied, then computed.
template <int NF, int kSlabs>
__global__ void __launch_bounds__(kMmaThreads, 1)
decoder_tail_mma(const __nv_bfloat16* __restrict__ hn, const float* __restrict__ w2,
                 const float* __restrict__ wh, float bias, int S, int n_tiles,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* wfrag = reinterpret_cast<uint4*>(smem_raw);                  // [27][32]
  float* whs = reinterpret_cast<float*>(smem_raw + kWFragBytes);      // (16,)
  unsigned char* slabs = smem_raw + kWFragBytes + kNf * sizeof(float);  // [6][6][pitch][32 B] each
  const int warp = threadIdx.x >> 5;
  const bool copies = warp >= kComputeWarps;
  const int row_tiles = (2 * S + kWarpVoxels - 1) / kWarpVoxels;

  if constexpr (NF < kNf) {  // the pad channels, which no copy writes, are zero
    uint4* words = reinterpret_cast<uint4*>(slabs);
    for (int i = threadIdx.x; i < kSlabs * slab_bytes(S) / 16; i += kMmaThreads)
      words[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  if (copies) {
    fill_slab<NF>(Tile(blockIdx.x, S), hn, S, slabs);
  } else {
    // the weights in B-fragment order: word r of (tap, lane) is
    // W[tap][ci, ci+1][co], ci = 2t + 8·(r&1), co = 8·(r>>1) + g; rows and
    // columns past NF are zero
    for (int i = threadIdx.x; i < 27 * 32 * 4; i += 32 * kComputeWarps) {
      const int r = i & 3, lane = (i >> 2) & 31, tap = i >> 7;
      const int ci = 2 * (lane & 3) + 8 * (r & 1), co = 8 * (r >> 1) + (lane >> 2);
      const float* wt = w2 + tap * NF * NF;
      const bool in = ci < NF && co < NF;  // NF is even: ci + 1 < NF with ci
      reinterpret_cast<uint32_t*>(wfrag)[i] = rf_mma::pack_bf16(
          in ? wt[ci * NF + co] : 0.f, in ? wt[(ci + 1) * NF + co] : 0.f);
    }
    if (threadIdx.x < kNf) whs[threadIdx.x] = threadIdx.x < NF ? wh[threadIdx.x] : 0.f;
  }
  __syncthreads();  // the first slab and the weights are in place

  int buf = 0;
  for (int index = blockIdx.x; index < n_tiles; index += gridDim.x, buf ^= kSlabs - 1) {
    const int next = index + gridDim.x;
    unsigned char* slab = slabs + buf * slab_bytes(S);
    if (copies) {
      if (kSlabs == 2 && next < n_tiles)
        fill_slab<NF>(Tile(next, S), hn, S, slabs + (buf ^ 1) * slab_bytes(S));
    } else {
      const Tile tl(index, S);
      const unsigned slab_addr = static_cast<unsigned>(__cvta_generic_to_shared(slab));
      for (int wt = warp; kConvs && wt < tl.n0 * tl.n1 * row_tiles; wt += kComputeWarps) {
        const int l1 = wt / row_tiles % tl.n1, l0 = wt / (row_tiles * tl.n1);
        conv_warp_tile(slab_addr, wfrag, whs, bias, S, l0, l1, wt % row_tiles * kWarpVoxels,
                       out + ((static_cast<size_t>(tl.b) * S + tl.i0 + l0) * S + tl.i1 + l1)
                                 * S * 8);
      }
    }
    __syncthreads();  // this slab is free; with two slabs, the next one is in place
    if (kSlabs == 1) {
      if (copies && next < n_tiles) fill_slab<NF>(Tile(next, S), hn, S, slab);
      __syncthreads();
    }
  }
}

template <int NF, int kSlabs>
int launch_mma_slabs(const void* hn, const float* w2, const float* wh, float bias, int b, int s,
                     float* out, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(s, kSlabs);
  auto kernel = decoder_tail_mma<NF, kSlabs>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess
      || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
      || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem))
             != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (s + kTile - 1) / kTile, n_tiles = b * tiles * tiles;
  kernel<<<min(n_tiles, sms * per_sm), kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(hn), w2, wh, bias, s, n_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

// two slabs where they fit (S <= 32), else one (S <= 80)
template <int NF>
int launch_mma(const void* hn, const float* w2, const float* wh, float bias, int b, int s,
               float* out, cudaStream_t stream) {
  if (mma_smem_bytes(s, 2) <= kMaxSmemBytes)
    return launch_mma_slabs<NF, 2>(hn, w2, wh, bias, b, s, out, stream);
  if (mma_smem_bytes(s, 1) <= kMaxSmemBytes)
    return launch_mma_slabs<NF, 1>(hn, w2, wh, bias, b, s, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int NF>
int launch(const void* hn, const float* w2, const float* wh, float bias, int b, int s,
           float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<NF>(s);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decoder_tail<T, NF>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b * s * s, kThreads, smem, stream>>>(static_cast<const T*>(hn), w2, wh, bias, s, out);
  return static_cast<int>(cudaGetLastError());
}

// ---- the general tensor-core instance: bf16, nf up to 32 ----
//
// The tensor-core body at G = 1 or 2 groups of 16 channels (nf padded to
// 16·G with zero channels and weights, as nf 12 is above): a tap is G k16
// steps of input channels, and a warp tile runs its conv once for each of
// the G output groups of 16, re-reading the slab's A fragments, so that its
// sums stay at 64 a thread; the head's partial sums of the groups add up in
// registers. A voxel is 32·G bytes of the slab, its 16-byte chunks
// swizzled so that an ldmatrix's eight voxels fall in eight bank groups.
// The copies take nf's largest granule that divides it (8, 4 or 2
// channels, or one at a time for odd nf). What bounds it beside the
// shipped body: G² times the mma work and B fragments of a tap, and shared
// memory: 27·G²·512 bytes of fragments and 36·pitch·32·G bytes of slab
// allow two slabs at G = 1 and S <= 32 (one up to S = 80), one slab at
// G = 2 and S <= 32; past that the wrapper (ops/decoder_tail.py
// `general_tensor_core`) launches the FMA instance below.

template <int G>
struct GTail {
  static constexpr int kNfp = 16 * G;
  static constexpr int kVoxelBytes = 2 * kNfp;
  static constexpr int kWFragBytes = 27 * G * G * 32 * 16;
  __host__ __device__ static constexpr int slab_bytes(int s) {
    return kSlabSide * kSlabSide * mma_pitch(s) * kVoxelBytes;
  }
  static size_t smem_bytes(int s, int slabs) {
    return kWFragBytes + kNfp * sizeof(float) + static_cast<size_t>(slabs) * slab_bytes(s);
  }
};

// byte offset of 16-byte chunk q (channels 8q..8q+7) of slab voxel j
template <int G>
__device__ __forceinline__ int g_chunk_offset(int j, int q) {
  static_assert(G == 1 || G == 2, "the swizzles below");
  if constexpr (G == 1)
    return j * 32 + ((q ^ ((j >> 2) & 1)) << 4);
  else
    return j * 64 + ((q ^ ((j >> 1) & 3)) << 4);
}

// fill_slab's copies at any nf <= 16·G, in granules of the largest of 8, 4
// and 2 channels that divides nf (one at a time for odd nf, by plain loads
// and stores); the pad channels are never written
template <int G>
__device__ __forceinline__ void fill_slab_g(const Tile& tl, const __nv_bfloat16* __restrict__ hn,
                                            int S, int nf, unsigned char* slab) {
  const int chunk = nf % 8 == 0 ? 8 : nf % 4 == 0 ? 4 : nf % 2 == 0 ? 2 : 1;
  const int run_chunks = 2 * nf / chunk;
  const int P = S + 2, J = 2 * S + 2, pitch = mma_pitch(S) * GTail<G>::kVoxelBytes;
  const int warp = (threadIdx.x >> 5) - kComputeWarps, lane = threadIdx.x & 31;
  const int rows1 = 2 * tl.n1 + 2;
  for (int R = warp; R < (2 * tl.n0 + 2) * rows1; R += kCopyWarps) {
    const int r1 = R % rows1, r0 = R / rows1;
    const int pp0 = tl.i0 + ((r0 + 1) >> 1), pp1 = tl.i1 + ((r1 + 1) >> 1);
    const int blk_off = (((r0 + 1) & 1) * 4 + ((r1 + 1) & 1) * 2) * nf;
    const __nv_bfloat16* src = hn + ((static_cast<size_t>(tl.b) * P + pp0) * P + pp1) * P
                                        * (8 * nf) + blk_off;
    unsigned char* dst = slab + (r0 * kSlabSide + r1) * pitch;
    for (int c = lane; c < run_chunks * P; c += 32) {
      const int e = c % run_chunks * chunk, p2 = c / run_chunks;
      const int ch = e % nf, j = 2 * p2 - 1 + e / nf;
      if (j < 0 || j >= J) continue;
      unsigned char* d = dst + g_chunk_offset<G>(j, ch >> 3) + (ch & 7) * 2;
      const __nv_bfloat16* from = src + static_cast<size_t>(p2) * (8 * nf) + e;
      if (chunk == 8)
        rf_mma::cp_async16(d, from);
      else if (chunk == 4)
        rf_mma::cp_async8(d, from);
      else if (chunk == 2)
        rf_mma::cp_async_zfill<4>(d, from, 4u);
      else
        *reinterpret_cast<__nv_bfloat16*>(d) = *from;
    }
  }
  rf_mma::cp_async_wait_all();
}

// conv_warp_tile at G groups: the output groups one after another, the
// head's partial sums added up across them
template <int G>
__device__ __forceinline__ void conv_warp_tile_g(unsigned slab, const uint4* wfrag,
                                                 const float* whs, float bias, int S, int l0,
                                                 int l1, int m0, float* __restrict__ row_out) {
  using namespace rf_mma;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pitch = mma_pitch(S) * GTail<G>::kVoxelBytes;
  unsigned lane_addr[3][G];
#pragma unroll
  for (int k2 = 0; k2 < 3; ++k2)
#pragma unroll
    for (int ig = 0; ig < G; ++ig)
      lane_addr[k2][ig] = slab + (2 * l0 * kSlabSide + 2 * l1) * pitch
                          + g_chunk_offset<G>(m0 + k2 + (lane & 7) + 8 * ((lane >> 3) & 1),
                                              2 * ig + (lane >> 4));
  float mine[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 1
  for (int og = 0; og < G; ++og) {
    float acc[4][2][2][4];  // [output row o0·2 + o1][m16 tile][n8 tile]
#pragma unroll
    for (int i = 0; i < 64; ++i) (&acc[0][0][0][0])[i] = 0.f;
#pragma unroll
    for (int r0 = 0; r0 < 4; ++r0) {
#pragma unroll
      for (int r1 = 0; r1 < 4; ++r1) {
        const unsigned row = (r0 * kSlabSide + r1) * pitch;
#pragma unroll
        for (int k2 = 0; k2 < 3; ++k2) {
#pragma unroll
          for (int ig = 0; ig < G; ++ig) {
            uint32_t a[2][4];
            ldmatrix_x4(a[0], lane_addr[k2][ig] + row);
            ldmatrix_x4(a[1], lane_addr[k2][ig] + row + 16 * GTail<G>::kVoxelBytes);
#pragma unroll
            for (int o0 = 0; o0 < 2; ++o0) {
#pragma unroll
              for (int o1 = 0; o1 < 2; ++o1) {
                const int k0 = r0 - o0, k1 = r1 - o1;
                if (k0 < 0 || k0 > 2 || k1 < 0 || k1 > 2) continue;
                const int tap = (k0 * 3 + k1) * 3 + k2;
                const uint4 w = wfrag[((tap * G + ig) * G + og) * 32 + lane];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                  mma_m16n8k16(acc[o0 * 2 + o1][mt][0], a[mt], w.x, w.y);
                  mma_m16n8k16(acc[o0 * 2 + o1][mt][1], a[mt], w.z, w.w);
                }
              }
            }
          }
        }
      }
    }
    const float* wg = whs + 16 * og;
    const float wh[4] = {wg[2 * t], wg[2 * t + 1], wg[8 + 2 * t], wg[9 + 2 * t]};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int oo = 0; oo < 4; ++oo) {
          const float(&c)[2][4] = acc[oo][mt];
          float z = round_to<__nv_bfloat16>(fmaxf(c[0][2 * half], 0.f)) * wh[0];
          z = fmaf(round_to<__nv_bfloat16>(fmaxf(c[0][2 * half + 1], 0.f)), wh[1], z);
          z = fmaf(round_to<__nv_bfloat16>(fmaxf(c[1][2 * half], 0.f)), wh[2], z);
          z = fmaf(round_to<__nv_bfloat16>(fmaxf(c[1][2 * half + 1], 0.f)), wh[3], z);
          z = quad_sum(z);
          if (oo == t) mine[mt][half] += z;
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int y = m0 + mt * 16 + half * 8 + g;
      if (y < 2 * S) row_out[(y >> 1) * 8 + t * 2 + (y & 1)] = tanhf(mine[mt][half] + bias);
    }
  }
}

// decoder_tail_mma at G groups and any nf <= 16·G
template <int G, int kSlabs>
__global__ void __launch_bounds__(kMmaThreads, 1)
decoder_tail_mma_g(const __nv_bfloat16* __restrict__ hn, const float* __restrict__ w2,
                   const float* __restrict__ wh, float bias, int S, int nf, int n_tiles,
                   float* __restrict__ out) {
  using L = GTail<G>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* wfrag = reinterpret_cast<uint4*>(smem_raw);                    // [27][G][G][32]
  float* whs = reinterpret_cast<float*>(smem_raw + L::kWFragBytes);      // (16·G,)
  unsigned char* slabs = smem_raw + L::kWFragBytes + L::kNfp * sizeof(float);
  const int warp = threadIdx.x >> 5;
  const bool copies = warp >= kComputeWarps;
  const int row_tiles = (2 * S + kWarpVoxels - 1) / kWarpVoxels;

  {  // the pad channels, which no copy writes, are zero
    uint4* words = reinterpret_cast<uint4*>(slabs);
    for (int i = threadIdx.x; i < kSlabs * L::slab_bytes(S) / 16; i += kMmaThreads)
      words[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  if (copies) {
    fill_slab_g<G>(Tile(blockIdx.x, S), hn, S, nf, slabs);
  } else {
    // word r of (tap, input group ig, output group og, lane) is
    // W[tap][ci, ci+1][co], ci = 16·ig + 2t + 8·(r&1), co = 16·og + 8·(r>>1) + g;
    // zero past nf
    for (int i = threadIdx.x; i < 27 * G * G * 32 * 4; i += 32 * kComputeWarps) {
      const int r = i & 3, lane = (i >> 2) & 31, rest = i >> 7;
      const int og = rest % G, ig = rest / G % G, tap = rest / (G * G);
      const int ci = 16 * ig + 2 * (lane & 3) + 8 * (r & 1);
      const int co = 16 * og + 8 * (r >> 1) + (lane >> 2);
      const float* wt = w2 + tap * nf * nf;
      const float lo = ci < nf && co < nf ? wt[ci * nf + co] : 0.f;
      const float hi = ci + 1 < nf && co < nf ? wt[(ci + 1) * nf + co] : 0.f;
      reinterpret_cast<uint32_t*>(wfrag)[i] = rf_mma::pack_bf16(lo, hi);
    }
    if (threadIdx.x < L::kNfp) whs[threadIdx.x] = threadIdx.x < nf ? wh[threadIdx.x] : 0.f;
  }
  __syncthreads();  // the first slab and the weights are in place

  int buf = 0;
  for (int index = blockIdx.x; index < n_tiles; index += gridDim.x, buf ^= kSlabs - 1) {
    const int next = index + gridDim.x;
    unsigned char* slab = slabs + buf * L::slab_bytes(S);
    if (copies) {
      if (kSlabs == 2 && next < n_tiles)
        fill_slab_g<G>(Tile(next, S), hn, S, nf, slabs + (buf ^ 1) * L::slab_bytes(S));
    } else {
      const Tile tl(index, S);
      const unsigned slab_addr = static_cast<unsigned>(__cvta_generic_to_shared(slab));
      for (int wt = warp; wt < tl.n0 * tl.n1 * row_tiles; wt += kComputeWarps) {
        const int l1 = wt / row_tiles % tl.n1, l0 = wt / (row_tiles * tl.n1);
        conv_warp_tile_g<G>(slab_addr, wfrag, whs, bias, S, l0, l1, wt % row_tiles * kWarpVoxels,
                            out + ((static_cast<size_t>(tl.b) * S + tl.i0 + l0) * S + tl.i1 + l1)
                                      * S * 8);
      }
    }
    __syncthreads();  // this slab is free; with two slabs, the next one is in place
    if (kSlabs == 1) {
      if (copies && next < n_tiles) fill_slab_g<G>(Tile(next, S), hn, S, nf, slab);
      __syncthreads();
    }
  }
}

template <int G, int kSlabs>
int launch_mma_g_slabs(const void* hn, const float* w2, const float* wh, float bias, int b, int s,
                       int nf, float* out, cudaStream_t stream) {
  const size_t smem = GTail<G>::smem_bytes(s, kSlabs);
  auto kernel = decoder_tail_mma_g<G, kSlabs>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess
      || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
      || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem))
             != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (s + kTile - 1) / kTile, n_tiles = b * tiles * tiles;
  kernel<<<min(n_tiles, sms * per_sm), kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(hn), w2, wh, bias, s, nf, n_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

// the general tensor-core instance with two slabs where they fit, else one;
// cudaErrorInvalidValue where one does not
template <int G>
int launch_mma_g(const void* hn, const float* w2, const float* wh, float bias, int b, int s,
                 int nf, float* out, cudaStream_t stream) {
  if (GTail<G>::smem_bytes(s, 2) <= kMaxSmemBytes)
    return launch_mma_g_slabs<G, 2>(hn, w2, wh, bias, b, s, nf, out, stream);
  if (GTail<G>::smem_bytes(s, 1) <= kMaxSmemBytes)
    return launch_mma_g_slabs<G, 1>(hn, w2, wh, bias, b, s, nf, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- the general instance: any nf in 1..64, float32 FMAs ----

constexpr int kGCi = 8;  // input channels a slab (and a weight chunk) holds

template <int NFP>
size_t general_smem_bytes(int s) {
  return sizeof(float) * (27 * kGCi * NFP + NFP + static_cast<size_t>(kGCi) * channel_pitch(s));
}

// One block per packed row (b, i0, i1), as `decoder_tail`; the conv's input
// channels in chunks of kGCi, each thread's NFP sums (columns past nf zero)
// kept in registers across them.
template <typename T, int NFP>
__global__ void __launch_bounds__(kThreads, 1)  // up to 255 registers: NFP sums a thread
decoder_tail_general(const T* __restrict__ hn, const float* __restrict__ w2,
                     const float* __restrict__ wh, float bias, int S, int nf,
                     float* __restrict__ out) {
  static_assert(NFP % 8 == 0, "whole float4 runs of the sums");
  extern __shared__ __align__(16) float smem[];
  const int J = slab_cols(S), CS = channel_pitch(S), P = S + 2;
  float* wsm = smem;                    // (27, kGCi, NFP): tap, c_in of the chunk, c_out
  float* whs = wsm + 27 * kGCi * NFP;   // (NFP,)
  float* slab = whs + NFP;              // slab[c * CS + R * J + j], c < kGCi
  const int blk = blockIdx.x;
  const int i1 = blk % S, i0 = (blk / S) % S, b = blk / (S * S);
  for (int i = threadIdx.x; i < NFP; i += kThreads) whs[i] = i < nf ? wh[i] : 0.f;
  float* row_out =
      out + (static_cast<size_t>(b) * S + i0) * S * S * 8 + static_cast<size_t>(i1) * S * 8;

  for (int v0 = 0; v0 < 8 * S; v0 += kThreads) {  // the same count in every thread
    const int v = v0 + threadIdx.x;
    const bool active = v < 8 * S;
    const int oo = v / (2 * S), y = v % (2 * S);
    const int o0 = oo >> 1, o1 = oo & 1;
    float acc[NFP];
#pragma unroll
    for (int c = 0; c < NFP; ++c) acc[c] = 0.f;
    for (int c0 = 0; c0 < nf; c0 += kGCi) {
      __syncthreads();  // the slab and the weights are free
      for (int i = threadIdx.x; i < 27 * kGCi * NFP; i += kThreads) {
        const int co = i % NFP, ci = c0 + (i / NFP) % kGCi, tap = i / (NFP * kGCi);
        wsm[i] = co < nf && ci < nf ? w2[(tap * nf + ci) * nf + co] : 0.f;
      }
      // as `decoder_tail`'s slab, for channels c0 .. c0 + kGCi - 1: each
      // (r0, r1, p2) reads them in the two channel blocks o_idx = s0·4 +
      // s1·2 + {0, 1}
      for (int i = threadIdx.x; i < 16 * P * 2 * kGCi; i += kThreads) {
        const int e = i % (2 * kGCi), p2 = (i / (2 * kGCi)) % P, R = i / (2 * kGCi * P);
        const int r0 = R >> 2, r1 = R & 3, half = e / kGCi, c = c0 + e % kGCi;
        const int j = 2 * p2 - 1 + half;
        if (j < 0 || j >= J) continue;
        const int pp0 = i0 + ((r0 + 1) >> 1), pp1 = i1 + ((r1 + 1) >> 1);
        const int blk_off = (((r0 + 1) & 1) * 4 + ((r1 + 1) & 1) * 2 + half) * nf;
        const size_t src = (((static_cast<size_t>(b) * P + pp0) * P + pp1) * P + p2) * (8 * nf)
                           + blk_off + c;
        slab[(e % kGCi) * CS + R * J + j] = c < nf ? to_f32(hn[src]) : 0.f;
      }
      __syncthreads();
      if (!active) continue;
      for (int k0 = 0; k0 < 3; ++k0) {
        for (int k1 = 0; k1 < 3; ++k1) {
          const float* srow = slab + ((o0 + k0) * 4 + (o1 + k1)) * J + y;
#pragma unroll
          for (int k2 = 0; k2 < 3; ++k2) {
            const float* wk = wsm + ((k0 * 3 + k1) * 3 + k2) * kGCi * NFP;
#pragma unroll 2
            for (int ci = 0; ci < kGCi; ++ci) {
              const float a = srow[ci * CS + k2];
              const float4* wr = reinterpret_cast<const float4*>(wk + ci * NFP);
#pragma unroll
              for (int q = 0; q < NFP / 4; ++q) {
                const float4 w = wr[q];
                acc[4 * q + 0] = fmaf(a, w.x, acc[4 * q + 0]);
                acc[4 * q + 1] = fmaf(a, w.y, acc[4 * q + 1]);
                acc[4 * q + 2] = fmaf(a, w.z, acc[4 * q + 2]);
                acc[4 * q + 3] = fmaf(a, w.w, acc[4 * q + 3]);
              }
            }
          }
        }
      }
    }
    if (active) {
      float z = 0.f;
#pragma unroll
      for (int c = 0; c < NFP; ++c) z = fmaf(round_to<T>(fmaxf(acc[c], 0.f)), whs[c], z);
      row_out[(y >> 1) * 8 + o0 * 4 + o1 * 2 + (y & 1)] = tanhf(z + bias);
    }
  }
}

template <typename T, int NFP>
int launch_general(const void* hn, const float* w2, const float* wh, float bias, int b, int s,
                   int nf, float* out, cudaStream_t stream) {
  const size_t smem = general_smem_bytes<NFP>(s);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decoder_tail_general<T, NFP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b * s * s, kThreads, smem, stream>>>(static_cast<const T*>(hn), w2, wh, bias, s, nf,
                                                out);
  return static_cast<int>(cudaGetLastError());
}

// the general instance of NFP = nf rounded up to 8
template <typename T>
int dispatch_general(int nf, const void* hn, const float* w2, const float* wh, float bias,
                     int b, int s, float* out, cudaStream_t stream) {
  switch ((nf + 7) / 8) {
    case 1: return launch_general<T, 8>(hn, w2, wh, bias, b, s, nf, out, stream);
    case 2: return launch_general<T, 16>(hn, w2, wh, bias, b, s, nf, out, stream);
    case 3: return launch_general<T, 24>(hn, w2, wh, bias, b, s, nf, out, stream);
    case 4: return launch_general<T, 32>(hn, w2, wh, bias, b, s, nf, out, stream);
    case 5: return launch_general<T, 40>(hn, w2, wh, bias, b, s, nf, out, stream);
    case 6: return launch_general<T, 48>(hn, w2, wh, bias, b, s, nf, out, stream);
    case 7: return launch_general<T, 56>(hn, w2, wh, bias, b, s, nf, out, stream);
    case 8: return launch_general<T, 64>(hn, w2, wh, bias, b, s, nf, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int nf, const void* hn, const float* w2, const float* wh, float bias, int b,
             int s, float* out, cudaStream_t stream) {
  switch (nf) {
    case 4: return launch<T, 4>(hn, w2, wh, bias, b, s, out, stream);
    case 8: return launch<T, 8>(hn, w2, wh, bias, b, s, out, stream);
    case 12:
      if constexpr (std::is_same_v<T, __nv_bfloat16>)
        return launch_mma<12>(hn, w2, wh, bias, b, s, out, stream);
      else
        return launch<T, 12>(hn, w2, wh, bias, b, s, out, stream);
    case 16:
      if constexpr (std::is_same_v<T, __nv_bfloat16>)
        return launch_mma<16>(hn, w2, wh, bias, b, s, out, stream);
      else
        return launch<T, 16>(hn, w2, wh, bias, b, s, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* rf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype 0: float32, 1: bfloat16 (hn). hn (b, s+2, s+2, s+2, 8·nf), w2
// (3, 3, 3, nf, nf) DHWIO float32 (holding values of hn's dtype), wh (nf,)
// float32 likewise, out (b, s, s, s, 8) float32; s >= 1, b >= 1,
// b·s·s < 2^31; hn 16-byte aligned. instance 0, the shipped ones:
// nf ∈ {4, 8, 12, 16}; bf16 with nf ∈ {12, 16} runs the tensor-core body,
// everything else the float32-FMA body. instance 1: the general FMA body,
// any nf in 1..64. instance 2: the general tensor-core body, bf16 with
// nf <= 32 where its slab fits (nf <= 16 at S <= 80, nf <= 32 at S <= 32).
// Returns a cudaError_t value (cudaErrorInvalidValue where a slab exceeds
// the shared memory of a block: S > 80 for the shipped tensor-core and the
// general bodies).
extern "C" int rf_decoder_tail(int dtype, const void* hn, const float* w2, const float* wh,
                               float bias, int b, int s, int nf, int instance, float* out,
                               cudaStream_t stream) {
  if (b < 1 || s < 1 || static_cast<long long>(b) * s * s > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (instance == 2) {
    if (dtype != 1 || nf < 1 || nf > 32) return static_cast<int>(cudaErrorInvalidValue);
    return nf <= 16 ? launch_mma_g<1>(hn, w2, wh, bias, b, s, nf, out, stream)
                    : launch_mma_g<2>(hn, w2, wh, bias, b, s, nf, out, stream);
  }
  if (instance == 1) {
    if (nf < 1 || nf > 64) return static_cast<int>(cudaErrorInvalidValue);
    return dtype == 0 ? dispatch_general<float>(nf, hn, w2, wh, bias, b, s, out, stream)
                      : dispatch_general<__nv_bfloat16>(nf, hn, w2, wh, bias, b, s, out, stream);
  }
  if (dtype == 0) return dispatch<float>(nf, hn, w2, wh, bias, b, s, out, stream);
  return dispatch<__nv_bfloat16>(nf, hn, w2, wh, bias, b, s, out, stream);
}
