// Streaming exact cosine kNN: top-k database rows by q . row for each query,
// without materialising the (Q, N) score matrix.
//
// Replaces the Pallas kernel `_knn_kernel` (with `_topk_by_iteration`) /
// `pallas_exact_knn` of retrieval_fuse_tpu/ops/pallas_knn.py:49, :31 and
// :74 (the serving engine's kNN at large query batches, and the retrieval
// pipeline's `map`). Python side: ops/streaming_knn.py.
//
// Function. Queries (Q, D) and database rows (N, D), both bf16 or both
// float32, 1 <= D <= 256; for each query the k largest q . x in float32 and
// their int32 rows, best first, 1 <= k <= 32, N >= k. Ties go to the lower
// row (select.cuh), so the order is total and any grouping of the
// candidates gives the same list.
//
// Bound on the H100: operations. 2·Q·N·D flops (28.45 GFLOP at Q = 8192,
// N = 27,132, D = 64) at 989 TFLOP/s on the bf16 tensor cores (0.029 ms), or
// three TF32 products of that size at 495 TFLOP/s for float32 rows
// (0.173 ms); the bytes (queries once, the 3.5 / 6.9 MB database once) take
// ~0.01 ms.
//
// Scores on the tensor cores (mma.cuh):
//   - bf16 rows: mma.m16n8k16 with float32 sums. A product of two bf16
//     values is exact in float32, so this is the function of the plain
//     version (float32 products of the bf16 values) and of the JAX engine's
//     dot(..., preferred_element_type=float32) up to summation order.
//   - float32 rows: 3xTF32. Each operand is split into x_hi = tf32(x)
//     (rounded to nearest) and x_lo = x - x_hi; a score is the float32 sum of
//     a_lo·b_hi + a_hi·b_lo + a_hi·b_hi over m16n8k8 steps. The mma reads
//     the top 19 bits of each register: a query's lo is rounded to TF32 once
//     (cvt.rna), a database row's lo is truncated by the mma at every use.
//     Every product is exact in float32 (11 x 11 significant bits). The error
//     against a·b is a_hi·(b_lo - trunc(b_lo)) + (a_lo - tf32(a_lo))·b_hi +
//     a_lo·b_lo, at most 2^-21 + 2^-22 + 2^-22 of |a·b|, so a score is within
//     2^-20 Σ|a_i b_i| <= 9.5e-7 of the exact dot product for unit rows
//     (Cauchy-Schwarz), beside the float32 rounding of the sums that the
//     plain version has too. TF32 stays off everywhere else.
//
// Design.
//   - A block is 4 consumer warps (16 queries each: 64 queries) and one
//     producer warp. A consumer keeps its 16 queries' A fragments in
//     registers for the whole walk (float32 at D > 64, where hi and lo would
//     take more than 64 registers: the raw rows in shared memory, split at
//     each use).
//   - Database tiles of kTN rows go through a ring of shared-memory slots.
//     The producer's first lane fills a slot with tensor copies (TMA,
//     cp.async.bulk.tensor: one request for every 128 bytes of a row's
//     width, completion counted in bytes on the slot's `full` mbarrier) as
//     soon as the four consumers have released it on its `empty` mbarrier.
//     The copy engine swizzles each 128-byte line (16-byte chunk c of line r
//     lands at c ^ (r % 8)), so the 8 rows of an ldmatrix phase fall in 8
//     different bank groups, and it writes zeros past D and past N: the k
//     steps beyond D add nothing and the rows beyond N are masked by index.
//     One request a box, not a row: at the serving shape a bulk copy a row
//     is 3.5 M requests, which held the products to twice this design's
//     time. B fragments are read with ldmatrix straight from the row-major
//     rows: no transpose pass.
//   - Select on the accumulator fragments: a lane of an m16n8 C fragment
//     holds rows g and g + 8 at columns 2t and 2t + 1, and keeps a running
//     top-K list in registers for each of its two rows. A score is first
//     compared with one float per row, the worst of the four lanes'
//     ceil(K/4)-th list entries (exchanged by shuffles after every tile):
//     the quad holds K candidates at least that good, so a score below it is
//     out, and the threshold follows the row's K-th best. The compares of 16
//     columns make a 4-bit mask a row; the lanes then insert what passed,
//     the warp looping as long as any lane has one left: as many insertions
//     as the busiest lane has, where inserting at each score would run one
//     wherever any lane had one. At the end the four lanes of a quad merge
//     their lists (rf::warp_merge, width 4).
//   - Filling the card: the N rows are split into S slices (whole tiles)
//     over the S blocks of a thread-block cluster (grid Q/64 x S). Each
//     block leaves its 64 merged lists in shared memory; after a cluster
//     barrier, block r merges its share of the 64 rows from all S blocks'
//     lists through distributed shared memory and writes them. One launch,
//     no second pass, no atomics. S is picked from the SM count: enough
//     blocks for kBlocksPerSm on every SM, up to kMaxSplits and one tile a
//     slice.
//   - Domain: D is rounded up to a bucket of k steps (templated: the A
//     fragments and the k loop unroll), k to the next list size (1-8, 16,
//     32; the kernel writes the first k of the list, which is the top k, the
//     order being total). Q and N need not be tile multiples: queries past
//     Q are zero and not written. The tensor map needs a row pitch of a
//     multiple of 16 bytes; it reads the D columns of each row and fills
//     the rest of a box with zeros, so a database padded once to that pitch
//     (ops/streaming_knn.knn_rows) is read in place.
//
// tools/torch_port_kernel_probe.py --probe knn builds other ring depths
// (-DRF_PROBE_KNN_SLOTS), tile heights (-DRF_PROBE_KNN_TILE), forced split
// counts (-DRF_PROBE_KNN_SPLITS), blocks wanted an SM
// (-DRF_PROBE_KNN_BLOCKS_PER_SM) and the products without the select
// (-DRF_PROBE_KNN_NO_SELECT, outputs meaningless), each with
// -DRF_PROBE_KNN_SERVING_ONLY: D = 64 and k in {4, 8} alone, the other
// shapes refused. Measured: PERF.md.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "select.cuh"

namespace {

namespace cg = cooperative_groups;

#ifndef RF_PROBE_KNN_SLOTS
#define RF_PROBE_KNN_SLOTS 3
#endif
#ifndef RF_PROBE_KNN_TILE
#define RF_PROBE_KNN_TILE 64
#endif
#ifndef RF_PROBE_KNN_BLOCKS_PER_SM
#define RF_PROBE_KNN_BLOCKS_PER_SM 3
#endif

constexpr int kWarps = 4;                     // consumer warps, 16 queries each
constexpr int kThreads = 32 * (kWarps + 1);   // + the producer warp
constexpr int kTQ = 16 * kWarps;              // queries per block
constexpr int kTN = RF_PROBE_KNN_TILE;        // database rows per ring slot
constexpr int kMaxSlots = RF_PROBE_KNN_SLOTS;
constexpr int kMaxSplits = 8;                 // the portable cluster size
constexpr int kBlocksPerSm = RF_PROBE_KNN_BLOCKS_PER_SM;
constexpr int kBarBytes = 128;                // the ring's mbarriers
constexpr int kLine = 128;                    // bytes of a staged row in one box
constexpr int kBoxBytes = kTN * kLine;        // one tensor copy
constexpr int kAlign = 1024;                  // the 128-byte swizzle's period
constexpr size_t kMaxSmemBytes = 232448;      // per block on sm_90
constexpr int kMaxDim = 256;
constexpr int kMaxK = 32;
static_assert(kTN % 16 == 0 && kTN <= 256 && kMaxSlots >= 2 && 2 * kMaxSlots * 8 <= kBarBytes,
              "ring shape");

using bf16 = __nv_bfloat16;

// 32-byte k steps of a staged row: 16 bf16 (one m16n8k16) or 8 float32 (one
// m16n8k8 TF32 step); four of them a 128-byte box
template <typename T>
constexpr int kStepElems = 32 / static_cast<int>(sizeof(T));

// float32 A fragments live in shared memory past this many k steps (hi and
// lo of 8 steps are 64 registers)
constexpr int kMaxRegSteps = 8;

template <typename T, int KS>
constexpr bool kASmem = std::is_same_v<T, float> && KS > kMaxRegSteps;

// one box (kTN rows x 128 bytes at column element c0, row r0) of the tensor
// map's 2-D view into shared memory, reported to `bar`; rows past N and
// columns past D arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int r0,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(rf_mma::shared_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(rf_mma::shared_address(bar)), "r"(c0), "r"(r0)
      : "memory");
}

// the query side, once a walk: hi = tf32(x), lo = tf32(x - hi), both rounded
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rf_mma::to_tf32(x);
  lo = rf_mma::to_tf32(x - __uint_as_float(hi));  // x - hi is exact
}

// the database side, at every use: hi rounded to nearest (ties away) by
// integer operations, which is cvt.rna.tf32's result for finite values below
// 2^128 at a quarter of the cost; lo = x - hi exact, handed to the mma raw,
// which reads its top 19 bits (a truncation, |error| <= 2^-10 |lo|)
__device__ __forceinline__ void split_tf32_fast(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// acc += a . b over one TF32 k step, three products, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t b0, uint32_t b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32_fast(b0, h0, l0);
  split_tf32_fast(b1, h1, l1);
  rf_mma::mma_m16n8k8_tf32(acc, al, h0, h1);
  rf_mma::mma_m16n8k8_tf32(acc, ah, l0, l1);
  rf_mma::mma_m16n8k8_tf32(acc, ah, h0, h1);
}

// query element (row, col), zero outside (q, d)
template <typename T>
__device__ __forceinline__ T query_elem(const T* __restrict__ x, int row, int col, int q, int d) {
  if (row < q && col < d) return x[static_cast<size_t>(row) * d + col];
  if constexpr (std::is_same_v<T, float>) return 0.f;
  else return __ushort_as_bfloat16(0);
}

// the boxes of a staged row of KS k steps
template <int KS>
constexpr int kBoxes = (KS * 32 + kLine - 1) / kLine;

// grid (ceil(Q / kTQ), S); S > 1: the S blocks of a column are a cluster.
// KS: 32-byte k steps a staged row (D rounded up); KL: the list size.
template <typename T, int KS, int KL>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const __grid_constant__ CUtensorMap db_map, const T* __restrict__ queries,
           float* __restrict__ out_v, int* __restrict__ out_i, int q, int n, int d, int k,
           int slots) {
  constexpr int kSlotBytes = kBoxes<KS> * kBoxBytes;
  constexpr bool kF32 = std::is_same_v<T, float>;
  extern __shared__ unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxSlots;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kBarBytes + kAlign - 1) & ~uintptr_t(kAlign - 1));
  float* a_smem = reinterpret_cast<float*>(ring + static_cast<size_t>(slots) * kSlotBytes);
  float* part_v = a_smem + (kASmem<T, KS> ? kWarps * KS * 4 * 32 : 0);
  int* part_i = reinterpret_cast<int*>(part_v + kTQ * KL);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int splits = gridDim.y, split = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int tiles = (n + kTN - 1) / kTN;
  const int tile0 = split * tiles / splits, ntiles = (split + 1) * tiles / splits - tile0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      rf_mma::mbar_init(full + s, 1);          // the producer's arrival and the bytes
      rf_mma::mbar_init(empty + s, kWarps);    // one arrival a consumer warp
    }
    rf_mma::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    // producer: tile j of the slice goes to slot j % slots
    if (lane == 0) {
      for (int j = 0; j < ntiles; ++j) {
        const int slot = j % slots;
        if (j >= slots) rf_mma::mbar_wait(empty + slot, ((j / slots) - 1) & 1);
        rf_mma::mbar_arrive_expect_tx(full + slot, kSlotBytes);
        for (int b = 0; b < kBoxes<KS>; ++b)
          tma_load_2d(ring + static_cast<size_t>(slot) * kSlotBytes + b * kBoxBytes, &db_map,
                      b * (kLine / static_cast<int>(sizeof(T))), (tile0 + j) * kTN, full + slot);
      }
    }
    __syncwarp();
  } else {
    // consumer: rows row_g and row_g + 8 of this warp's 16 queries
    const int row_g = q0 + warp * 16 + g;
    constexpr int kRegSteps = kASmem<T, KS> ? 1 : KS;
    uint32_t ah[kRegSteps][4], al[kF32 ? kRegSteps : 1][4];
    float* a_warp = a_smem + warp * KS * 4 * 32;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      if constexpr (kF32) {
        const int c = s * 8 + t;
        const float x[4] = {query_elem(queries, row_g, c, q, d),
                            query_elem(queries, row_g + 8, c, q, d),
                            query_elem(queries, row_g, c + 4, q, d),
                            query_elem(queries, row_g + 8, c + 4, q, d)};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (kASmem<T, KS>) a_warp[(s * 4 + r) * 32 + lane] = x[r];
          else split_tf32(x[r], ah[s][r], al[s][r]);
        }
      } else {
        const int c = s * 16 + 2 * t;
        ah[s][0] = rf_mma::pack_bf16(query_elem(queries, row_g, c, q, d),
                                     query_elem(queries, row_g, c + 1, q, d));
        ah[s][1] = rf_mma::pack_bf16(query_elem(queries, row_g + 8, c, q, d),
                                     query_elem(queries, row_g + 8, c + 1, q, d));
        ah[s][2] = rf_mma::pack_bf16(query_elem(queries, row_g, c + 8, q, d),
                                     query_elem(queries, row_g, c + 9, q, d));
        ah[s][3] = rf_mma::pack_bf16(query_elem(queries, row_g + 8, c + 8, q, d),
                                     query_elem(queries, row_g + 8, c + 9, q, d));
      }
    }
    __syncwarp();  // a_warp is written (float32 at D > 64)

    // acc += this warp's A . the staged rows' B over k step s
    auto step = [&](float (&acc)[4], int s, uint32_t b0, uint32_t b1) {
      if constexpr (!kF32) {
        rf_mma::mma_m16n8k16(acc, ah[s], b0, b1);
      } else if constexpr (kASmem<T, KS>) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(a_warp[(s * 4 + r) * 32 + lane], h[r], l[r]);
        mma_3xtf32(acc, h, l, b0, b1);
      } else {
        mma_3xtf32(acc, ah[s], al[s], b0, b1);
      }
    };

    // ldmatrix: lane l addresses line l % 8 of a group of 8 staged rows, at
    // 16-byte chunk 4c + l / 8 of the row (two k steps of 64-byte group c;
    // word t of line g of matrix m is then the B register of step 2c + m / 2),
    // which the swizzle put at chunk (that % 8) ^ (l % 8) of its box's line
    constexpr int kGroups = (KS + 1) / 2;
    unsigned chunk_off[kGroups];
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      const int chunk = 4 * c + (lane >> 3);
      chunk_off[c] = (chunk / 8) * kBoxBytes + (((chunk % 8) ^ (lane & 7)) << 4);
    }
    const unsigned lane_line = rf_mma::shared_address(ring) + (lane & 7) * kLine;

    rf::TopK<KL> best[2];  // rows row_g and row_g + 8
    best[0].init();
    best[1].init();
    // per row, the worst of the quad's four kJ-th list entries (kJ =
    // ceil(KL / 4)): the four lanes hold 4·kJ >= KL candidates at least as
    // good, so a candidate that does not beat it cannot be in the row's top
    // k. It follows the row's KL-th best closely. Refreshed every tile.
    constexpr int kJ = (KL + 3) / 4;
    float thr_v[2] = {-INFINITY, -INFINITY};
    // row R as a type, so that best[R] and thr_v[R] index registers
    using Row0 = std::integral_constant<int, 0>;
    using Row1 = std::integral_constant<int, 1>;
    // the 4 scores of row R in two n8 tiles (columns c, c + 1, c + 8, c + 9
    // from c = col): a bit for each that reaches the threshold, then every
    // lane inserts its own, the warp looping as long as any lane has one
    auto select = [&](auto row, const float (&acc)[2][4], int col, unsigned valid) {
      constexpr int r = decltype(row)::value;
      const float s0 = acc[0][2 * r], s1 = acc[0][2 * r + 1];
      const float s2 = acc[1][2 * r], s3 = acc[1][2 * r + 1];
      unsigned bits = (s0 >= thr_v[r] ? 1u : 0u) | (s1 >= thr_v[r] ? 2u : 0u)
                      | (s2 >= thr_v[r] ? 4u : 0u) | (s3 >= thr_v[r] ? 8u : 0u);
      bits &= valid;
      while (__any_sync(rf::kFullMask, bits != 0)) {
        if (bits != 0) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const float v = b == 0 ? s0 : b == 1 ? s1 : b == 2 ? s2 : s3;
          best[r].push(v, col + (b & 1) + 8 * (b >> 1));
        }
      }
    };
    float probe_sum = 0.f;  // -DRF_PROBE_KNN_NO_SELECT

    for (int j = 0; j < ntiles; ++j) {
      const int slot = j % slots;
      rf_mma::mbar_wait(full + slot, (j / slots) & 1);
      const unsigned base = lane_line + slot * kSlotBytes;
      const int col0 = (tile0 + j) * kTN + 2 * t;
      const bool full_tile = (tile0 + j + 1) * kTN <= n;  // else mask columns >= n
#pragma unroll
      for (int p = 0; p < kTN / 16; ++p) {  // two n8 tiles: rows 16p.. and 16p + 8..
        float acc[2][4] = {};
        const unsigned rows = base + p * 16 * kLine;
#pragma unroll
        for (int c = 0; c < KS / 2; ++c) {
          uint32_t b0[4], b1[4];
          rf_mma::ldmatrix_x4(b0, rows + chunk_off[c]);
          rf_mma::ldmatrix_x4(b1, rows + 8 * kLine + chunk_off[c]);
          step(acc[0], 2 * c, b0[0], b0[1]);
          step(acc[1], 2 * c, b1[0], b1[1]);
          step(acc[0], 2 * c + 1, b0[2], b0[3]);
          step(acc[1], 2 * c + 1, b1[2], b1[3]);
        }
        if constexpr (KS % 2 == 1) {
          uint32_t b0[2], b1[2];
          rf_mma::ldmatrix_x2(b0, rows + chunk_off[KS / 2]);
          rf_mma::ldmatrix_x2(b1, rows + 8 * kLine + chunk_off[KS / 2]);
          step(acc[0], KS - 1, b0[0], b0[1]);
          step(acc[1], KS - 1, b1[0], b1[1]);
        }
#ifdef RF_PROBE_KNN_NO_SELECT  // the products alone: a sum in place of the select
        probe_sum += acc[0][0] + acc[0][1] + acc[0][2] + acc[0][3] + acc[1][0] + acc[1][1]
                     + acc[1][2] + acc[1][3];
        continue;
#endif
        const int col = col0 + 16 * p;
        unsigned valid = 0xfu;  // columns past N (the last tile only) are masked
        if (!full_tile)
          valid = (col < n ? 1u : 0u) | (col + 1 < n ? 2u : 0u) | (col + 8 < n ? 4u : 0u)
                  | (col + 9 < n ? 8u : 0u);
        select(Row0{}, acc, col, valid);
        select(Row1{}, acc, col, valid);
      }
      __syncwarp();  // every lane has read the slot
      if (lane == 0) rf_mma::mbar_arrive(empty + slot);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tv = best[r].v[kJ - 1];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) tv = fminf(tv, __shfl_xor_sync(rf::kFullMask, tv, off));
        thr_v[r] = tv;  // a value tie passes and meets push's exact test
      }
    }

    if (probe_sum != 0.f) best[0].push(probe_sum, 0);  // keeps the probe's sums alive
    // the quad's four lists of each row -> one; lane t = 0 keeps row g's,
    // t = 1 row g + 8's
    float mv[2][KL];
    int mi[2][KL];
    rf::warp_merge<KL>(best[0], 4, mv[0], mi[0]);
    rf::warp_merge<KL>(best[1], 4, mv[1], mi[1]);
    if (t < 2) {
      const int local = warp * 16 + g + 8 * t, row = q0 + local;
#pragma unroll
      for (int e = 0; e < KL; ++e) {
        const float ev = t == 0 ? mv[0][e] : mv[1][e];  // no dynamic register index
        const int ei = t == 0 ? mi[0][e] : mi[1][e];
        if (splits > 1) {
          part_v[local * KL + e] = ev;
          part_i[local * KL + e] = ei;
        } else if (row < q && e < k) {
          out_v[static_cast<size_t>(row) * k + e] = ev;
          out_i[static_cast<size_t>(row) * k + e] = ei;
        }
      }
    }
  }

  if (splits > 1) {
    // block r of the cluster merges its share of the 64 rows from all S
    // blocks' sorted lists: k rounds, each taking the best head
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's lists are in its shared memory
    const int share = (kTQ + splits - 1) / splits;
    const int first = static_cast<int>(cluster.block_rank()) * share;
    for (int local = first + threadIdx.x; local < min(kTQ, first + share); local += kThreads) {
      const int row = q0 + local;
      if (row >= q) continue;
      int head[kMaxSplits] = {};
      for (int e = 0; e < k; ++e) {
        float bv = -INFINITY;
        int bi = INT_MAX, bs = 0;
        for (int s = 0; s < splits; ++s) {
          const float v = cluster.map_shared_rank(part_v, s)[local * KL + head[s]];
          const int i = cluster.map_shared_rank(part_i, s)[local * KL + head[s]];
          if (rf::better(v, i, bv, bi)) {
            bv = v;
            bi = i;
            bs = s;
          }
        }
        ++head[bs];
        out_v[static_cast<size_t>(row) * k + e] = bv;
        out_i[static_cast<size_t>(row) * k + e] = bi;
      }
    }
    cluster.sync();  // no block leaves while another still reads its lists
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found)
            == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T, int KS, int KL>
int launch(const void* queries, const void* db, float* v, int* i, int q, int n, int d, int ld,
           int k,
           cudaStream_t stream) {
  constexpr size_t kSlotBytes = static_cast<size_t>(kBoxes<KS>) * kBoxBytes;
  constexpr size_t kABytes = kASmem<T, KS> ? kWarps * KS * 4 * 32 * sizeof(float) : 0;
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  const int qblocks = (q + kTQ - 1) / kTQ, tiles = (n + kTN - 1) / kTN;
#ifdef RF_PROBE_KNN_SPLITS
  int splits = RF_PROBE_KNN_SPLITS;
#else
  int splits = 1;
  while (splits < kMaxSplits && static_cast<long long>(qblocks) * splits
                                    < static_cast<long long>(kBlocksPerSm) * sms)
    ++splits;
#endif
  splits = splits < tiles ? splits : tiles;  // every slice at least one tile
  const size_t part_bytes = splits > 1 ? static_cast<size_t>(kTQ) * KL * 8 : 0;
  int slots = kMaxSlots;
  auto smem = [&](int sl) {
    return kBarBytes + kAlign + sl * kSlotBytes + kABytes + part_bytes;
  };
  while (slots > 2 && smem(slots) > kMaxSmemBytes) --slots;
  if (smem(slots) > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);

  // the database as a 2-D tensor (d columns, n rows, ld elements apart),
  // boxes of 128 bytes x kTN rows, swizzled by 128 bytes, zeros outside
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kLine / sizeof(T)), kTN};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(db), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = knn_kernel<T, KS, KL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem(slots)));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = splits;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(qblocks, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem(slots);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, map, static_cast<const T*>(queries),
                                             v, i, q, n, d, k, slots));
}

// the list size for k: 1-8, 16 or 32
template <typename T, int KS>
int dispatch_k(const void* qr, const void* db, float* v, int* i, int q, int n, int d, int ld,
           int k,
               cudaStream_t s) {
#ifdef RF_PROBE_KNN_SERVING_ONLY  // probe builds: the serving lists alone, in seconds
  if (k == 4) return launch<T, KS, 4>(qr, db, v, i, q, n, d, ld, k, s);
  if (k == 8) return launch<T, KS, 8>(qr, db, v, i, q, n, d, ld, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
#else
  switch (k <= 8 ? k : k <= 16 ? 16 : 32) {
    case 1: return launch<T, KS, 1>(qr, db, v, i, q, n, d, ld, k, s);
    case 2: return launch<T, KS, 2>(qr, db, v, i, q, n, d, ld, k, s);
    case 3: return launch<T, KS, 3>(qr, db, v, i, q, n, d, ld, k, s);
    case 4: return launch<T, KS, 4>(qr, db, v, i, q, n, d, ld, k, s);
    case 5: return launch<T, KS, 5>(qr, db, v, i, q, n, d, ld, k, s);
    case 6: return launch<T, KS, 6>(qr, db, v, i, q, n, d, ld, k, s);
    case 7: return launch<T, KS, 7>(qr, db, v, i, q, n, d, ld, k, s);
    case 8: return launch<T, KS, 8>(qr, db, v, i, q, n, d, ld, k, s);
    case 16: return launch<T, KS, 16>(qr, db, v, i, q, n, d, ld, k, s);
    default: return launch<T, KS, 32>(qr, db, v, i, q, n, d, ld, k, s);
  }
#endif
}

// the k steps for d, rounded up to a bucket: bf16 steps of 16 values
// (D <= 16, 32, 64, 96, 128, 192, 256), float32 steps of 8 (the same D)
template <typename T>
int dispatch(const void* qr, const void* db, float* v, int* i, int q, int n, int d, int ld,
           int k,
             cudaStream_t s) {
  const int steps = (d + kStepElems<T> - 1) / kStepElems<T>;
#ifdef RF_PROBE_KNN_SERVING_ONLY  // D = 64 alone
  if (steps != 64 / kStepElems<T>) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_k<T, 64 / kStepElems<T>>(qr, db, v, i, q, n, d, ld, k, s);
#else
  if constexpr (std::is_same_v<T, bf16>) {
    if (steps <= 1) return dispatch_k<T, 1>(qr, db, v, i, q, n, d, ld, k, s);
    if (steps <= 2) return dispatch_k<T, 2>(qr, db, v, i, q, n, d, ld, k, s);
    if (steps <= 4) return dispatch_k<T, 4>(qr, db, v, i, q, n, d, ld, k, s);
    if (steps <= 6) return dispatch_k<T, 6>(qr, db, v, i, q, n, d, ld, k, s);
    if (steps <= 8) return dispatch_k<T, 8>(qr, db, v, i, q, n, d, ld, k, s);
    if (steps <= 12) return dispatch_k<T, 12>(qr, db, v, i, q, n, d, ld, k, s);
    return dispatch_k<T, 16>(qr, db, v, i, q, n, d, ld, k, s);
  } else {
    if (steps <= 2) return dispatch_k<T, 2>(qr, db, v, i, q, n, d, ld, k, s);
    if (steps <= 4) return dispatch_k<T, 4>(qr, db, v, i, q, n, d, ld, k, s);
    if (steps <= 8) return dispatch_k<T, 8>(qr, db, v, i, q, n, d, ld, k, s);
    if (steps <= 12) return dispatch_k<T, 12>(qr, db, v, i, q, n, d, ld, k, s);
    if (steps <= 16) return dispatch_k<T, 16>(qr, db, v, i, q, n, d, ld, k, s);
    if (steps <= 24) return dispatch_k<T, 24>(qr, db, v, i, q, n, d, ld, k, s);
    return dispatch_k<T, 32>(qr, db, v, i, q, n, d, ld, k, s);
  }
#endif
}

}  // namespace

// dtype 0: float32 (3xTF32), 1: bfloat16. queries (q, d) row-major; db n
// rows of d values, ld values apart, 16-byte aligned with ld·sizeof(dtype) a
// multiple of 16 (the tensor map's row pitch) -> sims (q, k) float32 and
// idx (q, k) int32, best first. 1 <= d <= ld, d <= 256, 1 <= k <= 32,
// q >= 1, n >= k. One kernel launch. Returns a cudaError_t value.
extern "C" int rf_knn(int dtype, const void* queries, const void* db, float* sims, int* idx,
                      int q, int n, int d, int ld, int k, cudaStream_t stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || d < 1 || d > kMaxDim || ld < d || k < 1 || k > kMaxK
      || q < 1 || n < k || (static_cast<long long>(ld) * elem) % 16 != 0
      || reinterpret_cast<uintptr_t>(db) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 0 ? dispatch<float>(queries, db, sims, idx, q, n, d, ld, k, stream)
                    : dispatch<bf16>(queries, db, sims, idx, q, n, d, ld, k, stream);
}
