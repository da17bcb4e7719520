// The general instances of the three attention kernels: every row width
// F in 1..1024, every K in 1..32 and, for the gathered kernels, every T in
// 1..512 rows a bank tile, with hidden 128 and C 32 as in attention.cuh.
// The shipped shapes (F in {32, 64, 96, 128} with T = 64 and K <= 8) keep
// attention.cuh's instances; the wrappers (ops/patch_attention.py) send
// every other shape here, and each kernel's C entry point launches what
// its `general` flag names. The function is attention.cuh's, with the same
// roundings, the first-maximum argmax and the float32 max-subtracted
// softmax; only the loops are sized at run time.
//
// What changes with the shape, and what this code does about it:
//   - F not a multiple of 32. A zero row of fc0 times a zero input column
//     adds an exact 0 to a float32 sum, so layer 0 runs at Fp = F rounded
//     up to 32: the wrapper's `_pack` writes fc0 with Fp - F zero rows, and
//     the row loads here are masked (zero past F and past the tile's valid
//     rows). Rows whose byte width is no multiple of 16 (F % 8 != 0 in
//     bf16) are read 2 bytes at a time, the rest as attention.cuh reads
//     them. The output is written at the true F only.
//   - F past what shared memory holds. attention.cuh keeps theta and phi
//     whole in shared memory, 4·(128·F + 2·128² + 128·32) bytes, which passes
//     a block's 232,448 at F ≈ 160. Here layers 1-3 of both MLPs stay
//     resident (2 x 73,728 bytes, in B-fragment order, whatever F), and
//     layer 0 is read by each warp from global memory, where the wrapper
//     has laid it out in the same B-fragment order (one 16-byte load a lane
//     for a k16 step of two n8 tiles): 2·128·Fp bytes a row block, which L2
//     (50 MB) and L1 serve, since every warp of the card reads the same
//     weights. Layer 0 walks the row in chunks of 32 columns (two k16
//     steps), the next chunk's loads in flight under this one's mma.
//   - K past 8. Scores and blend weights are kept in buffers of 32 a row
//     (the float32 body's per tile, the bf16 body's per warp).
//   - T other than 64. The gathered kernels work on the rows of one query
//     at a time, in slices of 16 rows (bf16: a warp's m16 tile) or tiles of
//     64 (float32: a block), the last one short; candidate k of such a
//     slice is a contiguous run of bank tile idx[q, k].
//   - The float32 body's buffers hold rows of at most kH floats, so its
//     layer 0 takes the row in chunks of 128 columns, accumulating in
//     registers across them.
// What bounds the general bf16 body on an H100 is layer 0's weight reads:
// a warp reads 2·128·Fp bytes of fragments per 16 rows and MLP from L1/L2
// (at F = 192, 48 KB: one 16-byte load a lane per two mma), beside the
// resident layers' shared-memory reads that hold attention.cuh's body.
// Measured times: PERF.md.
//
// gathered_attention_v1.cu's general instance stages rather than loads:
// its bf16 body copies each lane's two 16-byte runs of a chunk into a
// per-warp double buffer in shared memory with cp.async (zero-filled where
// masked), one chunk ahead of the mma that reads them, and its float32 body
// copies each 128-column chunk of a tile's rows into the activation buffer
// with cp.async. Its shipped instance stages whole (64, F) candidate tiles
// by bulk copies; a general tile (T·F values, up to 1 MB) has no such room.

#pragma once

#include "attention.cuh"

namespace rf_attention {

constexpr int kGMaxF = 1024;  // row width
constexpr int kGMaxK = 32;    // candidates
constexpr int kGMaxT = 512;   // rows of a gathered tile
constexpr int kGLd = kGMaxK + 1;  // a row's scores (then weights) and its switch, bf16 body
constexpr int kHidWords = 2 * kLayerWords + kH * kC / 2;  // layers 1-3's fragments, 32-bit words

__host__ __device__ constexpr int pad32(int f) { return (f + 31) / 32 * 32; }

// ---- row sources ----
//
// Rows [0, n) of a slice or tile: x row i at x + i·F, candidate k's row i at
// cand(k) + i·stride; the slice starts at row `row0` of the output and of
// the selections.

// patch_attention: candidate k of row i is p[i, k]
template <typename E>
struct GStridedRows {
  const E* x;
  const E* cand0;
  size_t k_step, stride;
  int n, K;
  size_t row0;
  __device__ __forceinline__ const E* cand(int k) const { return cand0 + k * k_step; }
};

// the gathered kernels: candidate k is bank tile idx[k], from element `first`
template <typename E>
struct GBankRows {
  const E* x;
  const E* bank;
  const int* idx;
  size_t tile_elems, first;
  int n, K;
  size_t row0, stride;
  __device__ __forceinline__ const E* cand(int k) const {
    return bank + static_cast<size_t>(idx[k]) * tile_elems + first;
  }
};

// the (n, K, F) candidates of patch_attention in slices of ROWS rows
template <typename E, int ROWS>
struct PatchSlices {
  const E* x;
  const E* p;
  int n, K, F;
  __host__ __device__ long long count() const { return (n + ROWS - 1) / ROWS; }
  __device__ GStridedRows<E> operator()(long long s) const {
    const size_t r0 = static_cast<size_t>(s) * ROWS;
    return {x + r0 * F, p + r0 * K * F, static_cast<size_t>(F), static_cast<size_t>(K) * F,
            min(ROWS, static_cast<int>(n - r0)), K, r0};
  }
};

// the Q queries of T rows of the gathered kernels, each in slices of ROWS rows
template <typename E, int ROWS>
struct BankSlices {
  const E* xt;
  const E* bank;
  const int* idx;
  int Q, T, K, F;
  __host__ __device__ int per_query() const { return (T + ROWS - 1) / ROWS; }
  __host__ __device__ long long count() const {
    return static_cast<long long>(Q) * per_query();
  }
  __device__ GBankRows<E> operator()(long long s) const {
    const size_t q = s / per_query();
    const int t0 = static_cast<int>(s % per_query()) * ROWS;
    const size_t row0 = q * T + t0;
    return {xt + row0 * F, bank, idx + q * K, static_cast<size_t>(T) * F,
            static_cast<size_t>(t0) * F, min(ROWS, T - t0), K, row0, static_cast<size_t>(F)};
  }
};

// ---- bf16 on the tensor cores ----

// 8 bf16 of a row from column col, zero past F or for an invalid row: one
// 16-byte load where a row is whole 16-byte runs (F % 8 == 0), else eight
// 2-byte ones
__device__ __forceinline__ uint4 load_run(const __nv_bfloat16* row, int col, int F, bool valid) {
  if (!valid || col >= F) return make_uint4(0u, 0u, 0u, 0u);
  if ((F & 7) == 0) return __ldg(reinterpret_cast<const uint4*>(row + col));
  const unsigned short* src = reinterpret_cast<const unsigned short*>(row + col);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = col + 2 * e < F ? __ldg(src + 2 * e) : 0u;
    const uint32_t hi = col + 2 * e + 1 < F ? __ldg(src + 2 * e + 1) : 0u;
    w[e] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A lane's two runs of chunk c (rows g and g + 8, columns 32c + 8t ..+7)
struct RunPair {
  uint4 r[2];
};

__device__ __forceinline__ RunPair load_chunk(const __nv_bfloat16* base, size_t stride, int n,
                                              int c, int F, int lane) {
  const int g = lane >> 2, t = lane & 3;
  RunPair rp;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    rp.r[h] = load_run(base + row * stride, 32 * c + 8 * t, F, row < n);
  }
  return rp;
}

// The staged counterpart (gathered_attention_v1.cu): the same two runs into
// this lane's two 16-byte words of a slot, by cp.async (zero-filled where
// masked) where rows are whole 16-byte runs, else by plain loads and stores
__device__ __forceinline__ void stage_chunk(uint4* slot, const __nv_bfloat16* base,
                                            size_t stride, int n, int c, int F, int lane) {
  const int g = lane >> 2, t = lane & 3, col = 32 * c + 8 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if ((F & 7) == 0) {
      const bool ok = row < n && col < F;
      rf_mma::cp_async_zfill<16>(slot + h, ok ? base + row * stride + col : base, ok ? 16u : 0u);
    } else {
      slot[h] = load_run(base + row * stride, col, F, row < n);
    }
  }
}

// acc (16 rows x 128) = the rows at base (stride apart, n valid, F values,
// chunks = Fp / 32) @ layer 0, whose fragments are at w0 in global memory.
// kStaged: the rows pass through `slots` (this lane's [2][2] words).
template <bool kStaged>
__device__ __forceinline__ void layer0_general(const __nv_bfloat16* base, size_t stride, int n,
                                               int F, int chunks, const uint4* __restrict__ w0,
                                               int lane, uint4* slots,
                                               float (&acc)[kH / 8][4]) {
#pragma unroll
  for (int j = 0; j < kH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  RunPair cur, nxt;
  if constexpr (kStaged) {
    stage_chunk(slots, base, stride, n, 0, F, lane);
    rf_mma::cp_async_commit();
  } else {
    cur = load_chunk(base, stride, n, 0, F, lane);
  }
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    if constexpr (kStaged) {
      if (c + 1 < chunks) {
        stage_chunk(slots + 2 * ((c + 1) & 1), base, stride, n, c + 1, F, lane);
        rf_mma::cp_async_commit();
        rf_mma::cp_async_wait<1>();
      } else {
        rf_mma::cp_async_wait<0>();
      }
      const uint4* mine = slots + 2 * (c & 1);
      cur.r[0] = rf_mma::load_shared16(mine);
      cur.r[1] = rf_mma::load_shared16(mine + 1);
    } else if (c + 1 < chunks) {
      nxt = load_chunk(base, stride, n, c + 1, F, lane);
    }
    const uint32_t a[2][4] = {{cur.r[0].x, cur.r[1].x, cur.r[0].y, cur.r[1].y},
                              {cur.r[0].z, cur.r[1].z, cur.r[0].w, cur.r[1].w}};
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
#pragma unroll
      for (int jp = 0; jp < kH / 16; ++jp) {
        const uint4 b = __ldg(w0 + ((2 * c + s2) * (kH / 16) + jp) * 32 + lane);
        rf_mma::mma_m16n8k16(acc[2 * jp], a[s2], b.x, b.y);
        rf_mma::mma_m16n8k16(acc[2 * jp + 1], a[s2], b.z, b.w);
      }
    }
    if constexpr (!kStaged) cur = nxt;
  }
}

// layers 1-3 of an MLP's packed weights ((in, out) row-major from fc1 on)
// -> B-fragment order, as attention.cuh's `stage_fragments` lays them out
__device__ __forceinline__ void stage_hidden_fragments(const __nv_bfloat16* __restrict__ w,
                                                       uint32_t* dst) {
  for (int i = threadIdx.x; i < kHidWords; i += kMmaThreads) {
    const int layer = min(1 + i / kLayerWords, 3);
    const int rem = i - (layer - 1) * kLayerWords;
    const int nout = layer == 3 ? kC : kH, pairs = nout / 16;
    const int r = rem & 3, lane = (rem >> 2) & 31, sj = rem >> 7;
    const int jp = sj % pairs, s = sj / pairs;
    const int g = lane >> 2, t = lane & 3;
    const int n = 8 * (2 * jp + (r >> 1)) + g;
    const int k = 16 * s + 8 * (r & 1) + 2 * t;
    const __nv_bfloat16* wl = w + (layer - 1) * kH * kH;
    dst[i] = rf_mma::pack_bf16(wl[k * nout + n], wl[(k + 1) * nout + n]);
  }
}

struct GMmaWeights {
  const uint4* w0_theta;  // layer 0's fragments, global memory
  const uint32_t* w_theta;  // layers 1-3's fragments, shared memory
  const float* b_theta;
  const uint4* w0_phi;
  const uint32_t* w_phi;
  const float* b_phi;
  float* scores;  // this warp's (kSlice, kGLd)
};

// The 4-layer MLP on 16 rows (layer 0 chunked from global memory, layers
// 1-3 from shared memory); the (16, kC) float32 result as mlp_mma's
template <bool kStaged>
__device__ __forceinline__ void mlp_general(const __nv_bfloat16* base, size_t stride, int n,
                                            int F, int chunks, const uint4* w0,
                                            const uint32_t* w, const float* bias, int lane,
                                            uint4* slots, float (&out)[kC / 8][4]) {
  uint32_t a[kHSteps][4];
  {
    float acc[kH / 8][4];
    layer0_general<kStaged>(base, stride, n, F, chunks, w0, lane, slots, acc);
    hidden_to_fragments(acc, bias, lane, a);
  }
#pragma unroll 1
  for (int layer = 1; layer < 3; ++layer) {
    float acc[kH / 8][4];
    layer_mma<kH / 8, kHSteps>(a, reinterpret_cast<const uint4*>(w + (layer - 1) * kLayerWords),
                               lane, acc);
    hidden_to_fragments(acc, bias + layer * kH, lane, a);
  }
  layer_mma<kC / 8, kHSteps>(a, reinterpret_cast<const uint4*>(w + 2 * kLayerWords), lane, out);
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

// out = x (1 - switch) + (sum_k w_k p_k) switch for the slice's rows, by one
// warp, a lane a column, from the rows in global memory and the weights
// select_mma left (rows F apart in out)
template <typename Rows>
__device__ __forceinline__ void blend_general(const Rows& r, int F, const float* scores, int lane,
                                              __nv_bfloat16* __restrict__ out) {
  for (int i = 0; i < r.n; ++i) {
    const float* ws = scores + i * kGLd;
    const float sw = ws[kGLd - 1];
    for (int col = lane; col < F; col += 32) {
      float acc = 0.f;
      for (int k = 0; k < r.K; ++k) {
        const float wk = ws[k];
        if (wk == 0.f) continue;  // exact: 0 * p adds nothing
        acc += wk * to_f32(r.cand(k)[i * r.stride + col]);
      }
      out[static_cast<size_t>(i) * F + col] =
          from_f32<__nv_bfloat16>(to_f32(r.x[static_cast<size_t>(i) * F + col]) * (1.f - sw)
                                  + acc * sw);
    }
  }
}

// Attention over one slice of up to 16 rows, by one warp; out and sel_out
// start at the slice's first row.
template <bool kHard, bool kStaged, typename Rows>
__device__ __forceinline__ void attend_slice_general(const Rows& r, int F, int chunks,
                                                     const GMmaWeights& m, float sharpness,
                                                     __nv_bfloat16* __restrict__ out,
                                                     int* __restrict__ sel_out, uint4* slots) {
  const int lane = threadIdx.x & 31;
  float xf[kC / 8][4], emb[kC / 8][4];
  mlp_general<kStaged>(r.x, F, r.n, F, chunks, m.w0_theta, m.w_theta, m.b_theta, lane, slots,
                       xf);
  normalise_mma(xf);
  for (int k = 0; k < r.K; ++k) {
    mlp_general<kStaged>(r.cand(k), r.stride, r.n, F, chunks, m.w0_phi, m.w_phi, m.b_phi, lane,
                         slots, emb);
    score_mma<kGLd>(xf, emb, m.scores, k, lane);
  }
  __syncwarp();
  select_mma<kHard, kGLd>(m.scores, r.K, sharpness, lane, 0, r.n, sel_out);
  __syncwarp();
  blend_general(r, F, m.scores, lane, out);
  __syncwarp();  // the scores are free for the warp's next slice
}

// shared memory of the general bf16 body: layers 1-3 of theta and phi, the
// biases, the warps' scores and, kStaged, their double-buffered chunk slots
template <bool kStaged>
constexpr size_t general_mma_smem() {
  return 2 * kHidWords * sizeof(uint32_t) + 2 * kBiases * sizeof(float)
         + kWarps * kSlice * kGLd * sizeof(float)
         + (kStaged ? static_cast<size_t>(kWarps) * 2 * 32 * 2 * sizeof(uint4) : 0);
}
static_assert(general_mma_smem<true>() <= 232448, "the general body in one block");
static_assert((2 * kHidWords * sizeof(uint32_t) + 2 * kBiases * sizeof(float)
               + kWarps * kSlice * kGLd * sizeof(float)) % 16 == 0, "the slots' alignment");

// The persistent general bf16 body: stage layers 1-3 and the biases once,
// then let each warp walk over the slices of `slices`. w_theta / w_phi:
// layer 0 in B-fragment order at padded width Fp, then layers 1-3 in
// (in, out) layout.
template <bool kHard, bool kStaged, typename Slices>
__device__ __forceinline__ void attend_slices_general(
    const Slices& slices, int F, unsigned char* smem, const __nv_bfloat16* __restrict__ w_theta,
    const float* __restrict__ b_theta, const __nv_bfloat16* __restrict__ w_phi,
    const float* __restrict__ b_phi, float sharpness, __nv_bfloat16* __restrict__ out,
    int* __restrict__ sel_out) {
  const int fp = pad32(F);
  uint32_t* wt = reinterpret_cast<uint32_t*>(smem);
  uint32_t* wp = wt + kHidWords;
  float* bt = reinterpret_cast<float*>(wp + kHidWords);
  float* bp = bt + kBiases;
  float* scores = bp + kBiases;
  uint4* slots = reinterpret_cast<uint4*>(scores + kWarps * kSlice * kGLd);
  stage_hidden_fragments(w_theta + static_cast<size_t>(fp) * kH, wt);
  stage_hidden_fragments(w_phi + static_cast<size_t>(fp) * kH, wp);
  for (int i = threadIdx.x; i < kBiases; i += kMmaThreads) {
    bt[i] = b_theta[i];
    bp[i] = b_phi[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const GMmaWeights m{reinterpret_cast<const uint4*>(w_theta), wt, bt,
                      reinterpret_cast<const uint4*>(w_phi), wp, bp,
                      scores + warp * kSlice * kGLd};
  uint4* my_slots = kStaged ? slots + (warp * 32 + lane) * 4 : nullptr;  // [buffer][run]
  const long long count = slices.count();
  for (long long s = static_cast<long long>(blockIdx.x) * kWarps + warp; s < count;
       s += static_cast<long long>(gridDim.x) * kWarps) {
    const auto r = slices(s);
    attend_slice_general<kHard, kStaged>(r, F, fp / 32, m, sharpness, out + r.row0 * F,
                                         sel_out == nullptr ? nullptr : sel_out + r.row0,
                                         my_slots);
  }
}

// the persistent grid for `slices` warp slices
inline int general_blocks(long long slices, cudaError_t* err) {
  const int sms = sm_count(err);
  const long long want = (slices + kWarps - 1) / kWarps;
  return static_cast<int>(want < sms ? want : sms);
}

// ---- float32 FMAs ----

// rows [0, n) of a tile, columns [c0, c0 + kH) of its F (zero past F and n)
// -> act[i·kLd + c] as float32; kAsync (float32 rows): by cp.async
template <typename E, bool kAsync>
__device__ __forceinline__ void load_rows_chunk(const E* src, size_t stride, int n, int F,
                                                int c0, float* act) {
  static_assert(!kAsync || std::is_same_v<E, float>, "cp.async copies float32 rows as they are");
  for (int v = threadIdx.x; v < kT * kH; v += kThreads) {
    const int row = v / kH, col = v % kH, gc = c0 + col;
    const bool ok = row < n && gc < F;
    float* dst = act + row * kLd + col;
    if constexpr (kAsync)
      rf_mma::cp_async_zfill<4>(dst, ok ? static_cast<const void*>(src + row * stride + gc) : src,
                                ok ? 4u : 0u);
    else
      *dst = ok ? to_f32(src[row * stride + gc]) : 0.f;
  }
  if constexpr (kAsync) rf_mma::cp_async_wait_all();
}

// layer 0 of the float32 body at any F: act1 = act(rows @ fc0 + b) with fc0
// (Fp, kH) at w, the rows brought into act0 kH columns at a time, the sums
// kept in registers across the chunks
template <typename E, bool kAsync>
__device__ __forceinline__ void dense0_general(const E* src, size_t stride, int n, int F, int fp,
                                               float* in, float* out, const E* __restrict__ w,
                                               const float* __restrict__ bias, float* wbuf) {
  constexpr int kCg = kH / 8, kRm = kT * kCg / kThreads;
  const int tx = threadIdx.x % kCg, ty = threadIdx.x / kCg;
  const int c0 = tx * 4, c1 = kH / 2 + tx * 4;
  float acc[kRm][8];
#pragma unroll
  for (int r = 0; r < kRm; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  for (int cc = 0; cc < fp; cc += kH) {
    __syncthreads();  // `in` free
    load_rows_chunk<E, kAsync>(src, stride, n, F, cc, in);
    const int cw = min(kH, fp - cc);
    for (int k0 = 0; k0 < cw; k0 += kKc) {
      __syncthreads();  // wbuf free; `in` complete
      for (int i = threadIdx.x; i < kKc * kH; i += kThreads)
        wbuf[i] = to_f32(w[static_cast<size_t>(cc + k0) * kH + i]);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKc; ++kk) {
        const float4 w0 = *reinterpret_cast<const float4*>(&wbuf[kk * kH + c0]);
        const float4 w1 = *reinterpret_cast<const float4*>(&wbuf[kk * kH + c1]);
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
  }
#pragma unroll
  for (int r = 0; r < kRm; ++r) {
    const int row = ty * kRm + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? c0 + j : c1 + j - 4;
      const float v = acc[r][j] + bias[col];
      out[row * kLd + col] = to_f32(from_f32<E>(v >= 0.f ? v : 0.01f * v));
    }
  }
}

// the 4-layer MLP on a tile's rows at any F; leaves the (kT, kC) result in act0
template <typename E, bool kAsync>
__device__ __forceinline__ void mlp_general_f32(const E* src, size_t stride, int n, int F,
                                                int fp, float* act0, float* act1,
                                                const E* __restrict__ w,
                                                const float* __restrict__ b, float* wbuf) {
  dense0_general<E, kAsync>(src, stride, n, F, fp, act0, act1, w, b, wbuf);
  const E* wh = w + static_cast<size_t>(fp) * kH;
  dense<E, kH, kH>(act1, act0, wh, b + kH, wbuf, true);
  dense<E, kH, kH>(act0, act1, wh + kH * kH, b + 2 * kH, wbuf, true);
  dense<E, kH, kC>(act1, act0, wh + 2 * kH * kH, b + 3 * kH, wbuf, false);
  __syncthreads();
}

constexpr size_t kGSmemFloats = 2 * kT * kLd + kKc * kH + kT * (kC + 1) + 2 * kT * kGMaxK + kT;
constexpr size_t kGSmemBytes = kGSmemFloats * sizeof(float);

// Attention over one tile of up to 64 rows of row source `r` (rows of F
// values), by one block; out and sel_out start at the tile's first row.
template <typename E, bool kHard, bool kAsync, typename Rows>
__device__ __forceinline__ void attend_tile_general(const Rows& r, int F, float* smem,
                                                    const E* __restrict__ w_theta,
                                                    const float* __restrict__ b_theta,
                                                    const E* __restrict__ w_phi,
                                                    const float* __restrict__ b_phi,
                                                    float sharpness, E* __restrict__ out,
                                                    int* __restrict__ sel_out) {
  float* act0 = smem;
  float* act1 = act0 + kT * kLd;
  float* wbuf = act1 + kT * kLd;
  float* xf = wbuf + kKc * kH;
  float* score = xf + kT * (kC + 1);
  float* wsel = score + kT * kGMaxK;
  float* sw = wsel + kT * kGMaxK;
  const int t = threadIdx.x, K = r.K, fp = pad32(F);

  mlp_general_f32<E, kAsync>(r.x, F, r.n, F, fp, act0, act1, w_theta, b_theta, wbuf);
  if (t < kT) {
    const float* row = act0 + t * kLd;
    const float d = row_norm(row);
#pragma unroll 8
    for (int c = 0; c < kC; ++c) xf[t * (kC + 1) + c] = row[c] / d;
  }
  for (int k = 0; k < K; ++k) {
    mlp_general_f32<E, kAsync>(r.cand(k), r.stride, r.n, F, fp, act0, act1, w_phi, b_phi, wbuf);
    if (t < kT) {
      const float* row = act0 + t * kLd;
      const float d = row_norm(row);
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < kC; ++c) s = fmaf(xf[t * (kC + 1) + c], row[c] / d, s);
      score[t * kGMaxK + k] = s;
    }
  }

  if (t < kT) {
    const float* s = score + t * kGMaxK;
    float* ws = wsel + t * kGMaxK;
    float mx = s[0];
    int best = 0;
    for (int k = 1; k < K; ++k) {
      mx = fmaxf(mx, s[k]);
      if (s[k] * 25.f > s[best] * 25.f) best = k;  // first maximum wins
    }
    sw[t] = fmaxf(mx, 0.f);
    if (kHard) {
      for (int k = 0; k < K; ++k) ws[k] = k == best ? 1.f : 0.f;
    } else {
      float m = sharpness * s[0];
      for (int k = 1; k < K; ++k) m = fmaxf(m, sharpness * s[k]);
      float sum = 0.f;
      for (int k = 0; k < K; ++k) {
        const float e = expf(sharpness * s[k] - m);
        ws[k] = e;
        sum += e;
      }
      for (int k = 0; k < K; ++k) ws[k] /= sum;
    }
    if (sel_out != nullptr && t < r.n) sel_out[t] = best;
  }
  __syncthreads();

  for (int v = t; v < r.n * F; v += kThreads) {
    const int row = v / F, col = v - row * F;
    const float* ws = wsel + row * kGMaxK;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wk = ws[k];
      if (wk == 0.f) continue;  // exact: 0 * p adds nothing
      acc += wk * to_f32(r.cand(k)[row * r.stride + col]);
    }
    const float s = sw[row];
    out[v] = from_f32<E>(to_f32(r.x[v]) * (1.f - s) + acc * s);
  }
}

}  // namespace rf_attention
