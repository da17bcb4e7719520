// Warp-level tensor-core and async-copy primitives for sm_90a, shared by
// attention.cuh, decoder_tail.cu and knn.cu: the bf16 m16n8k16 and TF32
// m16n8k8 products with float32 sums, ldmatrix, cp.async, the bf16 pair pack,
// and (gathered_attention_v1.cu, knn.cu) the bulk asynchronous copy with the
// mbarrier that reports its arrival.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4), each
// register a pair of bf16 with the lower index in the low half:
//   A (16 x 16, row):  a0 = A[g][2t, 2t+1]      a1 = A[g+8][2t, 2t+1]
//                      a2 = A[g][2t+8, 2t+9]    a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, col):   b0 = B[2t, 2t+1][g]      b1 = B[2t+8, 2t+9][g]
//   C (16 x 8, f32):   c0, c1 = C[g][2t, 2t+1]  c2, c3 = C[g+8][2t, 2t+1]
// So the C fragments of two neighbouring n8 tiles, rounded to bf16 and
// packed, are the A fragment of one k16 step of the next product: tile 2s
// gives a0 (c0, c1) and a1 (c2, c3), tile 2s+1 gives a2 and a3.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rf_mma {

// d += a (16 x 16 bf16) . b (16 x 8 bf16), float32 sums
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8 tf32) . b (8 x 8 tf32), float32 sums (knn.cu). Fragments:
//   A (16 x 8, row):  a0 = A[g][t]   a1 = A[g+8][t]   a2 = A[g][t+4]   a3 = A[g+8][t+4]
//   B (8 x 8, col):   b0 = B[t][g]   b1 = B[t+4][g]
//   C: as m16n8k16's. Each register is a float32 whose low 13 bits are ignored.
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (nearest, ties away from zero): a float32 bit pattern
// whose low 13 bits are zero, so |x - result| <= 2^-11 |x|
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the shared-space
// address (__cvta_generic_to_shared) of the 16-byte row l % 8 of matrix
// l / 8; r[m] receives matrix m's element pair (row g, columns 2t, 2t+1).
// Read as 32-bit words, r[m] is word t of matrix m's row g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned smem_row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_row));
}

// two matrices, addressed by lanes 0-15 as ldmatrix_x4's first two
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], unsigned smem_row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_row));
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// sum over the four lanes of a quad (the lanes that share g)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

// 8 bytes from global to shared memory, asynchronously (cached in L1: the
// 16-byte form alone may bypass it); both addresses 8-byte aligned
__device__ __forceinline__ void cp_async8(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem_src));
}

// `src_bytes` (0 or `BYTES`) of the BYTES (4 or 16) at gmem_src to shared
// memory, asynchronously, the rest of the BYTES zero-filled: a masked copy
// (attention_general.cuh); with 0 nothing is read
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem_dst, const void* gmem_src,
                                               unsigned src_bytes) {
  static_assert(BYTES == 4 || BYTES == 16, "cp.async sizes");
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem_src),
                 "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's cp.async copies have landed (a barrier publishes them)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ---- bulk asynchronous copies and their barriers ----
//
// An mbarrier is a 64-bit word in shared memory that counts arrivals and,
// for a bulk copy, the bytes still under way. A phase completes when both
// reach zero; a waiter names the parity of the phase it waits for (the n-th
// phase has parity n & 1). One thread starts a copy of a contiguous run:
// the copy engine moves it and reports to the barrier, and no thread spends
// registers or instructions on the bytes.

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// by one thread; `mbar_init_fence` and a block barrier before anyone uses it
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(bar)),
               "r"(arrivals)
               : "memory");
}

// makes initialised barriers visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_address(bar))
               : "memory");
}

// one arrival that also announces `bytes` of bulk copies to this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed; what the copies of that
// phase wrote is then visible to the caller
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = shared_address(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, reported to `bar`; by one thread
__device__ __forceinline__ void bulk_copy_to_shared(void* dst, const void* src, unsigned bytes,
                                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

// orders this thread's earlier loads and stores of shared memory before
// later writes of the copy engine to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes of shared memory
__device__ __forceinline__ uint4 load_shared16(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(shared_address(p)));
  return v;
}

}  // namespace rf_mma
