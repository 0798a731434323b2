// Flash-attention forward with GQA, causal and sliding-window masks, for
// Hopper (sm_90a), bf16 in and out, on the tensor cores.
//
// Replaces: flash_attention_pallas / _kernel in
// src/repro/kernels/flash_attention/kernel.py (its bf16 calls; fp32 goes
// to flash_attention.cu).
//
// q (B, Sq, H, D) and k, v (B, Skv, KH, D), all bf16 and contiguous; out
// (B, Sq, H, D) bf16. D is 16, 32, 64, 128 or 256 (the wrapper zero-pads
// any other D <= 256 to the next of these). Query head h reads KV head
// h / G, G = H / KH. A key is allowed when k_pos < Skv, and
// k_pos <= q_pos if causal, and k_pos > q_pos - window if window > 0;
// masked scores are -1e30. The softmax is online over KV tiles of 64
// keys with fp32 carries m, l and acc:
//   m' = max(m, max_j s_j), corr = exp(m - m'), l' = l * corr + sum_j p_j,
//   acc' = acc * corr + sum_j bf16(p_j) v_j, p_j = exp(s_j - m'),
// and out = bf16(acc / max(l, 1e-30)). p is rounded to bf16 for p.v, as
// the plain bf16 path rounds it to the V dtype and the reference's dot at
// default precision does on the MXU. (The kernel works in base 2:
// s·log2(e) and exp2, the same function.)
//
// What bounds it on the H100: at the serve prefill's shape (B 16, S 512,
// H 32, KH 8, D 128, causal) the two products are 4·B·H·D·S(S+1)/2 ≈
// 3.4e10 FLOP against ≈ 0.17 GB of bf16 q, k, v and out: 0.035 ms at the
// 989 TFLOP/s of the bf16 tensor cores, 0.050 ms for the bytes at 3.35
// TB/s. So it is bytes first, then tensor-core operations.
// What the design does about it:
// - Both products run on the tensor cores with wgmma (m64nNk16, bf16 in,
//   fp32 accumulate). A CTA holds 64·W query rows of one head: W
//   warpgroups of 64 rows (W = 3 for D <= 128, 2 above: as many as the
//   registers allow), whose Q tiles stay in shared memory for the CTA's
//   life, and which all read every K/V tile the CTA loads, so K and V
//   cross from L2 to the SM once per 64·W rows. Fewer rows a CTA wait on
//   the K/V copies more: ``scripts/kernel_variants.py`` times W = 1, 2, 3
//   and W = 1 without the in-loop copies on the card. S = Q·Kᵀ reads Q and the K tile
//   from shared memory (K-major); O += P·V takes P from registers (the S
//   accumulator fragments, rounded to bf16, are exactly the A fragments
//   of the next product) and V from shared memory in the MN-major
//   (transposed) B layout that 16-bit types allow, so V is never
//   transposed by hand.
// - Tiles sit in shared memory in the no-swizzle core-matrix order that
//   wgmma reads (8 rows × 16 bytes contiguous), which is also the order
//   the copies write: a tile's 16-byte chunk s lands at byte 16·s, so
//   each quarter-warp writes one 128-byte core matrix and a warp reads
//   64-byte runs of 8 rows from device memory.
// - K and V stream through a ring of two shared-memory stages filled by
//   16-byte cp.async copies (zero-filled past Skv and Sq): the next
//   tile's copies run under this tile's products.
// - KV tiles wholly above the causal diagonal of every row in the CTA,
//   or wholly before the window of every row, are not loaded, and a
//   warpgroup computes on none that is so for all of its own rows. For a row
//   that has seen an allowed key such a tile is an exact no-op (p = 0,
//   corr = 1); before its first allowed key a row's p = 1 garbage is
//   wiped exactly by corr = exp(-1e30 - m) = 0 when that key arrives. So
//   skipping changes no bit. (A row with no allowed key at all, possible
//   only when Sq > Skv, is outside the contract.)
// - The causal grid is balanced: the query tile is the grid's slowest
//   dimension and runs backwards, so the CTAs with the most KV tiles
//   launch first and the short ones fill the tail.
// Row statistics (max, sum) run on the accumulator fragments: each row
// lives in the 4 lanes of a quad, reduced with two shuffles. Later work:
// a producer warp with TMA and a deeper ring, softmax overlapped with the
// next product, and the G heads of one KV head sharing a K/V stream.
//
// Determinism: the KV tile is a constant (64 keys) and the tiles start
// at key 0, so a row's bytes depend on D and its q, k, v only, never on
// Sq, on which CTA holds it, or on the caller's kv_chunk (the reference's
// own kernel branch drops kv_chunk too). Each row sits at the same lanes
// of its warpgroup's 64 rows (those start at multiples of 64), sums its l
// partials in a fixed shuffle order, and no atomics are used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int BN = 64;          // keys per KV tile, fixed

// Consumer warpgroups a CTA, 64 query rows each: as many as the
// registers allow (an fp32 O tile of 64 x D is D / 2 registers a thread).
template <int D>
constexpr int kWG = D <= 128 ? 3 : 2;
template <int D>
constexpr int kThreads = 128 * kWG<D>;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !ok (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// this thread's generic-proxy writes (the cp.async copies) become
// visible to the async proxy that wgmma reads shared memory through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching wgmma's registers across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A wgmma shared-memory descriptor for the no-swizzle layout (type 0):
// start address; leading byte offset = the stride between core matrices
// along K, stride byte offset = the stride between core matrices along M
// or N. In this layout that holds for K-major and MN-major operands alike
// (CUTLASS's Major-K and Major-MN INTERLEAVE layouts; the swizzled
// MN-major layouts swap the two).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr,
                                              uint32_t k_stride,
                                              uint32_t mn_stride) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((k_stride >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((mn_stride >> 4) & 0x3FFF) << 32);
}

// S (64 x 64) += A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// O (64 x 16) += A (64 x 16, registers) . B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// O (64 x 32) += A (64 x 16, registers) . B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// O (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// O (64 x 128) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// O (64 x 256) += A (64 x 16, registers) . B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copies rows [0, 64) of a tile (row r at base + r * stride, D bf16
// each; rows >= valid zero-filled) into shared memory at ``dst`` in
// core-matrix order: the chunk of row r, columns 8c..8c+7, is chunk
// s = ((r / 8) * (D / 8) + c) * 8 + r % 8, at byte 16 s.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          size_t stride, int valid) {
  constexpr int C = D / 8;
  constexpr int kChunks = 64 * C;
#pragma unroll
  constexpr int T = kThreads<D>;
  for (int i = 0; i < (kChunks + T - 1) / T; ++i) {
    const int s = threadIdx.x + i * T;
    if (kChunks % T == 0 || s < kChunks) {
      const int r = (s >> 3) / C * 8 + (s & 7);
      const int c = (s >> 3) % C;
      const bool ok = r < valid;
      cp_async16(dst + 16 * s, ok ? base + r * stride + c * 8 : base, ok);
    }
  }
}

// Dynamic shared memory: Q (one 64-row tile per warpgroup), then K
// stages 0 and 1, then V stages 0 and 1, each 64 rows x D bf16 in
// core-matrix order. Warpgroup w owns query rows q0 + 64 w ... + 63; both
// read every K/V tile the CTA loads.
template <int D>
__global__ void __launch_bounds__(kThreads<D>)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                       int H, int KH, int causal, int window,
                       float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr uint32_t kTile = 64 * D * 2;          // bytes
  constexpr uint32_t kRow8 = D * 16;              // 8 rows of D bf16
  const uint32_t s_q = smem_addr(smem);
  constexpr int BM = 64 * kWG<D>;                 // query rows per CTA
  const uint32_t s_k = s_q + kWG<D> * kTile, s_v = s_k + 2 * kTile;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;   // longest rows first
  const int wg = threadIdx.x >> 7;
  const int qw = q0 + 64 * wg;                        // this warpgroup's rows
  const uint32_t s_qw = s_q + wg * kTile;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / KH);
  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KH * D;
  const __nv_bfloat16* qh = q + ((size_t)b * Sq + q0) * q_stride +
                            (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_stride + (size_t)kh * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_stride + (size_t)kh * D;

  // KV tiles [t0, t1) the CTA loads: none wholly past the diagonal of
  // its last row, none wholly before the window of its first row; and
  // [w0, w1) the ones this warpgroup computes on, by the same rule for
  // its own rows (none if it has no row below Sq)
  const int nkv = (Skv + BN - 1) / BN;
  const int q_last = min(q0 + BM, Sq) - 1;
  const int t1 = causal ? min(nkv, q_last / BN + 1) : nkv;
  const int t0 = window > 0 ? max(0, q0 - window + 1) / BN : 0;
  const int qw_last = min(qw + 64, Sq) - 1;
  const int w0 = window > 0 ? max(0, qw - window + 1) / BN : 0;
  const int w1 = qw >= Sq ? w0 : causal ? min(nkv, qw_last / BN + 1) : nkv;

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row = qw + warp * 16 + (lane >> 2);   // half 1 is row + 8
  const int col = 2 * (lane & 3);                 // within an 8-wide group

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

#pragma unroll
  for (int w = 0; w < kWG<D>; ++w)     // rows past Sq read nothing
    load_tile<D>(s_q + w * kTile, Sq - q0 > 64 * w ? qh + 64 * w * q_stride
                                                    : qh,
                 q_stride, Sq - q0 - 64 * w);
  if (t0 < t1) {
    load_tile<D>(s_k, kb + (size_t)t0 * BN * kv_stride, kv_stride,
                 Skv - t0 * BN);
    load_tile<D>(s_v, vb + (size_t)t0 * BN * kv_stride, kv_stride,
                 Skv - t0 * BN);
  }
  cp_async_commit();

  for (int t = t0; t < t1; ++t) {
    const uint32_t st = (t - t0) & 1;
    cp_async_wait_all();        // this thread's copies of tile t (and Q)
    fence_proxy_async();
    __syncthreads();            // ... everyone's; tile t-1 is consumed
    if (t + 1 < t1) {
      const size_t off = (size_t)(t + 1) * BN * kv_stride;
      load_tile<D>(s_k + (st ^ 1) * kTile, kb + off, kv_stride,
                   Skv - (t + 1) * BN);
      load_tile<D>(s_v + (st ^ 1) * kTile, vb + off, kv_stride,
                   Skv - (t + 1) * BN);
    }
    cp_async_commit();

    if (t >= w0 && t < w1) {   // warpgroup-uniform
      // S = Q . K^T: 64 x 64, D / 16 steps over the head dimension
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, make_desc(s_qw + kk * 256, 128, kRow8),
                     make_desc(s_k + st * kTile + kk * 256, 128, kRow8));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale, mask, online softmax. s[4j + e]: row (e < 2 ? row : row + 8),
      // key kv0 + 8j + col + (e & 1)
      const int kv0 = t * BN;
      const bool edge = kv0 + BN > Skv || (causal && kv0 + BN - 1 > qw) ||
                        (window > 0 && kv0 <= qw_last - window);
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale_log2;
          if (edge) {
            const int kp = kv0 + 8 * j + col + (e & 1);
            const int qp = row + (e >> 1) * 8;
            bool ok = kp < Skv;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            x = ok ? x : kNeg;
          }
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(s[i] - m[(i >> 1) & 1]);
        s[i] = p;
        sum[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // P (bf16) as the A fragments: keys 16kk..16kk+15 are S groups
      // j = 2kk (a0: row, a1: row + 8) and j = 2kk + 1 (a2, a3)
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P . V: 64 x D, 4 steps of 16 keys; V is MN-major (D contiguous)
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    make_desc(s_v + st * kTile + kk * 2 * kRow8, kRow8, 128));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);
    }
  }
  cp_async_wait_all();

  // normalise and store the CTA's real rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* dst = out + ((size_t)b * Sq + qp) * q_stride +
                         (size_t)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 w = __floats2bfloat162_rn(
          o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + col) = w;
    }
  }
}

constexpr int kMaxDevices = 64;
std::mutex carve_mutex;

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* out, int B, int Sq,
           int Skv, int H, int KH, int causal, int window, float scale_log2,
           cudaStream_t stream) {
  const size_t smem = (size_t)(kWG<D> + 4) * 64 * D * 2;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  {
    // the carve is set once per device, the first time this D launches
    static bool carved[kMaxDevices] = {};
    std::lock_guard<std::mutex> hold(carve_mutex);
    if (!carved[dev]) {
      int optin = 0;
      err = (int)cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err) return err;
      if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
      err = (int)cudaFuncSetAttribute(
          flash_fwd_wgmma_kernel<D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
      carved[dev] = true;
    }
  }
  constexpr int BM = 64 * kWG<D>;
  if ((Sq + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B, (Sq + BM - 1) / BM);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads<D>, smem, stream>>>(
      q, k, v, out, Sq, Skv, H, KH, causal, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the bf16 forward on ``stream``; allocates nothing (``out``
// comes from the caller). q, k, v and out are bf16, contiguous and
// 16-byte aligned; ``scale`` multiplies q.k. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for what the kernel does not
// take: D not one of 16, 32, 64, 128, 256, H not a multiple of KH, or
// more than 65,535 batch rows or query tiles of 64.
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             void* out, int B, int Sq, int Skv, int H,
                             int KH, int D, int causal, int window,
                             float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KH <= 0 || H % KH ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const bf *qq = (const bf*)q, *kk = (const bf*)k, *vv = (const bf*)v;
  bf* oo = (bf*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const float sl = scale * kLog2e;
  switch (D) {
    case 16: return launch<16>(qq, kk, vv, oo, B, Sq, Skv, H, KH, causal, window, sl, s);
    case 32: return launch<32>(qq, kk, vv, oo, B, Sq, Skv, H, KH, causal, window, sl, s);
    case 64: return launch<64>(qq, kk, vv, oo, B, Sq, Skv, H, KH, causal, window, sl, s);
    case 128: return launch<128>(qq, kk, vv, oo, B, Sq, Skv, H, KH, causal, window, sl, s);
    case 256: return launch<256>(qq, kk, vv, oo, B, Sq, Skv, H, KH, causal, window, sl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
