// Online-softmax attention over an int8 or bf16 KV memory, for Hopper: the
// device code shared by the paged-pool kernels (flash_attn_paged.cu) and the
// slot-table kernels (flash_attn.cu). The two differ only in where a KV tile
// lives and in how many tiles a row may see.
//
// Function: for batch row b, KV head h and query row r (R = G*T rows, the
// GQA group folded into rows), over the KV rows of the live tiles:
//   s   = (q . k) * k_scale * sm_scale   [softcap * tanh(s / softcap)]
//   s   masked to -inf unless pos >= 0 and pos <= row_pos
//         [and pos > row_pos - window]
//   out = sum softmax(s) * v_scale * v over the unmasked columns, with an
//         optional sink logit per row in the softmax denominator only.
// An int8 memory carries f32 row scales; a bf16 memory has none (scale 1).
// Rows with no unmasked column (padding) come out as 0; callers drop them.
//
// Arithmetic (the TPU kernel's, _fa_tile of ops/pallas/flash_attn.py): bf16
// q times k as bf16 (int8 values are exact in bf16) into f32 on the tensor
// cores; the k scale and sm_scale on the f32 score, then the softcap and the
// mask; an online softmax in f32; p * v_scale rounded to bf16 times v as
// bf16 into f32 on the tensor cores.
//
// Two kernels, chosen by the rows per (batch row, KV head):
//  * fa_prefill (R >= the wrapper's PREFILL_MIN_ROWS), bound by its tensor-
//    core operations. A block owns 128 query rows of one (b, h) (64 for
//    heads of 256): two consumer warpgroups of 64 rows and one producer
//    warpgroup, which meet on full/empty mbarriers over a ring of 2-3 tile
//    slots. The producer copies each 64-row K and V tile by cp.async into
//    the 128-byte-swizzled layout wgmma reads (an int8 tile lands raw in a
//    ring of its own, 1-3 tiles ahead, and is turned into bf16 once for
//    both consumers), with the tile's scales and positions. A consumer runs
//    QK^T as wgmma m64n64k16 from shared memory (Q and K K-major), the
//    online softmax on the score registers (a tile wholly visible to a
//    warp's rows skips the mask), and PV as wgmma m64nDk16 with P in
//    registers (the score accumulator's layout is the A fragment's) and V
//    MN-major. Heads of 32 are padded to 64 columns of zeros. Blocks run
//    the last row tiles (the longest causal rows of a GQA group) first.
//  * fa_decode (fewer rows), bound by the live K/V bytes. Swap-AB mma.sync
//    m16n8k16: KV rows in the MMA's M, up to 8 query rows in its n8. A
//    block owns 8 query rows of one (b, h) and a range of the live tiles
//    (flash decoding over `splits` blocks); each of its 4 warps walks its
//    own 16-row chunk of every tile through a private cp.async ring, so the
//    tile loop has no block barrier. The warps' and then the splits' (max,
//    sum, acc) are merged: the last block of each (b, h, row group), found
//    by an atomic counter that it resets, adds the splits in order with the
//    sink term. One launch.
// The live limit of a block is taken over its rows: the paged pool's
// clip(max_row_pos // page + 1, 1, MP) pages, a slot table's
// clip(max_row_pos // 64 + 1, 1, S / 64) tiles (every tile for a ring).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;       // KV rows per tile
constexpr int kRowsDec = 8;     // query rows per decode block (the MMA's n8)
constexpr int kChunk = 16;      // KV rows per warp and tile at decode (the MMA's M)
constexpr int kMaxSplits = 64;  // decode splits over the live tiles
constexpr int kTableSmem = 256;  // page-table entries a block keeps in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// Where the memory lives. PAGED: k, v [Hkv, S, D] and ks, vs [Hkv, S] over
// the pool's S rows, pos [S], index = page table [B, MP]. Slot table: k, v
// [n_seqs, Hkv, S, D], ks, vs [n_seqs, Hkv, S], pos [n_seqs, S], index =
// seq_idx [B] (the kernel addresses the sequence itself, nothing is
// gathered); `ring` visits every tile (slot order is not position order).
struct Layout {
  long long S;  // pool rows, or slots per sequence
  int MP;       // paged: pages per sequence
  int page;     // paged: rows per page
  int n_seqs;   // slot table: sequences in the cache
  int ring;     // slot table: visit every tile
};

struct Params {
  const __nv_bfloat16* q;  // [B, Hkv, R, D]
  const void* k;
  const void* v;
  const float* ks;  // null for bf16
  const float* vs;
  const int* pos;
  const int* row_pos;  // [B, R]
  const int* index;
  const float* sinks;  // [Hkv, R] or null
  float* out;          // [B, Hkv, R, D]
  float* part_acc;     // decode: [splits, B, Hkv, R, D]
  float* part_ml;      // decode: [2, splits, B, Hkv, R]
  int* counters;       // decode: [B * Hkv * row groups], zero, left zero
  int B, Hkv, R;
  Layout lay;
  float sm_scale;
  int window;
  float softcap;
  int splits;
};

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c[4] += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two int8 (the low bytes of t's 16-bit lanes) -> bf16x2, exact: 128 + the
// low 7 bits in the mantissa of bf16 128.0, less 128 (q >= 0) or 256 (q < 0)
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t t) {
  const uint32_t x = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (t & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                             *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&r);
}

// 16 int8 values -> 16 bf16 (exact)
__device__ __forceinline__ void i8x16_to_bf16(uint4 w, uint4& lo, uint4& hi) {
  const uint32_t in[4] = {w.x, w.y, w.z, w.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = i8x2_to_bf16x2(__byte_perm(in[i], 0u, 0x4140));
    o[2 * i + 1] = i8x2_to_bf16x2(__byte_perm(in[i], 0u, 0x4342));
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// live tiles of 64 KV rows for rows whose largest position is rmax
template <bool PAGED>
__device__ __forceinline__ int live_tiles(const Layout& lay, int rmax) {
  if (PAGED) {
    const int fl = rmax >= 0 ? rmax / lay.page : -1;  // floor division for rmax < 0
    return min(max(fl + 1, 1), lay.MP) * (lay.page / kTile);
  }
  const int all = (int)(lay.S / kTile);
  const int fl = rmax >= 0 ? rmax / kTile : -1;
  return lay.ring ? all : min(max(fl + 1, 1), all);
}

// first row of slot-table tile t in k/v/scales (kv_row) and in pos (pos_row)
__device__ __forceinline__ void slot_rows(const Params& p, int h, long long seq, int t,
                                          long long& kv_row, long long& pos_row) {
  pos_row = seq * p.lay.S + (long long)t * kTile;
  kv_row = (seq * p.Hkv + h) * p.lay.S + (long long)t * kTile;
}

// first row of paged tile t, its page read from the table row in shared
// memory where it holds the page (the first kTableSmem pages)
__device__ __forceinline__ void page_rows(const Params& p, const int* pages, int b, int h,
                                          int t, long long& kv_row, long long& pos_row) {
  const int tpp = p.lay.page / kTile;
  const int j = t / tpp;
  const int pg = j < kTableSmem ? pages[j] : p.index[(size_t)b * p.lay.MP + j];
  pos_row = (long long)pg * p.lay.page + (long long)(t % tpp) * kTile;
  kv_row = (long long)h * p.lay.S + pos_row;
}

__device__ __forceinline__ bool visible(int cp, int rp, int window) {
  return cp >= 0 && cp <= rp && (window <= 0 || cp > rp - window);
}

// the score of one column: f32 product, k scale, sm_scale, softcap, mask;
// returned in the log2 domain (times log2 e) for exp2. CAP is a template
// argument: a softcap branch inside the loop would be if-converted, paying
// tanhf and a division on every score
template <bool CAP>
__device__ __forceinline__ float score(float acc, float kscale, const Params& p, int cp,
                                       int rp) {
  float s = acc * kscale * p.sm_scale;
  if (CAP) s = p.softcap * tanhf(s * (1.f / p.softcap));
  return visible(cp, rp, p.window) ? s * kLog2e : -INFINITY;
}

// the scores of a decode thread's 4 (KV row g + 8 (e >> 1), query row
// 2 t4 + (e & 1)) and the query rows' new max
template <bool CAP, bool BF16>
__device__ __forceinline__ void decode_scores(float (&s)[4], float (&mx)[2], const float* kss,
                                              const int* cps, const int (&rp)[2],
                                              const Params& p, int g) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kv = g + 8 * (e >> 1);
    s[e] = score<CAP>(s[e], BF16 ? 1.f : kss[kv], p, cps[kv], rp[e & 1]);
    mx[e & 1] = fmaxf(mx[e & 1], s[e]);
  }
}

// ========================================================== prefill kernel

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy shared-memory writes (stores, cp.async) become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// orders the compiler's uses of wgmma accumulators after the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor under the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d[32] (+)= A (64 x 16, shared memory, K-major) . B (16 x 64, shared memory,
// K-major); scale_d = 0 starts from zero
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A (64 x 16 bf16 in registers, each warp's 16 rows as the
// mma.sync A fragment) . B (16 x 64, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A (64 x 16 bf16 in registers, each warp's 16 rows as the
// mma.sync A fragment) . B (16 x 128, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[128] += A (64 x 16 bf16 in registers, each warp's 16 rows as the
// mma.sync A fragment) . B (16 x 256, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// byte offset of the 16-byte chunk c (elements 8c .. 8c + 7) of row r in a
// bf16 tile of 64 rows: sub-tiles of 64 columns (8 KB, one 128-byte row a
// tile row), chunks XOR r % 8 (the 128-byte swizzle wgmma reads)
__device__ __forceinline__ int sw_chunk(int r, int c) {
  return (c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A prefill block: WG consumer warpgroups (64 query rows each) and one
// producer warpgroup. Shared memory (offsets from a 1024-byte aligned base): Q
// [64 rows, Dp] bf16 swizzled for each warpgroup; a ring of NB slots of the
// consumers' bf16 K and V tiles (swizzled as Q) with the tile's k and v
// scales and positions; for an int8 memory a ring of NR raw int8 tiles (row-
// major, with their scales and positions) the producer turns into slots;
// the full and empty mbarriers of the slots. Heads of 32 are padded to 64
// columns of zeros (Dp). Heads of 256 take one consumer warpgroup (their
// 226 registers a thread fit 256 threads, not 384) and over int8 one raw
// stage, to stay within 227 KB.
template <int D, bool BF16>
struct PreSmem {
  static constexpr int Dp = D < 64 ? 64 : D;
  static constexpr int WG = D > 128 ? 1 : 2;
  static constexpr int kThreads = 128 * WG + 128;
  static constexpr int kRows = 64 * WG;
  static constexpr int NB = D <= 128 ? 3 : 2;
  static constexpr int NR = BF16 ? 0 : (D <= 128 ? 3 : 1);
  static constexpr int kTileB = (Dp / 64) * 8192;  // a swizzled bf16 tile of 64 rows
  static constexpr int kRawTile = kTile * D;       // an int8 tile
  // a slot: K, V, then 64 k scales, v scales, positions
  static constexpr int sl_ks = 2 * kTileB;
  static constexpr int sl_vs = sl_ks + kTile * 4;
  static constexpr int sl_pos = sl_vs + kTile * 4;
  static constexpr int kSlot = (sl_pos + kTile * 4 + 1023) / 1024 * 1024;
  // a raw stage: K, V, then the same three rows
  static constexpr int rw_side = 2 * kRawTile;
  static constexpr int kRaw = (rw_side + 3 * kTile * 4 + 1023) / 1024 * 1024;
  static constexpr int q = 0;
  static constexpr int ring = WG * kTileB;
  static constexpr int raw = ring + NB * kSlot;
  static constexpr int bars = raw + NR * kRaw;  // full[NB], empty[NB]
  static constexpr int bytes = bars + 16 * NB + 1024;  // + alignment
};

// The scores of a thread's 32 columns of a tile (sacc[4 j + e]: row 8 (e >>
// 1) of its pair, column 8 j + 2 t4 + (e & 1)) and the rows' new max. FULL:
// every column is visible to every row of the warp (no mask, no softcap).
template <bool FULL, bool CAP, bool BF16>
__device__ __forceinline__ void prefill_scores(float (&sacc)[32], float (&mx)[2],
                                               const float* kss, const int* cps,
                                               const int (&rp)[2], const Params& p, int t4) {
  const float c = p.sm_scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + 2 * t4;
    float2 k2 = make_float2(1.f, 1.f);
    if (!BF16) k2 = *reinterpret_cast<const float2*>(kss + col);
    const float ks[2] = {k2.x, k2.y};
    int2 c2 = make_int2(0, 0);
    if (!FULL) c2 = *reinterpret_cast<const int2*>(cps + col);
    const int cp[2] = {c2.x, c2.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& v = sacc[4 * j + e];
      if (FULL) {
        v *= ks[e & 1] * c;
      } else {
        v = score<CAP>(v, ks[e & 1], p, cp[e & 1], rp[e >> 1]);
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
}

template <int D, bool BF16, bool PAGED>
__global__ void __launch_bounds__(PreSmem<D, BF16>::kThreads, 1)
fa_prefill(const __grid_constant__ Params p) {
  using L = PreSmem<D, BF16>;
  constexpr int Dp = L::Dp;
  constexpr int NB = L::NB;
  constexpr int NR = L::NR;
  constexpr int EB = BF16 ? 2 : 1;
  constexpr int ND = Dp / 8;  // output n-tiles (of 8 columns)
  constexpr int kConsumers = 128 * L::WG;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int red[L::kThreads / 32];
  __shared__ int pages[kTableSmem];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_addr);
  const uint32_t full = base + L::bars, empty = full + 8 * NB;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = tid >> 7;  // consumer warpgroup: rows 64 wg .. 64 wg + 63 of the block
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int n_rt = gridDim.x;
  const int r0 = (n_rt - 1 - (int)blockIdx.x) * L::kRows;  // the last row tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int R = p.R;

  if (tid == 0) {
    for (int s = 0; s < NB; ++s) {
      mbar_init(full + 8 * s, 128);               // every producer thread
      mbar_init(empty + 8 * s, kConsumers / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (D < Dp) {  // heads of 32: the padding columns stay zero
    for (int i = tid; i < L::raw / 16; i += L::kThreads) {
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
  }
  // Q rows -> shared memory (rows past R as zeros), swizzled, a 64-row
  // tile for each warpgroup
  const __nv_bfloat16* qg = p.q + (((size_t)b * p.Hkv + h) * R) * D;
  for (int i = tid; i < L::kRows * D / 8; i += L::kThreads) {
    const int rr = i / (D / 8);
    const int c = i % (D / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + rr < R) v = *reinterpret_cast<const uint4*>(qg + (size_t)(r0 + rr) * D + c * 8);
    *reinterpret_cast<uint4*>(smem + L::q + (rr >> 6) * L::kTileB + sw_chunk(rr & 63, c)) = v;
  }
  // the page table row, and the block's live tiles (a warp reduction of
  // the rows' positions)
  if (PAGED) {
    for (int i = tid; i < min(p.lay.MP, kTableSmem); i += L::kThreads) {
      pages[i] = p.index[(size_t)b * p.lay.MP + i];
    }
  }
  {
    int rm = INT_MIN;
    if (tid < L::kRows && r0 + tid < R) rm = p.row_pos[(size_t)b * R + r0 + tid];
    rm = warp_max_int(rm);
    if (lane == 0) red[warp] = rm;
  }
  const long long seq = PAGED ? 0 : min(max(p.index[b], 0), p.lay.n_seqs - 1);
  fence_proxy_async();
  __syncthreads();
  int rmax = red[0];
#pragma unroll
  for (int w = 1; w < L::kThreads / 32; ++w) rmax = max(rmax, red[w]);
  const int n_tiles = live_tiles<PAGED>(p.lay, rmax);

  if (tid >= kConsumers) {
    // ------------- the producer warpgroup: copies (and int8 -> bf16) -------------
    const int pt = tid - kConsumers;
    constexpr int CPR = D * EB / 16;  // 16-byte chunks a K or V row
    auto rows_of = [&](int t, const char*& kg, const char*& vg, long long& kv_row,
                       long long& pos_row) {
      if (PAGED) {
        page_rows(p, pages, b, h, t, kv_row, pos_row);
      } else {
        slot_rows(p, h, seq, t, kv_row, pos_row);
      }
      kg = static_cast<const char*>(p.k) + (size_t)kv_row * D * EB;
      vg = static_cast<const char*>(p.v) + (size_t)kv_row * D * EB;
    };
    if (BF16) {
      // straight into the slots, NB tiles ahead; tile t is released to the
      // consumers before the slot of tile t - 1 is refilled, so a consumer
      // never waits on a copy being issued (group k holds tile k)
      auto issue = [&](int t) {
        const char *kg, *vg;
        long long kv_row, pos_row;
        rows_of(t, kg, vg, kv_row, pos_row);
        unsigned char* slot = smem + L::ring + (t % NB) * L::kSlot;
        for (int i = pt; i < kTile * CPR; i += 128) {
          const int so = sw_chunk(i / CPR, i % CPR);
          cp_async16(smem_u32(slot + so), kg + (size_t)i * 16);
          cp_async16(smem_u32(slot + L::kTileB + so), vg + (size_t)i * 16);
        }
        if (pt < 16) cp_async16(smem_u32(slot + L::sl_pos + pt * 16), p.pos + pos_row + pt * 4);
      };
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        if (t < n_tiles) issue(t);
        cp_async_commit();
      }
      for (int t = 0; t < n_tiles; ++t) {
        cp_async_wait<NB - 2>();
        fence_proxy_async();
        mbar_arrive(full + 8 * (t % NB));
        if (t >= 1) {
          if (t - 1 + NB < n_tiles) {
            mbar_wait(empty + 8 * ((t - 1) % NB), ((t - 1) / NB) & 1);
            issue(t - 1 + NB);
          }
          cp_async_commit();
        }
      }
    } else {
      // raw int8 tiles run NR ahead, the stage of tile t refilled once it is
      // converted and released; each thread turns the chunks it copied into
      // the slot (none reads another's); group k holds raw tile k
      auto issue_raw = [&](int t) {
        const char *kg, *vg;
        long long kv_row, pos_row;
        rows_of(t, kg, vg, kv_row, pos_row);
        unsigned char* rs = smem + L::raw + (t % NR) * L::kRaw;
        for (int i = pt; i < kTile * CPR; i += 128) {
          cp_async16(smem_u32(rs + i * 16), kg + (size_t)i * 16);
          cp_async16(smem_u32(rs + L::kRawTile + i * 16), vg + (size_t)i * 16);
        }
        if (pt < 16) {
          cp_async16(smem_u32(rs + L::rw_side + pt * 16), p.ks + kv_row + pt * 4);
          cp_async16(smem_u32(rs + L::rw_side + 256 + pt * 16), p.vs + kv_row + pt * 4);
          cp_async16(smem_u32(rs + L::rw_side + 512 + pt * 16), p.pos + pos_row + pt * 4);
        }
      };
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (i < n_tiles) issue_raw(i);
        cp_async_commit();
      }
      for (int t = 0; t < n_tiles; ++t) {
        cp_async_wait<NR - 1>();
        const int s = t % NB;
        mbar_wait(empty + 8 * s, ((t / NB) & 1) ^ 1);
        const unsigned char* rs = smem + L::raw + (t % NR) * L::kRaw;
        unsigned char* slot = smem + L::ring + s * L::kSlot;
        for (int i = pt; i < kTile * CPR; i += 128) {
          const int row = i / CPR;
          const int c = i % CPR;
#pragma unroll
          for (int which = 0; which < 2; ++which) {
            const uint4 w = *reinterpret_cast<const uint4*>(rs + which * L::kRawTile + i * 16);
            uint4 lo, hi;
            i8x16_to_bf16(w, lo, hi);
            unsigned char* dst = slot + which * L::kTileB;
            *reinterpret_cast<uint4*>(dst + sw_chunk(row, 2 * c)) = lo;
            *reinterpret_cast<uint4*>(dst + sw_chunk(row, 2 * c + 1)) = hi;
          }
        }
        if (pt < 16) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            *reinterpret_cast<uint4*>(slot + L::sl_ks + k * 256 + pt * 16) =
                *reinterpret_cast<const uint4*>(rs + L::rw_side + k * 256 + pt * 16);
          }
        }
        fence_proxy_async();
        mbar_arrive(full + 8 * s);
        // the raw stage of tile t is free (this thread converted its chunks)
        if (t + NR < n_tiles) issue_raw(t + NR);
        cp_async_commit();
      }
    }
    return;
  }

  // ---------------- consumers: QK^T, the online softmax, PV ----------------
  const int rr0 = warp * 16 + g;  // this thread's rows rr0 and rr0 + 8 of the block
  int rp[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + rr0 + 8 * j;
    rp[j] = r < R ? p.row_pos[(size_t)b * R + r] : -1;
  }
  // the warp's least and largest row positions (a padding row makes the
  // least -1: no tile is then wholly visible to the warp)
  const int rp_min = __reduce_min_sync(0xffffffffu, min(rp[0], rp[1]));
  const int rp_max = __reduce_max_sync(0xffffffffu, max(rp[0], rp[1]));

  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 domain), rows rr0, rr0 + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  float acc[ND * 4];                    // O: n-tile j, element e at acc[4 j + e]
#pragma unroll
  for (int i = 0; i < ND * 4; ++i) acc[i] = 0.f;

  const uint32_t q_base = base + L::q + wg * L::kTileB;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % NB;
    mbar_wait(full + 8 * s, (t / NB) & 1);
    const unsigned char* slot = smem + L::ring + s * L::kSlot;
    const uint32_t kt = base + L::ring + s * L::kSlot;
    const uint32_t vt = kt + L::kTileB;
    const float* kss = reinterpret_cast<const float*>(slot + L::sl_ks);
    const float* vss = reinterpret_cast<const float*>(slot + L::sl_vs);
    const int* cps = reinterpret_cast<const int*>(slot + L::sl_pos);

    // S = Q K^T: [64 rows x 64 columns] over Dp / 16 steps (A: Q, B: the K
    // tile, both K-major; a step advances 32 bytes in a 128-byte row, four
    // steps a 64-column sub-tile)
    float sacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk) {
      const uint32_t off = (kk >> 2) * 8192 + (kk & 3) * 32;
      wgmma_ss_n64(sacc, make_desc(q_base + off, 16, 1024), make_desc(kt + off, 16, 1024), kk);
    }
    wgmma_commit();
    // meanwhile: is the tile wholly visible to the warp's rows?
    const int c_lo = __reduce_min_sync(0xffffffffu, min(cps[lane], cps[lane + 32]));
    const int c_hi = __reduce_max_sync(0xffffffffu, max(cps[lane], cps[lane + 32]));
    const bool whole = p.softcap <= 0.f && c_lo >= 0 && c_hi <= rp_min &&
                       (p.window <= 0 || c_lo > rp_max - p.window);
    wgmma_wait0();
    fence_regs(sacc);
    // scale, cap and mask; the rows' new max
    float mx[2] = {m[0], m[1]};
    if (whole) {
      prefill_scores<true, false, BF16>(sacc, mx, kss, cps, rp, p, t4);
    } else if (p.softcap > 0.f) {
      prefill_scores<false, true, BF16>(sacc, mx, kss, cps, rp, p, t4);
    } else {
      prefill_scores<false, false, BF16>(sacc, mx, kss, cps, rp, p, t4);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = mx[i] == -INFINITY ? 1.f : ex2(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    // P (f32 sums), then p * v_scale in bf16: the score accumulator's
    // registers of columns 16 kk .. 16 kk + 15 are PV's A fragment of step kk
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 v2 = make_float2(1.f, 1.f);
      if (!BF16) v2 = *reinterpret_cast<const float2*>(vss + j * 8 + 2 * t4);
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = m[e >> 1] == -INFINITY ? 0.f : ex2(sacc[4 * j + e] - m[e >> 1]);
        l[e >> 1] += pe;
        pv[e] = BF16 ? pe : pe * ((e & 1) ? v2.y : v2.x);
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(pv[0], pv[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    }
    // O += P V over the tile's 64 rows (B: the V tile, MN-major; a step is
    // 16 rows of 128 bytes, the 64-column sub-tiles 8 KB apart)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = make_desc(vt + kk * 2048, 8192, 1024);
      if constexpr (Dp == 64) {
        wgmma_rs_n64(acc, pa[kk], dv);
      } else if constexpr (Dp == 128) {
        wgmma_rs_n128(acc, pa[kk], dv);
      } else {
        wgmma_rs_n256(acc, pa[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the slot
  }

  // the row sums over the quad, the sink term, normalisation
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + rr0 + 8 * i;
    float scale = 1.f;
    if (p.sinks != nullptr && r < R) {
      const float sk = p.sinks[(size_t)h * R + r] * kLog2e;
      const float mf = fmaxf(m[i], sk);
      scale = m[i] == -INFINITY ? 0.f : exp2f(m[i] - mf);
      l[i] = l[i] * scale + exp2f(sk - mf);
    }
    const float inv = l[i] > 0.f ? scale / l[i] : 0.f;
    if (r >= R) continue;
    float* o = p.out + (((size_t)b * p.Hkv + h) * R + r) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(o + j * 8) =
          make_float2(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    }
  }
}

// =========================================================== decode kernel

// Shared memory of a decode block: per warp a ring of 2 chunks (16 KV rows
// of K and V, their scales and positions), for an int8 memory the bf16 K
// and V chunk, and a bf16 P^T buffer [8 rows][16 + 8]. After the tile loop
// the rings hold the warps' merge: acc [4][8][D] f32, m, l [4][8].
template <int D, bool BF16>
struct DecSmem {
  static constexpr int ST = D + 8;
  static constexpr int kBf16Chunk = kChunk * ST * 2;
  static constexpr int kRawChunk = BF16 ? kBf16Chunk : kChunk * D;
  static constexpr int NS = 2;
  static constexpr int st_k = 0;
  static constexpr int st_v = kRawChunk;
  static constexpr int st_ks = 2 * kRawChunk;
  static constexpr int st_vs = st_ks + kChunk * 4;
  static constexpr int st_pos = st_vs + kChunk * 4;
  static constexpr int kStage = st_pos + kChunk * 4;
  static constexpr int kb = NS * kStage;
  static constexpr int vb = kb + (BF16 ? 0 : kBf16Chunk);
  static constexpr int pt = vb + (BF16 ? 0 : kBf16Chunk);
  static constexpr int PST = kChunk + 8;  // P^T row stride, elements
  static constexpr int kWarpBytes = pt + kRowsDec * PST * 2;
  static constexpr int merge_acc = 0;
  static constexpr int merge_m = kWarps * kRowsDec * D * 4;
  static constexpr int merge_l = merge_m + kWarps * kRowsDec * 4;
  static constexpr int merge_bytes = merge_l + kWarps * kRowsDec * 4;
  static constexpr int ring_bytes = kWarps * kWarpBytes;
  static constexpr int bytes = ring_bytes > merge_bytes ? ring_bytes : merge_bytes;
};

template <int D, bool BF16, bool PAGED>
__global__ void __launch_bounds__(kThreads)
fa_decode(const __grid_constant__ Params p) {
  using L = DecSmem<D, BF16>;
  constexpr int ST = L::ST;
  constexpr int NS = L::NS;
  constexpr int EB = BF16 ? 2 : 1;
  constexpr int MT = D / 16;  // output m-tiles (dims) a warp
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[kWarps];
  __shared__ int last_block;
  __shared__ float wts[kMaxSplits][kRowsDec];
  __shared__ float mrow[kRowsDec], lrow[kRowsDec];
  __shared__ int pages[kTableSmem];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int h = blockIdx.y;
  const int n_rg = (p.R + kRowsDec - 1) / kRowsDec;
  const int b = blockIdx.z / n_rg;
  const int rg = blockIdx.z % n_rg;
  const int r0 = rg * kRowsDec;
  const int R = p.R;
  const int nr = min(kRowsDec, R - r0);  // real rows of the block

  // the rows' positions (this thread's score columns are rows 2 t4, 2 t4 + 1)
  if (warp == 0) {
    const int rm = lane < nr ? p.row_pos[(size_t)b * R + r0 + lane] : INT_MIN;
    const int mx = warp_max_int(rm);
    if (lane == 0) red[0] = mx;
  }
  int rp[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int rr = 2 * t4 + j;
    rp[j] = rr < nr ? p.row_pos[(size_t)b * R + r0 + rr] : -1;
  }
  // Q^T as the MMA's B fragments, straight from device memory: b0 = dims
  // 16 kk + 2 t4 (+1) of row g, b1 = dims + 8
  uint32_t qb[MT][2];
  {
    const __nv_bfloat16* qr = p.q + (((size_t)b * p.Hkv + h) * R + r0 + g) * D;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      qb[kk][0] = g < nr ? *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 2 * t4) : 0u;
      qb[kk][1] = g < nr ? *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8 + 2 * t4) : 0u;
    }
  }
  // the page table row (or the sequence) before the live limit is known
  if (PAGED) {
    for (int i = tid; i < min(p.lay.MP, kTableSmem); i += kThreads) {
      pages[i] = p.index[(size_t)b * p.lay.MP + i];
    }
  }
  const long long seq = PAGED ? 0 : min(max(p.index[b], 0), p.lay.n_seqs - 1);
  __syncthreads();
  const int n_tiles = live_tiles<PAGED>(p.lay, red[0]);
  const int tps = (n_tiles + splits - 1) / splits;
  const int t_begin = split * tps;
  const int t_end = min(t_begin + tps, n_tiles);

  unsigned char* ws = smem + warp * L::kWarpBytes;
  // chunk `warp` of tile t -> this warp's stage i % NS
  auto issue = [&](int t, int i) {
    long long kv_row, pos_row;
    if (PAGED) {
      page_rows(p, pages, b, h, t, kv_row, pos_row);
    } else {
      slot_rows(p, h, seq, t, kv_row, pos_row);
    }
    kv_row += warp * kChunk;
    pos_row += warp * kChunk;
    unsigned char* st = ws + (i % NS) * L::kStage;
    const char* kg = static_cast<const char*>(p.k) + (size_t)kv_row * D * EB;
    const char* vg = static_cast<const char*>(p.v) + (size_t)kv_row * D * EB;
    constexpr int CPR = D * EB / 16;
    for (int c = lane; c < kChunk * CPR; c += 32) {
      const int row = c / CPR;
      const int so = BF16 ? row * ST * 2 + (c % CPR) * 16 : c * 16;
      cp_async16(smem_u32(st + L::st_k + so), kg + (size_t)c * 16);
      cp_async16(smem_u32(st + L::st_v + so), vg + (size_t)c * 16);
    }
    if (lane < 4) {
      cp_async16(smem_u32(st + L::st_pos + lane * 16), p.pos + pos_row + lane * 4);
      if (!BF16) {
        cp_async16(smem_u32(st + L::st_ks + lane * 16), p.ks + kv_row + lane * 4);
        cp_async16(smem_u32(st + L::st_vs + lane * 16), p.vs + kv_row + lane * 4);
      }
    }
  };

  float m[2] = {-INFINITY, -INFINITY};  // rows 2 t4, 2 t4 + 1 (log2 domain)
  float l[2] = {0.f, 0.f};              // this thread's share (KV rows g, g + 8)
  float acc[MT][4];                     // O^T: dims 16 mt + g (+8), rows 2 t4 (+1)
#pragma unroll
  for (int j = 0; j < MT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_my = max(t_end - t_begin, 0);
  if (n_my > 0) issue(t_begin, 0);
  cp_async_commit();
  unsigned char* ptb = ws + L::pt;
  for (int i = 0; i < n_my; ++i) {
    if (i + 1 < n_my) issue(t_begin + i + 1, i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    unsigned char* st = ws + (i % NS) * L::kStage;
    unsigned char* kt = BF16 ? st + L::st_k : ws + L::kb;
    unsigned char* vt = BF16 ? st + L::st_v : ws + L::vb;
    if (!BF16) {
      for (int c = lane; c < 2 * kChunk * D / 16; c += 32) {
        const int which = c / (kChunk * D / 16);
        const int j = c % (kChunk * D / 16);
        const uint4 w = *reinterpret_cast<const uint4*>(st + (which ? L::st_v : L::st_k) + j * 16);
        uint4 lo, hi;
        i8x16_to_bf16(w, lo, hi);
        unsigned char* dst = (which ? vt : kt) + ((j / (D / 16)) * ST + (j % (D / 16)) * 16) * 2;
        *reinterpret_cast<uint4*>(dst) = lo;
        *reinterpret_cast<uint4*>(dst + 16) = hi;
      }
      __syncwarp();
    }
    const float* kss = reinterpret_cast<const float*>(st + L::st_ks);
    const float* vss = reinterpret_cast<const float*>(st + L::st_vs);
    const int* cps = reinterpret_cast<const int*>(st + L::st_pos);
    // S^T [16 KV rows x 8 query rows] = K Q^T
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t k_base = smem_u32(kt);
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, k_base + ((lane & 15) * ST + kk * 16 + (lane >> 4) * 8) * 2);
      mma_bf16(s, a, qb[kk][0], qb[kk][1]);
    }
    // s[e]: KV row g + 8 (e >> 1), query row 2 t4 + (e & 1)
    float mx[2] = {m[0], m[1]};
    if (p.softcap > 0.f) {
      decode_scores<true, BF16>(s, mx, kss, cps, rp, p, g);
    } else {
      decode_scores<false, BF16>(s, mx, kss, cps, rp, p, g);
    }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
      alpha[j] = mx[j] == -INFINITY ? 1.f : exp2f(m[j] - mx[j]);
      m[j] = mx[j];
      l[j] *= alpha[j];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] *= alpha[e & 1];
    }
    // P^T -> bf16 [query row][KV row] in shared memory, then B fragments
    __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(ptb);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kv = g + 8 * (e >> 1);
      const float pe = m[e & 1] == -INFINITY ? 0.f : ex2(s[e] - m[e & 1]);
      l[e & 1] += pe;
      pt[(2 * t4 + (e & 1)) * L::PST + kv] = __float2bfloat16_rn(BF16 ? pe : pe * vss[kv]);
    }
    __syncwarp();
    uint32_t pb[2];
    ldsm_x2(pb, smem_u32(ptb) + ((lane & 7) * L::PST + ((lane >> 3) & 1) * 8) * 2);
    // O^T [D x 8] += V^T [D x 16] P^T [16 x 8]
    const uint32_t v_base = smem_u32(vt);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldsm_x4_t(a, v_base + (((lane >> 4) * 8 + (lane & 7)) * ST + mt * 16 + ((lane >> 3) & 1) * 8) * 2);
      mma_bf16(acc[mt], a, pb[0], pb[1]);
    }
    __syncwarp();  // the stage and P^T are free for the next chunk
  }
  cp_async_wait<0>();
  // this warp's row sums over its 16 KV rows
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) l[j] += __shfl_xor_sync(0xffffffffu, l[j], o);
  }
  __syncthreads();  // every ring is free: the warps' merge goes there
  float* macc = reinterpret_cast<float*>(smem + L::merge_acc);
  float* mm = reinterpret_cast<float*>(smem + L::merge_m);
  float* ml = reinterpret_cast<float*>(smem + L::merge_l);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = mt * 16 + g + 8 * (e >> 1);
      macc[(warp * kRowsDec + 2 * t4 + (e & 1)) * D + d] = acc[mt][e];
    }
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mm[warp * kRowsDec + 2 * t4 + j] = m[j];
      ml[warp * kRowsDec + 2 * t4 + j] = l[j];
    }
  }
  __syncthreads();
  // the block's (max, sum) per row, then its acc; with one split, the sink
  // and the normalisation here, else the partials
  if (tid < kRowsDec) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mm[w * kRowsDec + tid]);
    float Ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = M == -INFINITY ? 0.f : exp2f(mm[w * kRowsDec + tid] - M);
      wts[w][tid] = wt;
      Ls += ml[w * kRowsDec + tid] * wt;
    }
    mrow[tid] = M;
    lrow[tid] = Ls;
  }
  __syncthreads();
  const size_t bh = (size_t)b * p.Hkv + h;
  auto finish = [&](int rr, float M, float Ls, float& inv, float& scale) {
    scale = 1.f;
    if (p.sinks != nullptr) {
      const float sk = p.sinks[(size_t)h * R + r0 + rr] * kLog2e;
      const float mf = fmaxf(M, sk);
      scale = M == -INFINITY ? 0.f : exp2f(M - mf);
      Ls = Ls * scale + exp2f(sk - mf);
    }
    inv = Ls > 0.f ? scale / Ls : 0.f;
  };
  if (splits == 1) {
    for (int i = tid; i < nr * D; i += kThreads) {
      const int rr = i / D;
      const int d = i % D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += macc[(w * kRowsDec + rr) * D + d] * wts[w][rr];
      float inv, scale;
      finish(rr, mrow[rr], lrow[rr], inv, scale);
      p.out[(bh * R + r0 + rr) * D + d] = a * inv;
    }
    return;
  }
  const size_t n_rows = (size_t)p.B * p.Hkv * R;
  if (t_begin < n_tiles) {
    for (int i = tid; i < nr * D; i += kThreads) {
      const int rr = i / D;
      const int d = i % D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += macc[(w * kRowsDec + rr) * D + d] * wts[w][rr];
      p.part_acc[(split * n_rows + bh * R + r0 + rr) * D + d] = a;
    }
    if (tid < nr) {
      p.part_ml[split * n_rows + bh * R + r0 + tid] = mrow[tid];
      p.part_ml[((size_t)splits + split) * n_rows + bh * R + r0 + tid] = lrow[tid];
    }
  }
  // the last block of this (b, h, row group) merges the splits in order
  __threadfence();
  __syncthreads();
  const size_t cidx = bh * n_rg + rg;
  if (tid == 0) last_block = atomicAdd(&p.counters[cidx], 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int n_live = tps > 0 ? (n_tiles + tps - 1) / tps : 0;  // splits that hold tiles
  // a warp a row: the splits' (max, sum) with a lane a split, all loads in
  // flight at once
  for (int rr = warp; rr < nr; rr += kWarps) {
    const size_t row = bh * R + r0 + rr;
    float ms[kMaxSplits / 32], ls[kMaxSplits / 32];
    float M = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxSplits / 32; ++k) {
      const int s2 = lane + 32 * k;
      ms[k] = s2 < n_live ? __ldcg(p.part_ml + s2 * n_rows + row) : -INFINITY;
      ls[k] = s2 < n_live ? __ldcg(p.part_ml + ((size_t)splits + s2) * n_rows + row) : 0.f;
      M = fmaxf(M, ms[k]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float Ls = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxSplits / 32; ++k) {
      const float wt = M == -INFINITY ? 0.f : exp2f(ms[k] - M);
      if (lane + 32 * k < kMaxSplits) wts[lane + 32 * k][rr] = wt;
      Ls += ls[k] * wt;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) Ls += __shfl_xor_sync(0xffffffffu, Ls, o);
    if (lane == 0) {
      mrow[rr] = M;
      lrow[rr] = Ls;
    }
  }
  __syncthreads();
  // the accumulators, eight splits' loads in flight a thread
  for (int i = tid; i < nr * D; i += kThreads) {
    const int rr = i / D;
    const size_t off = (bh * R + r0 + rr) * D + i % D;
    float a = 0.f;
    for (int s0 = 0; s0 < n_live; s0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u] = s0 + u < n_live ? __ldcg(p.part_acc + (s0 + u) * n_rows * D + off) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) a += s0 + u < n_live ? v[u] * wts[s0 + u][rr] : 0.f;
    }
    float inv, scale;
    finish(rr, mrow[rr], lrow[rr], inv, scale);
    p.out[off] = a * inv;
  }
  if (tid == 0) p.counters[cidx] = 0;  // ready for the next launch
}

// ================================================================= launch

// one instantiation: its dynamic shared memory is allowed once a device (a
// bit of `done` each; static and dynamic together may pass 48 KB)
template <typename K>
cudaError_t allow_smem(K* kern, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <int D, bool BF16, bool PAGED>
cudaError_t run(const Params& p, int prefill, cudaStream_t st) {
  if (prefill) {
    static unsigned long long ready = 0;
    constexpr int bytes = PreSmem<D, BF16>::bytes;
    auto* kern = fa_prefill<D, BF16, PAGED>;
    cudaError_t err = allow_smem(kern, bytes, ready);
    if (err != cudaSuccess) return err;
    using L = PreSmem<D, BF16>;
    const dim3 grid((p.R + L::kRows - 1) / L::kRows, p.Hkv, p.B);
    kern<<<grid, L::kThreads, bytes, st>>>(p);
    return cudaGetLastError();
  }
  static unsigned long long ready = 0;
  constexpr int bytes = DecSmem<D, BF16>::bytes;
  auto* kern = fa_decode<D, BF16, PAGED>;
  cudaError_t err = allow_smem(kern, bytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.splits, p.Hkv, p.B * ((p.R + kRowsDec - 1) / kRowsDec));
  kern<<<grid, kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

template <int D, bool PAGED>
cudaError_t run_d(const Params& p, int prefill, int bf16_kv, cudaStream_t st) {
  return bf16_kv ? run<D, true, PAGED>(p, prefill, st) : run<D, false, PAGED>(p, prefill, st);
}

// Launch the prefill kernel (prefill != 0) or the decode kernel for head
// dim 32, 64, 128 or 256 and an int8 or bf16 memory. Returns
// cudaGetLastError().
template <bool PAGED>
int launch(const Params& p, int D, int prefill, int bf16_kv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.B <= 0 || p.R <= 0 || p.Hkv <= 0 || p.lay.S % kTile != 0 ||
      (bf16_kv == 0) != (p.ks != nullptr && p.vs != nullptr) ||
      (D != 32 && D != 64 && D != 128 && D != 256) ||
      (!prefill && (p.splits <= 0 || p.splits > kMaxSplits ||
                    (p.splits > 1 && (p.part_acc == nullptr || p.part_ml == nullptr ||
                                      p.counters == nullptr))))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  switch (D) {
    case 32: err = run_d<32, PAGED>(p, prefill, bf16_kv, st); break;
    case 64: err = run_d<64, PAGED>(p, prefill, bf16_kv, st); break;
    case 128: err = run_d<128, PAGED>(p, prefill, bf16_kv, st); break;
    default: err = run_d<256, PAGED>(p, prefill, bf16_kv, st); break;
  }
  return (int)err;
}

// dynamic shared memory of a block (tests hold the budget to the card's)
inline int smem_bytes(int D, int prefill, int bf16_kv) {
#define FA_SMEM(DD)                                                                   \
  if (D == DD) {                                                                      \
    if (prefill) return bf16_kv ? PreSmem<DD, true>::bytes : PreSmem<DD, false>::bytes; \
    return bf16_kv ? DecSmem<DD, true>::bytes : DecSmem<DD, false>::bytes;            \
  }
  FA_SMEM(32)
  FA_SMEM(64)
  FA_SMEM(128)
  FA_SMEM(256)
#undef FA_SMEM
  return -1;
}

}  // namespace fa
