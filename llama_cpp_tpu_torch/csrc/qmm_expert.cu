// Indexed-expert fused dequantize + matmul over stacked int8 weight planes,
// for Hopper: row r of the output is x[r] . W[ids[r]], in one launch.
//
// Replaces the TPU Pallas kernel qmm_planes_expert of
// llama_cpp_tpu/ops/pallas/qmm.py (_qmm_id_kernel, _qmm_id_min_kernel), the
// MoE decode product (GGML_OP_MUL_MAT_ID analog) that streams only the
// selected experts' planes.
//
// Function: y[R, O] (f32), y[r] = x[r] (bf16) . W[e], e = ids[r] clamped to
// [0, E), where
//   W[e][k, o] = q[e, k, o] * scales[e, k/g, o] + mins[e, k/g, o]   (mins or 0)
// over int8 planes q [E, K, O] with flat f32 scales (and mins) [E, K/g, O],
// g = 16 or 32, K a multiple of the 64-row stage and O of 64 (the last column
// tile half full where O % 128 = 64: its TMA boxes read zeros past O and its
// columns there are never stored). The TPU kernel rounds q * scale to bf16 before its dot; this
// kernel keeps q exact and scales each group's f32 sum once (an NMSE near
// 1e-6 from the plain version, ops/kernels/qmm_expert.py).
//
// What bounds it on an H100: bytes, each distinct expert's planes read once
// (1.25 B a weight at g=32 with mins, 1.25 at g=16 without) over 3.35 TB/s;
// at small experts (768-2048 wide) the start-up of a block (ids, then the
// first copies: two trips to memory) and a short K range.
//
// Design (the decode kernel's, csrc/qmm_decode.cu, with the plane rows offset
// by the expert):
//  * Work unit: (column tile of 128, expert group, K range). An expert group
//    is up to 8 rows that picked one expert: every block reads ids itself,
//    numbers each row among its expert's rows in row order, and a row whose
//    number is a multiple of 8 leads a group of itself and the next 7 rows
//    of its expert (so a ninth row starts a second group). Groups are
//    numbered in leader row order: no host round trip, no sort pass, and a
//    fixed summation order.
//  * The grid is persistent: at most the blocks the card holds at once, as
//    many as the units distinct experts would give (the wrapper sizes it),
//    so no block exists for a row that leads no group. A block's first unit
//    is its index; its producer fetches each next one from a self-resetting
//    work counter once the current one is issued, so blocks that share an
//    SM or fall behind take fewer units. Units run column tile fastest, so
//    the blocks streaming at one time read whole plane rows together. K is
//    split by split_count, a rule measured on the card that every block
//    evaluates alike.
//  * Where the rows may pick distinct experts (a decode token's top-k do),
//    a block's first copies go out before the group table, which costs a
//    trip to memory and some microseconds: with distinct experts group g is
//    row g. The table then says whether the guess held; if not, the
//    consumers skip those stages.
//  * One thread of a producer warp issues the plane rows [64, 128] (128-byte
//    swizzle) and their scale and min rows by TMA from one 2-D tensor map
//    over the whole stack, [E*K, O] and [E*K/g, O], at row e*K + k; the
//    warp's 32 lanes stage the group's x rows [8, 64 k] by cp.async, tracked
//    by the same mbarrier. A ring of 6 stages runs on across units; each
//    stage carries its unit and stage number, and a stage with none stops
//    the consumers.
//  * Eight consumer warps run mma.sync m16n8k16 with the weight columns in M
//    and the group's rows in the n8 slot (swap-AB). An int8 byte goes in as
//    the two nibbles of q + 128 in the mantissas of bf16 128.0 and 2048.0,
//    by two MMAs into two f32 sums that add to 2304 + q; each group's sums
//    start from zero and are scaled once in f32, the bias and the mins
//    leaving through the group sums of x (one more MMA against ones). The
//    two warps of a 32-column slice take half of a stage's groups each.
//  * At a unit's end the consumers leave their sums in one of two shared
//    buffers and go on; an epilogue warp adds the two warps of each slice
//    and stores the group's rows, or a split's partial sums, of which the
//    last split of each (column tile, group) adds all in split order and
//    resets its counter: one launch a call, and the fence and atomic of a
//    split stay off the consumers' path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>
#include <string.h>

#include "tma_ring.cuh"

namespace {

constexpr int kBN = 128;                 // output columns per block
constexpr int kRows = 64;                // plane rows per stage
constexpr int kWarps = 8;                // consumers: two warps a 32-column slice
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 64;  // + the producer and epilogue warps
constexpr int kSlice = 128;              // the threads of one warp per slice
constexpr int kStages = 6;
constexpr int kGroupRows = 8;            // rows of one expert in one pass (n8)
constexpr int kMaxRows = 512;
constexpr int kMaxSplits = 16;
constexpr int kPlaneBytes = kRows * kBN;  // 8 KB, 128-byte swizzled
// a stage's scales at 0, mins at 2048 (up to 4 rows of 128 f32 each), x at
// 4096: 8 rows of 64 bf16 at a pitch of 144 bytes, so the B-fragment loads
// of the 8 rows fall in distinct banks
constexpr int kMnOff = 2048;
constexpr int kXOff = 4096;
constexpr int kXPitch = 144;
constexpr int kHdrOff = 5248;            // the stage's unit and its stage number (2 ints)
constexpr int kAuxBytes = 5376;          // 42 x 128
// an epilogue buffer: the consumers' sums, [wpart][8 values][128 slice
// threads + a float skipped every 32]; two of them
constexpr int kEpiPitch = 132;
constexpr int kEpiFloats = 2 * 8 * kEpiPitch;
constexpr int kEpiBytes = 2 * kEpiFloats * 4;
constexpr int kSmemBytes =
    1024 + kStages * (kPlaneBytes + kAuxBytes) + kEpiBytes + 16 * kStages + 32;

// K splits at (col_tiles x n_groups) pairs and k_units stages of 64 rows,
// with units = pairs x s fed to `slots` blocks. Sweeps of s on an H100 at
// the Mixtral-8x7B and Qwen3-30B-A3B expert shapes (PERF.md) found three
// things: a partial second wave (1.1 to 1.9 slots' worth of units) is slow;
// a unit of 64 stages or more leaves the blocks that share an SM finishing
// last, with nothing left to balance them; past that the fewest splits win
// once the units fill about half the slots (splitting costs a merge). So:
// the smallest divisor s of k_units (up to kMaxSplits) whose units are
// shorter than 64 stages and fill at least 45% of the slots (70% when
// split) outside that band; else the most splits that stay within one wave.
// split_kind: 2 for such an s, 1 for one that stays within a wave, 0
// otherwise. 32-bit: 100 * units stays under 2^27. ops/kernels/qmm_expert.py
// split_count is the same rule.
__host__ __device__ inline int split_kind(int col_tiles, int n_groups, int k_units, int slots,
                                          int s) {
  if (s > k_units || s > kMaxSplits || k_units % s) return 0;
  const int u100 = 100 * col_tiles * n_groups * s;
  const bool second_wave = u100 > 110 * slots && u100 < 190 * slots;
  if (!second_wave && k_units / s < 64 && u100 >= (s == 1 ? 45 : 70) * slots) return 2;
  return u100 < 110 * slots ? 1 : 0;
}

__host__ __device__ inline int split_count(int col_tiles, int n_groups, int k_units, int slots) {
  int fallback = 1;
  for (int s = 1; s <= kMaxSplits; ++s) {
    const int kind = split_kind(col_tiles, n_groups, k_units, slots, s);
    if (kind == 2) return s;
    if (kind == 1) fallback = s;
  }
  return fallback;
}

// split_count by 16 lanes of a warp at once (a serial loop of integer
// divisions takes a microsecond on one thread); every lane gets the result
__device__ __forceinline__ int split_count_warp(int col_tiles, int n_groups, int k_units,
                                                int slots, int lane) {
  const int kind = split_kind(col_tiles, n_groups, k_units, slots, (lane & 15) + 1);
  const unsigned accept = __ballot_sync(0xffffffffu, kind == 2) & 0xffffu;
  if (accept) return __ffs(accept);
  const unsigned wave = __ballot_sync(0xffffffffu, kind == 1) & 0xffffu;
  return wave ? 32 - __clz(wave) : 1;
}

// 16 bytes global -> shared, zeros where !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// one arrival on `bar` when this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte c of w0 and of w1 in the low bytes of the two 16-bit lanes: the
// weights of one column at rows k and k + 1, an A-fragment register's pair
__device__ __forceinline__ uint32_t pair_rows(uint32_t w0, uint32_t w1, int c) {
  return __byte_perm(w0, w1, c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12));
}

// bf16x2 of the low nibbles of a pair_rows word: 128 + n, exact
__device__ __forceinline__ uint32_t lo_nibbles(uint32_t v) {
  return (v & 0x000F000Fu) | 0x43004300u;
}

// bf16x2 of the high nibble of w + 128 in the mantissa of 2048.0: 2048 + 16 (n ^ 8)
__device__ __forceinline__ uint32_t hi_nibbles(uint32_t v) {
  return ((v >> 4) & 0x000F000Fu) ^ 0x45084508u;
}

// a unit's coordinates: split `sp` of column tile `o_blk` for group `gi`;
// the column tile runs fastest, so the blocks that stream at one time read
// whole rows of the planes together
struct Unit {
  int sp, pair, o_blk, gi;
};

__device__ __forceinline__ Unit unit_of(int u, int splits, int col_tiles) {
  Unit w;
  const int c = u % col_tiles, rest = u / col_tiles;
  w.sp = rest % splits;
  w.gi = rest / splits;
  w.o_blk = c * kBN;
  w.pair = w.gi * col_tiles + c;
  return w;
}

template <int G, bool MINS>
__global__ void __launch_bounds__(kThreads, 2)
qmm_expert_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_sc,
                  const __grid_constant__ CUtensorMap tm_mn, const __nv_bfloat16* __restrict__ x,
                  const int* __restrict__ ids, float* __restrict__ out,
                  float* __restrict__ part, int* __restrict__ counters, int R, int E, int K, int O,
                  int slots, int max_splits, int hint_splits) {
  constexpr int kChunks = kRows / G;         // scale groups a stage
  constexpr int kWarpChunks = kChunks / 2;   // each warp of a slice takes half
  constexpr int kAllWarps = kThreads / 32;
  constexpr float kBias = 2304.f;
  extern __shared__ unsigned char smem_raw[];
  __shared__ short ex[kMaxRows];            // each row's expert, clamped
  __shared__ short rank_s[kMaxRows];        // a row's number among its expert's rows
  __shared__ short lead_row[kMaxRows];      // the row that leads a row's group
  __shared__ unsigned char lead_size[kMaxRows];  // rows of the group a row leads, else 0
  __shared__ short gidx[kMaxRows];          // a leader's group number
  __shared__ short gexp[kMaxRows];          // each group's expert
  __shared__ unsigned char gsize[kMaxRows]; // each group's rows
  __shared__ short members[kMaxRows][kGroupRows];
  __shared__ int n_groups_s;
  __shared__ int epi_unit[2];               // the unit in each epilogue buffer, -1: stop
  // swizzled plane tiles need 1024-byte alignment
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_addr);
  unsigned char* aux = smem + kStages * kPlaneBytes;
  const uint32_t aux_base = base + kStages * kPlaneBytes;
  float* ebuf = reinterpret_cast<float*>(aux + kStages * kAuxBytes);
  const uint32_t full = aux_base + kStages * kAuxBytes + kEpiBytes;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t epi_full = empty + 8 * kStages, epi_free = epi_full + 16;
  // counters[0]: units handed out past the first gridDim.x; [1]: blocks done
  // fetching (the last resets both); [2 + pair]: splits of a pair stored
  int* work = counters;
  int* pair_done = counters + 2;
  const int tid = threadIdx.x;
  const int wid = tid >> 5, wlane = tid & 31;

  const int col_tiles = (O + kBN - 1) / kBN;  // the last one half full where O % 128 = 64
  const int k_units = K / kRows;
  const uint32_t stage_bytes = kPlaneBytes + kChunks * kBN * 4 * (MINS ? 2 : 1);
  const int n0 = wlane >> 3, ch = wlane & 7;  // a producer lane's x chunks: rows n0, n0 + 4
  // stage `it` (ring slot it % kStages), the j-th of unit u: lane 0 writes
  // its header and issues the plane, scale and min rows at plane row rb by
  // TMA, every lane copies its two x chunks (a null row: zeros)
  auto issue = [&](int it, int u, int j, int o_blk, int rb, const __nv_bfloat16* x0,
                   const __nv_bfloat16* x1) {
    const int s = it % kStages;
    if (it >= kStages) mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
    const uint32_t bar = full + 8 * s;
    const uint32_t ad = aux_base + s * kAuxBytes;
    if (wlane == 0) {
      int* hdr = reinterpret_cast<int*>(aux + s * kAuxBytes + kHdrOff);
      hdr[0] = u;
      hdr[1] = j;
      mbar_expect_tx(bar, stage_bytes);
      tma_load(base + s * kPlaneBytes, &tm_q, o_blk, rb, bar);
      tma_load(ad, &tm_sc, o_blk, rb / G, bar);
      if (MINS) tma_load(ad + kMnOff, &tm_mn, o_blk, rb / G, bar);
    }
    const uint32_t xd = ad + kXOff + n0 * kXPitch + ch * 16;
    cp_async16(xd, x0 ? x0 + j * kRows : x, x0 != nullptr);
    cp_async16(xd + 4 * kXPitch, x1 ? x1 + j * kRows : x, x1 != nullptr);
    cp_async_arrive(bar);
  };

  if (tid == kConsumers) {
    prefetch_map(&tm_q);
    prefetch_map(&tm_sc);
    if (MINS) prefetch_map(&tm_mn);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // lane 0's expect_tx arrive and 32 cp.async arrivals
      mbar_init(empty + 8 * s, kWarps);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(epi_full + 8 * b, kWarps);
      mbar_init(epi_free + 8 * b, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // ---- the block's first unit as if the rows picked distinct experts (a
  // decode token's top-k do; hint_splits > 0: the split at R groups): group
  // g is row g, so its first stages need no group table and go out before
  // it. Once the table is built every thread knows whether the guess held
  // (R groups); if not, the consumers skip those stages ----
  const int hint_units = hint_splits > 0 ? col_tiles * R * hint_splits : 0;
  const int n_spec = (int)blockIdx.x < hint_units ? min(k_units / hint_splits, kStages) : 0;
  if (wid == kWarps && n_spec > 0) {
    __syncwarp();  // the barriers lane 0 set up
    const Unit w = unit_of(blockIdx.x, hint_splits, col_tiles);
    const int k0 = w.sp * (k_units / hint_splits) * kRows;
    const int row0 = (wlane == 0 ? min(max(ids[w.gi], 0), E - 1) : 0) * K + k0;
    const __nv_bfloat16* x0 = n0 == 0 ? x + (size_t)w.gi * K + k0 + ch * 8 : nullptr;
    for (int j = 0; j < n_spec; ++j) {
      issue(j, blockIdx.x, j, w.o_blk, row0 + j * kRows, x0, nullptr);
    }
  }

  // ---- the groups: every block numbers the rows alike ----
  for (int r = tid; r < R; r += kThreads) ex[r] = (short)min(max(ids[r], 0), E - 1);
  __syncthreads();
  // a thread a row: its number among its expert's rows, their count, and
  // its group's leader (the last row of its expert up to it whose number is
  // a multiple of 8), in one scan of the rows (read by all lanes at once)
  for (int r = tid; r < R; r += kThreads) {
    const int e = ex[r];
    int rank = 0, count = 0, lead = r;
    for (int j = 0; j < R; ++j) {
      const bool m = ex[j] == e;
      if (m && j <= r && (count & (kGroupRows - 1)) == 0) lead = j;
      rank += m && j < r;
      count += m;
    }
    rank_s[r] = (short)rank;
    lead_row[r] = (short)lead;
    lead_size[r] = rank % kGroupRows == 0 ? min(kGroupRows, count - rank) : 0;
  }
  __syncthreads();
  if (wid == 0) {
    int running = 0;
    for (int b = 0; b < R; b += 32) {
      const int r = b + wlane;
      const bool lead = r < R && lead_size[r] > 0;
      const unsigned m = __ballot_sync(0xffffffffu, lead);
      if (lead) gidx[r] = (short)(running + __popc(m & ((1u << wlane) - 1u)));
      running += __popc(m);
    }
    if (wlane == 0) n_groups_s = running;
  }
  __syncthreads();
  // each row into its group's list; each leader names its group's expert
  for (int r = tid; r < R; r += kThreads) {
    const int gi = gidx[lead_row[r]];
    members[gi][rank_s[r] % kGroupRows] = (short)r;
    if (lead_row[r] == r) {
      gexp[gi] = ex[r];
      gsize[gi] = lead_size[r];
    }
  }
  __syncthreads();

  int splits = min(split_count_warp(col_tiles, n_groups_s, k_units, slots, wlane), max_splits);
  while (k_units % splits) --splits;
  const int sps = k_units / splits;  // stages a unit
  const int n_units = col_tiles * n_groups_s * splits;
  const bool spec_ok = n_spec > 0 && n_groups_s == R && splits == hint_splits;

  if (wid == kWarps) {
    // ---- producer warp: the block's first unit is blockIdx.x (its first
    // stages already out if the guess held), each next one fetched from the
    // work counter once the current one's copies are issued (the release of
    // the next expect_tx would wait for the atomic: behind a full ring it
    // costs nothing) ----
    int it = n_spec;
    int j0 = spec_ok ? n_spec : 0;
    int u = blockIdx.x;
    while (u < n_units) {
      const Unit w = unit_of(u, splits, col_tiles);
      const int nr = gsize[w.gi];
      const int k0 = w.sp * sps * kRows;
      const int row0 = gexp[w.gi] * K + k0;  // plane row in the [E*K, O] map
      const __nv_bfloat16* x0 =
          n0 < nr ? x + (size_t)members[w.gi][n0] * K + k0 + ch * 8 : nullptr;
      const __nv_bfloat16* x1 =
          n0 + 4 < nr ? x + (size_t)members[w.gi][n0 + 4] * K + k0 + ch * 8 : nullptr;
      for (int j = j0; j < sps; ++j, ++it) issue(it, u, j, w.o_blk, row0 + j * kRows, x0, x1);
      j0 = 0;
      int next = 0;
      if (wlane == 0) next = (int)gridDim.x + atomicAdd(work, 1);
      u = __shfl_sync(0xffffffffu, next, 0);
    }
    // a last stage with no unit tells the consumers to stop
    const int s = it % kStages;
    if (it >= kStages) mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
    if (wlane == 0) {
      reinterpret_cast<int*>(aux + s * kAuxBytes + kHdrOff)[0] = -1;
      mbar_arrive(full + 8 * s);
      __threadfence();
      if (atomicAdd(work + 1, 1) == (int)gridDim.x - 1) {  // every block has fetched its last
        atomicExch(work, 0);
        atomicExch(work + 1, 0);
      }
    }
    mbar_arrive(full + 8 * s);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  if (wid == kWarps + 1) {
    // ---- epilogue warp: each unit's sums from the consumers' buffer; the
    // two warps of a slice add up; the group's rows go to the output (or a
    // split's partial sums, and the last split of a pair adds them all in
    // split order); a lane a float4 of a row ----
    const int lane = wlane;
    const int k = (lane >> 3) * 32 + (lane & 7) * 4;  // slice thread of column 4 lane, t = 0
    for (int n = 0;; ++n) {
      const int b = n & 1;
      mbar_wait(epi_full + 8 * b, (n >> 1) & 1);
      const int u = epi_unit[b];
      if (u < 0) break;
      const Unit w = unit_of(u, splits, col_tiles);
      const int nr = gsize[w.gi];
      const float* eb = ebuf + b * kEpiFloats;
      float* dst = splits > 1 ? part + (size_t)w.sp * R * O : out;
      // a lane's 4 columns lie wholly before O or wholly past it (O % 64 = 0)
      const bool live = w.o_blk + 4 * lane < O;
      for (int r = 0; r < nr && live; ++r) {
        const int j = r & 1;
        const int kk = k + (r >> 1);  // the slice thread with t = r / 2
        const float* e0 = eb + kk + (kk >> 5);
        const float* e1 = e0 + 8 * kEpiPitch;
        const float4 v = make_float4(e0[j * kEpiPitch] + e1[j * kEpiPitch],
                                     e0[(2 + j) * kEpiPitch] + e1[(2 + j) * kEpiPitch],
                                     e0[(4 + j) * kEpiPitch] + e1[(4 + j) * kEpiPitch],
                                     e0[(6 + j) * kEpiPitch] + e1[(6 + j) * kEpiPitch]);
        *reinterpret_cast<float4*>(dst + (size_t)members[w.gi][r] * O + w.o_blk + 4 * lane) = v;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(epi_free + 8 * b);  // the buffer is read
      if (splits == 1) continue;
      __threadfence();
      int last = 0;
      if (lane == 0) last = atomicAdd(&pair_done[w.pair], 1) == splits - 1;
      if (!__shfl_sync(0xffffffffu, last, 0)) continue;
      __threadfence();
      const size_t stride = (size_t)R * O;
      for (int r = 0; r < nr && live; ++r) {
        const size_t off = (size_t)members[w.gi][r] * O + w.o_blk + 4 * lane;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int sp = 0; sp < splits; sp += 4) {
          float4 v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = sp + i < splits
                       ? __ldcg(reinterpret_cast<const float4*>(part + (sp + i) * stride + off))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sum.x += v[i].x; sum.y += v[i].y; sum.z += v[i].z; sum.w += v[i].w;
          }
        }
        *reinterpret_cast<float4*>(out + off) = sum;
      }
      if (lane == 0) pair_done[w.pair] = 0;  // ready for the next launch
    }
    return;
  }

  // ---- consumer warps ----
  const int warp = wid;
  const int lane = wlane;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col = (warp & 3) * 32 + 4 * g;  // this thread's 4 columns in the tile
  const int wpart = warp >> 2;
  const int gc0 = wpart * kWarpChunks;      // the warp's first group of a stage
  constexpr uint32_t kOnes = 0x3F803F80u;   // bf16x2 (1, 1)
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
  // offsets in a stage: plane rows 2t and 2t + 1 (of each 8) at columns col
  // .. col + 3 under the swizzle; x row g at k 2t
  const int woff0 = (2 * t) * 128 + ((((col >> 4) ^ (2 * t)) & 7) << 4) + (col & 15);
  const int woff1 = (2 * t + 1) * 128 + ((((col >> 4) ^ (2 * t + 1)) & 7) << 4) + (col & 15);
  const int xoff = kXOff + g * kXPitch + 4 * t;
  // this thread's sums in an epilogue buffer: [wpart][e][slice thread], a
  // float skipped every 32 so that the epilogue warp's reads fall in
  // distinct banks
  const int k = tid & (kSlice - 1);
  const int eoff = wpart * 8 * kEpiPitch + k + (k >> 5);

  float acc[2][4];
  int n_done = 0;  // units handed to the epilogue warp
  for (int it = 0;; ++it) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    if (it < n_spec && !spec_ok) {  // copied for distinct experts the rows did not pick
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      continue;
    }
    const unsigned char* st = smem + s * kPlaneBytes;
    const unsigned char* ax = aux + s * kAuxBytes;
    const int u = reinterpret_cast<const int*>(ax + kHdrOff)[0];
    const int jst = reinterpret_cast<const int*>(ax + kHdrOff)[1];
    if (u < 0 || jst == 0) {
      if (u < 0) {  // no more units: stop the epilogue warp too
        const int b = n_done & 1;
        if (n_done >= 2) mbar_wait(epi_free + 8 * b, ((n_done >> 1) - 1) & 1);
        if (tid == 0) epi_unit[b] = -1;
        __syncwarp();
        if (lane == 0) mbar_arrive(epi_full + 8 * b);
        break;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e >> 2][e & 3] = 0.f;
    }
#pragma unroll
    for (int gi = 0; gi < kWarpChunks; ++gi) {
      const int gr = gc0 + gi;  // the scale group's row in the stage
      // the A fragments of every 16-row slab: m-tile mt's M rows g, g + 8
      // are columns col + 2 mt, col + 2 mt + 1; low and high nibbles
      uint32_t a[G / 16][2][4], ah[G / 16][2][4];
#pragma unroll
      for (int sl = 0; sl < G / 16; ++sl) {
        uint32_t v[4][2];
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {
          const unsigned char* rows = st + (gr * G + sl * 16 + 8 * kp) * 128;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rows + woff0);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rows + woff1);
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c][kp] = pair_rows(w0, w1, c);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t pv = v[2 * mt + (i & 1)][i >> 1];
            a[sl][mt][i] = lo_nibbles(pv);
            ah[sl][mt][i] = hi_nibbles(pv);
          }
      }
      // low and high nibbles in sums of their own: five short chains of MMAs
      float tlo[2][4] = {}, thi[2][4] = {}, xs[4] = {};
#pragma unroll
      for (int sl = 0; sl < G / 16; ++sl) {
        const unsigned char* xk = ax + xoff + (gr * G + sl * 16) * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xk);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xk + 16);
        mma_bf16(tlo[0], a[sl][0], b0, b1);
        mma_bf16(tlo[1], a[sl][1], b0, b1);
        mma_bf16(thi[0], ah[sl][0], b0, b1);
        mma_bf16(thi[1], ah[sl][1], b0, b1);
        mma_bf16(xs, ones, b0, b1);
      }
      // one f32 scaling a group: tlo/thi[mt][e] are column col + 2 mt + e /
      // 2, row 2 t + e % 2 of the group; the bias leaves through the min
      const float4 s4 = *reinterpret_cast<const float4*>(ax + gr * kBN * 4 + col * 4);
      const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
      float mn[4] = {0.f, 0.f, 0.f, 0.f};
      if (MINS) {
        const float4 m4 = *reinterpret_cast<const float4*>(ax + kMnOff + gr * kBN * 4 + col * 4);
        mn[0] = m4.x; mn[1] = m4.y; mn[2] = m4.z; mn[3] = m4.w;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 2 * mt + (e >> 1);
          acc[mt][e] = fmaf(sc[c], tlo[mt][e] + thi[mt][e],
                            fmaf(fmaf(-kBias, sc[c], mn[c]), xs[e & 1], acc[mt][e]));
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    if (jst != sps - 1) continue;

    // the unit's last stage: its sums go to the epilogue warp's buffer
    const int b = n_done & 1;
    if (n_done >= 2) mbar_wait(epi_free + 8 * b, ((n_done >> 1) - 1) & 1);
    float* eb = ebuf + b * kEpiFloats + eoff;
#pragma unroll
    for (int e = 0; e < 8; ++e) eb[e * kEpiPitch] = acc[e >> 2][e & 3];
    if (tid == 0) epi_unit[b] = u;
    __syncwarp();
    if (lane == 0) mbar_arrive(epi_full + 8 * b);
    ++n_done;
  }
}

// the dynamic shared memory attribute and the blocks the card holds at once,
// once per instantiation and device (bit `dev` of `done`)
template <int G, bool MINS>
cudaError_t prepare(int* slots) {
  static unsigned long long done = 0;
  static int slots_of[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(done & bit)) {
    auto* kern = qmm_expert_kernel<G, MINS>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, kSmemBytes);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    slots_of[dev & 63] = per_sm * sms;
    done |= bit;
  }
  *slots = slots_of[dev & 63];
  return cudaSuccess;
}

template <int G, bool MINS>
cudaError_t launch(const CUtensorMap* maps, const void* x, const void* ids, void* part,
                   void* counters, void* out, int R, int E, int K, int O, int slots,
                   int max_splits, int grid, int hint_splits, cudaStream_t st) {
  int held = 0;
  cudaError_t err = prepare<G, MINS>(&held);
  if (err != cudaSuccess) return err;
  if (grid > held) return cudaErrorInvalidValue;
  qmm_expert_kernel<G, MINS><<<grid, kThreads, kSmemBytes, st>>>(
      maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(x),
      static_cast<const int*>(ids), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), R, E, K, O, slots, max_splits, hint_splits);
  return cudaGetLastError();
}

}  // namespace

// The blocks of the kernel the current device holds at once (SMs x blocks
// an SM), the `slots` its split rule plans for; 0 on an error.
extern "C" int qmm_expert_slots(int group, int mins) {
  const auto fn = group == 16 ? (mins ? prepare<16, true> : prepare<16, false>)
                              : (mins ? prepare<32, true> : prepare<32, false>);
  int slots = 0;
  return fn(&slots) == cudaSuccess ? slots : 0;
}

// The kernel's K split at (col_tiles x n_groups) pairs and k_units stages of
// 64 plane rows; tests hold ops/kernels/qmm_expert.py split_count to it.
extern "C" int qmm_expert_split_count(int col_tiles, int n_groups, int k_units, int slots) {
  return split_count(col_tiles, n_groups, k_units, slots);
}

// Encode the stack's tensor maps into maps_out (3 x 128 bytes): q [E*K, O]
// int8 in 128 x 64 boxes (128-byte swizzle), scales and mins [E*K/g, O] f32
// in 128 x 64/g boxes (mn null: no mins); a box past O's end reads zeros
// there. Returns 0, or cudaErrorInvalidValue.
extern "C" int qmm_expert_encode(const void* q, const void* sc, const void* mn, int E, int K,
                                 int O, int group, void* maps_out) {
  if ((group != 16 && group != 32) || O % 64 != 0 || K % kRows != 0 ||
      (long long)E * K >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap maps[3] = {};
  const uint64_t rows = (uint64_t)E * K;
  bool ok = make_map(&maps[0], q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, rows, kBN, kRows, true) &&
            make_map(&maps[1], sc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, O, rows / group, kBN,
                     kRows / group, false);
  if (ok && mn != nullptr) {
    ok = make_map(&maps[2], mn, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, O, rows / group, kBN,
                  kRows / group, false);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  memcpy(maps_out, maps, sizeof(maps));
  return 0;
}

// maps: from qmm_expert_encode; x [R, K] bf16 (16-byte aligned); ids [R]
// int32 (clamped to [0, E)); part [max_splits, R, O] f32 scratch (max_splits
// > 1); counters [2 + ceil(O/128) * R] int32, zero, left zero; out [R, O] f32. group is
// 16 or 32 (mins: the maps hold mins), K a multiple of 64, O of 64, 1 <= R
// <= 512, E < 32768; slots from qmm_expert_slots; grid, 1 to slots blocks
// (any count works: units past the grid are fetched); hint_splits, the
// kernel's split at R groups where the rows may pick distinct experts (R <=
// E), else 0. Returns cudaGetLastError().
extern "C" int qmm_expert_launch(const void* maps, const void* x, const void* ids, void* part,
                                 void* counters, void* out, int R, int E, int K, int O, int group,
                                 int mins, int slots, int max_splits, int grid, int hint_splits,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || R > kMaxRows || E <= 0 || E > 32767 || O % 64 != 0 || K % kRows != 0 || slots <= 0 ||
      max_splits <= 0 || max_splits > kMaxSplits || grid <= 0 || hint_splits < 0 ||
      hint_splits > max_splits || (hint_splits > 0 && (K / kRows) % hint_splits != 0) ||
      (group != 16 && group != 32) ||
      counters == nullptr || (max_splits > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap m[3];
  memcpy(m, maps, sizeof(m));
  const auto fn = group == 16 ? (mins ? launch<16, true> : launch<16, false>)
                              : (mins ? launch<32, true> : launch<32, false>);
  return (int)fn(m, x, ids, part, counters, out, R, E, K, O, slots, max_splits, grid, hint_splits,
                 st);
}
