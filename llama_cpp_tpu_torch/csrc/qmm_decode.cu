// Fused dequantize + matmul over block-scaled weight planes at decode row
// counts (1 <= N <= 63), for Hopper: the plane bytes stream in by TMA on a
// ring of mbarrier stages and the integer weights go to the tensor cores,
// unscaled with one f32 scaling per group up to 8 rows, scaled in bf16 above.
//
// Replaces the TPU Pallas kernels of llama_cpp_tpu/ops/pallas/qmm.py below
// PREFILL_MIN_N rows:
//   qmm4_planes  (_qmm4_kernel_u)  packed 4-bit planes, half-split (Q4_K)
//   qmm_planes   (_qmm_kernel_u)   int8 planes (Q6_K)
// Function (as csrc/qmm_prefill.cu): y[N, O] (f32) = x[N, K] (bf16) . W[K, O]
//   W[k, o] = q[k, o] * scale(k, o) + min(k, o)
//   scale   = sub[k/g, o] * d[k/256, o]     (hierarchical, int8 sub + f32 d)
//           | scales[k/g, o]                (flat f32)
//   min     = subm[k/g, o] * dmin[k/256, o] | mins[k/g, o] | 0
// Packed planes hold two 4-bit rows per byte, half-split: byte [r, o] has
// row r in its low nibble and row r + K/2 in its high nibble. The plain
// version (ops/kernels/qmm.py qmm_plain) rounds W to bf16 once. Up to 8 rows
// this kernel keeps q exact and the scale and min in f32 (an NMSE near 1e-6
// from the plain version); from 9 rows it forms W in bf16 from a bf16
// scale and min, as the wgmma kernel does (near 1e-5).
//
// What bounds it on an H100: the plane bytes over 3.35 TB/s (0.59 B a Q4_K
// weight, 1.08 B a Q6_K weight with its scales); in practice the consumer
// warps' instructions a plane byte, which grow with the rows of x.
//
// Design. A block owns 128 output columns over a range of K (split-K where
// the column blocks are too few for two blocks an SM) and walks it in
// stages of 64 plane rows. One thread of the producer warp issues every
// copy by TMA into a ring of 3-4 stages completed on mbarriers: the plane
// rows [64, 128] (128-byte swizzle), their scale rows, and x [8 NT rows, 64
// k] for each half (128-byte swizzle, rows past N zero-filled). Eight
// consumer warps issue no copies. Tensor cores run mma.sync m16n8k16 with
// the weight columns in M and the rows of x in the n8 slot (swap-AB), so
// N = 1..8 wastes no M rows and each weight fragment serves ceil(N / 8)
// n-tiles. Up to 32 rows, the two warps of a 32-column slice take half of a
// stage's scale groups each and add their sums at the end; a thread's 4
// adjacent columns fill the M rows g and g + 8 of two m-tiles, so one 32-bit
// word of a plane row gives every column it needs, and a byte permute pairs
// rows k and k + 1 of a column, the pairing an A-fragment register wants.
// From 33 rows (eight n-tiles) each warp owns 16 columns and every group.
//  * Up to 8 rows, one logic op puts a nibble in the mantissa of bf16 128.0:
//    the MMA sees 128 + q, exact. Packed planes: the low nibbles form the
//    low-half k16 steps, the high nibbles the high-half ones, so every k16
//    step lies in one scale group. An int8 byte goes in as its two nibbles
//    (of q + 128), the high one in the mantissa of 2048.0, by two MMAs into
//    one sum: 2304 + q. Each group's MMAs start from zero and its f32 sum is
//    scaled once per column; the bias and the mins leave through the group
//    sums of x, which one more MMA against a fragment of ones gives.
//  * From 9 rows that per-output scaling would cost more than forming W:
//    the exact q (one bf16 subtraction, or for int8 one bf16 FMA of the two
//    nibbles) is scaled by one bf16 FMA in the A fragment and the MMAs
//    accumulate straight into the output.
// Each warp forms its columns' f32 scales (sub * d) and mins once a stage,
// one column a lane, into shared memory. Split-K partial sums go to a
// scratch buffer; the last block of each column tile (an atomic counter)
// adds them in a fixed order and resets the counter, so results do not
// change from run to run and no second launch is needed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

constexpr int kBN = 128;           // output columns per block
constexpr int kRows = 64;          // plane rows per stage
constexpr int kWarps = 8;          // consumers: two warps a 32-column slice
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kSlice = 128;        // the threads of one warp per slice
constexpr int kPlaneBytes = kRows * kBN;  // 8 KB, 128-byte swizzled
// per half (low, high): scales at 0 (hierarchical d at 512), mins at 2048
// (dmin at 2560)
constexpr int kHalfBytes = 4096;

template <bool PACKED, int G, int NT>
struct Layout {
  static constexpr int kHalves = PACKED ? 2 : 1;
  static constexpr int kXTile = NT * 8 * 128;  // 8 NT rows x 64 bf16
  static constexpr int kChunks = kRows / G;    // scale groups a stage (a half)
  // up to four n-tiles the two warps of a 32-column slice split the groups
  // of a stage; at eight (their accumulators would not fit two blocks an
  // SM) each warp owns 16 columns over every group
  static constexpr bool kOneMT = NT >= 8;
  static constexpr int kWarpChunks = kOneMT ? kChunks : kChunks / 2;
  // each warp's f32 scales and mins of a stage: [group][half][s, m][its
  // 32 or 16 columns]
  static constexpr int kWarpCols = kOneMT ? 16 : 32;
  static constexpr int kWarpScratch = kWarpChunks * kHalves * 2 * kWarpCols * 4;
  static constexpr int kScratch = kWarps * kWarpScratch;
  static constexpr int kStageBytes = kPlaneBytes + kHalves * (kHalfBytes + kXTile);
  static constexpr int kScaleOff = kPlaneBytes;
  static constexpr int kXOff = kPlaneBytes + kHalves * kHalfBytes;
  // four stages where two blocks still fit an SM's 228 KB, else three
  static constexpr int kStages =
      NT < 8 && 2 * (4 * kStageBytes + kScratch + 64 + 2048) <= 233472 ? 4 : 3;
  static constexpr int kSmemBytes = kStages * kStageBytes + kScratch + 16 * kStages + 1024;
};

// the consumer warps alone (the producer warp has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// byte `b` of row `r` in a tile of 128-byte rows under the 128-byte swizzle:
// 16-byte chunks XOR r % 8 (tiles start on 1024-byte boundaries)
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
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

// bf16x2 of the low nibbles of a pair_rows word: 128 + n, exact (n < 128
// sits in the mantissa of 128.0, bf16 0x4300)
__device__ __forceinline__ uint32_t lo_nibbles(uint32_t v) {
  return (v & 0x000F000Fu) | 0x43004300u;
}

// bf16x2 of the high nibbles: 128 + n (packed) or, for int8 planes, 2048 +
// 16 (n ^ 8), the high nibble of w + 128 in the mantissa of 2048.0 (0x4500)
template <bool PACKED>
__device__ __forceinline__ uint32_t hi_nibbles(uint32_t v) {
  return PACKED ? ((v >> 4) & 0x000F000Fu) | 0x43004300u
                : ((v >> 4) & 0x000F000Fu) ^ 0x45084508u;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// the exact weights of a pair_rows word as bf16x2: the nibble of half h
// (packed), or the int8 value 16 * (high nibble - 8) + low nibble of w + 128
template <bool PACKED>
__device__ __forceinline__ __nv_bfloat162 exact_q(uint32_t v, int h) {
  const __nv_bfloat162 c128 = __floats2bfloat162_rn(128.f, 128.f);
  if (PACKED) return __hsub2(as_bf16x2(h ? hi_nibbles<true>(v) : lo_nibbles(v)), c128);
  const uint32_t hu = ((v >> 4) & 0x000F000Fu) ^ 0x43084308u;  // 128 + high nibble of w + 128
  return __hfma2(__hsub2(as_bf16x2(hu), __floats2bfloat162_rn(136.f, 136.f)),
                 __floats2bfloat162_rn(16.f, 16.f), __hsub2(as_bf16x2(lo_nibbles(v)), c128));
}

// the f32 scale and min of column c at group row gr of one half (h: its
// scale rows in shared memory)
__device__ __forceinline__ void column_scale(const unsigned char* h, int gr, int c, bool hier,
                                             bool mins, float& s, float& m) {
  m = 0.f;
  if (hier) {
    s = (float)static_cast<int8_t>(h[gr * kBN + c]) * *reinterpret_cast<const float*>(h + 512 + 4 * c);
    if (mins) {
      m = (float)static_cast<int8_t>(h[2048 + gr * kBN + c]) *
          *reinterpret_cast<const float*>(h + 2560 + 4 * c);
    }
  } else {
    s = *reinterpret_cast<const float*>(h + gr * kBN * 4 + 4 * c);
    if (mins) m = *reinterpret_cast<const float*>(h + 2048 + gr * kBN * 4 + 4 * c);
  }
}

// out = the sum over s of part[s] at the float4 i of a column tile's N x 32,
// for i = tid + j * kConsumers (j < J), with U splits' loads in flight each
template <int J, int U>
__device__ __forceinline__ void fold(float* out, const float* part, size_t stride, int total,
                                     int splits, int O, int o_blk, int tid) {
  for (int i0 = tid; i0 < total; i0 += J * kConsumers) {
    size_t off[J];
    bool live[J];
    float4 sum[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int i = i0 + j * kConsumers;
      live[j] = i < total;
      off[j] = (size_t)(i / (kBN / 4)) * O + o_blk + 4 * (i % (kBN / 4));
      sum[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int sp = 0; sp < splits; sp += U) {
      float4 v[U][J];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          v[u][j] = live[j] && sp + u < splits
                        ? __ldcg(reinterpret_cast<const float4*>(part + (sp + u) * stride + off[j]))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          sum[j].x += v[u][j].x; sum[j].y += v[u][j].y;
          sum[j].z += v[u][j].z; sum[j].w += v[u][j].w;
        }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (live[j]) *reinterpret_cast<float4*>(out + off[j]) = sum[j];
    }
  }
}

template <bool PACKED, int G, int NT>
__global__ void __launch_bounds__(kThreads, 2)
qmm_decode_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_sc,
                  const __grid_constant__ CUtensorMap tm_d,
                  const __grid_constant__ CUtensorMap tm_mn,
                  const __grid_constant__ CUtensorMap tm_dm, float* __restrict__ out,
                  float* __restrict__ part, int* __restrict__ counters, int N, int K, int O,
                  int hier, int mins, int stages_per_split) {
  using L = Layout<PACKED, G, NT>;
  constexpr int kHalves = L::kHalves;
  constexpr int kStages = L::kStages;
  constexpr int kWarpChunks = L::kWarpChunks;
  constexpr bool kOneMT = L::kOneMT;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last_block;
  // swizzled tiles need 1024-byte alignment
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_addr);
  float* scratch = reinterpret_cast<float*>(smem + kStages * L::kStageBytes);
  const uint32_t bars = base + kStages * L::kStageBytes + L::kScratch;
  const uint32_t full = bars, empty = bars + 8 * kStages;

  const int tid = threadIdx.x;
  const int o_blk = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int r_begin = split * stages_per_split * kRows;
  const int half = K / 2;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);        // the issuing thread's expect_tx
      mbar_init(empty + 8 * s, kWarps);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage `it` of the split into slot it % kStages, by TMA
  const int es = hier ? 1 : 4;  // bytes of a scale element
  const uint32_t half_bytes = ((kRows / G) * kBN * es + (hier ? 512 : 0)) * (mins ? 2 : 1);
  const uint32_t stage_bytes = kPlaneBytes + kHalves * (half_bytes + L::kXTile);
  auto issue = [&](int it) {
    const int s = it % kStages;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, stage_bytes);
    const uint32_t dst = base + s * L::kStageBytes;
    const int rb = r_begin + kRows * it;
    tma_load(dst, &tm_q, o_blk, rb, bar);
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const uint32_t hd = dst + L::kScaleOff + h * kHalfBytes;
      const int kb = rb + h * half;
      tma_load(hd, &tm_sc, o_blk, kb / G, bar);
      if (hier) tma_load(hd + 512, &tm_d, o_blk, kb / 256, bar);
      if (mins) {
        tma_load(hd + 2048, &tm_mn, o_blk, kb / G, bar);
        if (hier) tma_load(hd + 2560, &tm_dm, o_blk, kb / 256, bar);
      }
      tma_load(dst + L::kXOff + h * L::kXTile, &tm_x, kb, 0, bar);
    }
  };
  if (tid >= kConsumers) {
    // ---------------- one thread issues every copy (TMA) ----------------
    if (tid == kConsumers) {
      for (int it = 0; it < stages_per_split; ++it) {
        if (it >= kStages) mbar_wait(empty + 8 * (it % kStages), (it / kStages - 1) & 1);
        issue(it);
      }
    }
    return;
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col = (warp & 3) * 32 + 4 * g;  // this thread's 4 columns in the tile
  const int wpart = warp >> 2;
  const int gc0 = kOneMT ? 0 : wpart * kWarpChunks;  // the warp's first group of a stage
  constexpr uint32_t kOnes = 0x3F803F80u;   // bf16x2 (1, 1)
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
  const int nt_live = (N + 7) / 8;
  // offsets in a stage, the same for every stage: plane rows 8 i + 2 t and
  // 8 i + 2 t + 1 at columns col .. col + 3 (the swizzle XORs the 16-byte
  // chunk with the row mod 8), and x rows g of each n-tile at k 2 t
  const int woff0 = (2 * t) * 128 + ((((col >> 4) ^ (2 * t)) & 7) << 4) + (col & 15);
  const int woff1 = (2 * t + 1) * 128 + ((((col >> 4) ^ (2 * t + 1)) & 7) << 4) + (col & 15);
  const int xoff = g * 128 + 4 * t;
  float* wscr = scratch + warp * (L::kWarpScratch / 4);
  // the column whose scales this lane forms
  const int ccol = kOneMT ? warp * 16 + (lane & 15) : (warp & 3) * 32 + lane;
  constexpr float kBias = PACKED ? 128.f : 2304.f;
  // from 9 rows the weights are scaled in the A fragments (bf16 scale and
  // min, as the wgmma kernel does): a per-group f32 scaling of every output
  // would cost more than one bf16 FMA per weight pair
  constexpr bool kScaleA = NT >= 2;

  float* dst = splits > 1 ? part + (size_t)split * N * O : out;
  if (kOneMT) {
    // one m-tile a warp: M rows g and g + 8 are columns c2 and c2 + 1, each
    // weight is scaled in its A fragment, every n-tile reuses it
    const int c2 = warp * 16 + 2 * g;
    const int u0 = (2 * t) * 128 + ((((c2 >> 4) ^ (2 * t)) & 7) << 4) + (c2 & 15);
    const int u1 = (2 * t + 1) * 128 + ((((c2 >> 4) ^ (2 * t + 1)) & 7) << 4) + (c2 & 15);
    float acc[NT][4] = {};
    for (int it = 0; it < stages_per_split; ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const unsigned char* st = smem + s * L::kStageBytes;
#pragma unroll
      for (int gi = 0; gi < kWarpChunks; ++gi)
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          float sc, mn;
          column_scale(st + L::kScaleOff + h * kHalfBytes, gi, ccol, hier, mins, sc, mn);
          float* e = wscr + (gi * kHalves + h) * 32;
          e[lane & 15] = sc;  // lanes 16-31 write what lanes 0-15 do
          e[16 + (lane & 15)] = mn;
        }
      __syncwarp();
#pragma unroll
      for (int gi = 0; gi < kWarpChunks; ++gi) {
        uint32_t v[G / 16][2][2];
#pragma unroll
        for (int sl = 0; sl < G / 16; ++sl)
#pragma unroll
          for (int kp = 0; kp < 2; ++kp) {
            const unsigned char* rows = st + (gi * G + sl * 16 + 8 * kp) * 128;
            const uint32_t w0 = *reinterpret_cast<const uint16_t*>(rows + u0);
            const uint32_t w1 = *reinterpret_cast<const uint16_t*>(rows + u1);
            v[sl][0][kp] = pair_rows(w0, w1, 0);
            v[sl][1][kp] = pair_rows(w0, w1, 1);
          }
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          const float* e2 = wscr + (gi * kHalves + h) * 32 + 2 * g;
          const float2 sp = *reinterpret_cast<const float2*>(e2);
          const float2 mp = *reinterpret_cast<const float2*>(e2 + 16);
          const __nv_bfloat162 s2[2] = {__floats2bfloat162_rn(sp.x, sp.x),
                                        __floats2bfloat162_rn(sp.y, sp.y)};
          const __nv_bfloat162 m2[2] = {__floats2bfloat162_rn(mp.x, mp.x),
                                        __floats2bfloat162_rn(mp.y, mp.y)};
          const unsigned char* xt = st + L::kXOff + h * L::kXTile + xoff;
#pragma unroll
          for (int sl = 0; sl < G / 16; ++sl) {
            uint32_t a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              a[i] = bf16x2_bits(__hfma2(exact_q<PACKED>(v[sl][i & 1][i >> 1], h), s2[i & 1],
                                         m2[i & 1]));
            }
            const int c0 = gi * G / 8 + 2 * sl;
            const int x0 = ((c0 ^ g) & 7) << 4, x1 = (((c0 + 1) ^ g) & 7) << 4;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if (nt >= nt_live) continue;
              const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xt + nt * 1024 + x0);
              const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xt + nt * 1024 + x1);
              mma_bf16(acc[nt], a, b0, b1);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    // rows nt * 8 + 2 t + j, columns c2, c2 + 1
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = nt * 8 + 2 * t + j;
        if (n < N) {
          *reinterpret_cast<float2*>(dst + (size_t)n * O + o_blk + c2) =
              make_float2(acc[nt][j], acc[nt][2 + j]);
        }
      }
  } else {
    float acc[2][NT][4];
  #pragma unroll
    for (int mt = 0; mt < 2; ++mt)
  #pragma unroll
      for (int nt = 0; nt < NT; ++nt)
  #pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int it = 0; it < stages_per_split; ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const unsigned char* st = smem + s * L::kStageBytes;
      // the stage's f32 scales and mins less the bias, one column a lane
  #pragma unroll
      for (int gi = 0; gi < kWarpChunks; ++gi)
  #pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          float sc, mn;
          column_scale(st + L::kScaleOff + h * kHalfBytes, gc0 + gi, ccol, hier, mins, sc, mn);
          float* e = wscr + (gi * kHalves + h) * 64;
          e[lane] = sc;
          e[32 + lane] = kScaleA ? mn : fmaf(-kBias, sc, mn);
        }
      __syncwarp();
      const unsigned char* sq = st + gc0 * G * 128;
  #pragma unroll
      for (int gi = 0; gi < kWarpChunks; ++gi) {
        // this group's plane rows 2t, 2t + 1 (kp 0) and 2t + 8, 2t + 9 (kp 1)
        // of each 16-row slab, paired by column: v[sl][c][kp]
        uint32_t v[G / 16][4][2];
  #pragma unroll
        for (int sl = 0; sl < G / 16; ++sl)
  #pragma unroll
          for (int kp = 0; kp < 2; ++kp) {
            const unsigned char* rows = sq + (gi * G + sl * 16 + 8 * kp) * 128;
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rows + woff0);
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rows + woff1);
  #pragma unroll
            for (int c = 0; c < 4; ++c) v[sl][c][kp] = pair_rows(w0, w1, c);
          }
  #pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          const float* e4 = wscr + (gi * kHalves + h) * 64 + 4 * g;
          const float4 s4 = *reinterpret_cast<const float4*>(e4);
          const float4 m4 = *reinterpret_cast<const float4*>(e4 + 32);
          const float sc[4] = {s4.x, s4.y, s4.z, s4.w}, mn[4] = {m4.x, m4.y, m4.z, m4.w};
          const unsigned char* xt = st + L::kXOff + h * L::kXTile + xoff;
          if (kScaleA) {
            // W = q * scale + min in bf16 (q exact, scale and min rounded),
            // straight into the accumulators
            __nv_bfloat162 s2[4], m2[4];
  #pragma unroll
            for (int c = 0; c < 4; ++c) {
              s2[c] = __floats2bfloat162_rn(sc[c], sc[c]);
              m2[c] = __floats2bfloat162_rn(mn[c], mn[c]);
            }
  #pragma unroll
            for (int sl = 0; sl < G / 16; ++sl) {
              uint32_t a[2][4];
  #pragma unroll
              for (int mt = 0; mt < 2; ++mt)
  #pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int c = 2 * mt + (i & 1);
                  const uint32_t pv = v[sl][c][i >> 1];
                  a[mt][i] = bf16x2_bits(__hfma2(exact_q<PACKED>(pv, h), s2[c], m2[c]));
                }
              const int c0 = (gc0 + gi) * G / 8 + 2 * sl;
              const int x0 = ((c0 ^ g) & 7) << 4, x1 = (((c0 + 1) ^ g) & 7) << 4;
  #pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                if (nt >= nt_live) continue;
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xt + nt * 1024 + x0);
                const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xt + nt * 1024 + x1);
                mma_bf16(acc[0][nt], a[0], b0, b1);
                mma_bf16(acc[1][nt], a[1], b0, b1);
              }
            }
            continue;
          }
          // the A fragments of every slab: m-tile mt's M rows g, g + 8 are
          // columns col + 2 mt, col + 2 mt + 1; unscaled, biased weights
          // (128 + q, or for int8 2304 + q over two MMAs)
          uint32_t a[G / 16][2][4], ah[G / 16][2][4];
  #pragma unroll
          for (int sl = 0; sl < G / 16; ++sl)
  #pragma unroll
            for (int mt = 0; mt < 2; ++mt)
  #pragma unroll
              for (int i = 0; i < 4; ++i) {
                const uint32_t pv = v[sl][2 * mt + (i & 1)][i >> 1];
                if (PACKED) {
                  a[sl][mt][i] = h ? hi_nibbles<true>(pv) : lo_nibbles(pv);
                } else {
                  a[sl][mt][i] = lo_nibbles(pv);
                  ah[sl][mt][i] = hi_nibbles<false>(pv);
                }
              }
  #pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (NT > 1 && nt >= nt_live) continue;
            // the group's sums for n-tile nt, and of x (an MMA against ones)
            float tmp[2][4] = {}, xs[4] = {};
  #pragma unroll
            for (int sl = 0; sl < G / 16; ++sl) {
              // the 16-byte chunk of k in the x row, swizzled by the row (g)
              const int c0 = (gc0 + gi) * G / 8 + 2 * sl;
              const uint32_t b0 =
                  *reinterpret_cast<const uint32_t*>(xt + nt * 1024 + (((c0 ^ g) & 7) << 4));
              const uint32_t b1 =
                  *reinterpret_cast<const uint32_t*>(xt + nt * 1024 + ((((c0 + 1) ^ g) & 7) << 4));
              mma_bf16(tmp[0], a[sl][0], b0, b1);
              mma_bf16(tmp[1], a[sl][1], b0, b1);
              if (!PACKED) {
                mma_bf16(tmp[0], ah[sl][0], b0, b1);
                mma_bf16(tmp[1], ah[sl][1], b0, b1);
              }
              mma_bf16(xs, ones, b0, b1);
            }
            // one f32 scaling per group: tmp[mt][e] is column col + 2 mt +
            // e / 2, row nt * 8 + 2 t + e % 2; xs[e % 2] that row's group sum;
            // the bias leaves through the min (min - bias * scale)
  #pragma unroll
            for (int mt = 0; mt < 2; ++mt)
  #pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = 2 * mt + (e >> 1);
                acc[mt][nt][e] = fmaf(sc[c], tmp[mt][e], fmaf(mn[c], xs[e & 1], acc[mt][nt][e]));
              }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }

    // the second warp of each column slice hands its groups' sums to the first
    // (the stages are all consumed: their memory is free)
    {
      consumers_sync();
      float* red = reinterpret_cast<float*>(smem);
      if (wpart == 1) {
  #pragma unroll
        for (int e = 0; e < 8 * NT; ++e) {
          red[e * kSlice + tid - kSlice] = acc[e & 1][e >> 3][(e >> 1) & 3];
        }
      }
      consumers_sync();
      if (wpart == 0) {
  #pragma unroll
        for (int e = 0; e < 8 * NT; ++e) acc[e & 1][e >> 3][(e >> 1) & 3] += red[e * kSlice + tid];
      }
    }

    // rows nt * 8 + 2 t + j, columns col .. col + 3
    if (wpart == 0) {
  #pragma unroll
      for (int nt = 0; nt < NT; ++nt)
  #pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = nt * 8 + 2 * t + j;
          if (n < N) {
            *reinterpret_cast<float4*>(dst + (size_t)n * O + o_blk + col) =
                make_float4(acc[0][nt][j], acc[0][nt][2 + j], acc[1][nt][j], acc[1][nt][2 + j]);
          }
        }
    }
  }
  if (splits == 1) return;

  // the last block of this column tile adds the partial sums in split order
  __threadfence();
  consumers_sync();
  if (tid == 0) last_block = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  consumers_sync();
  if (!last_block) return;
  __threadfence();
  // sixteen loads in flight a thread, added in split order: one float4 of
  // the tile (N rows x 32) a thread over 16 splits at a time where the tile
  // has no more float4 than threads, else four float4 over 4 splits
  const size_t stride = (size_t)N * O;
  const int total = N * (kBN / 4);
  if (total <= kConsumers) {
    fold<1, 16>(out, part, stride, total, splits, O, o_blk, tid);
  } else {
    fold<4, 4>(out, part, stride, total, splits, O, o_blk, tid);
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

template <bool PACKED, int G, int NT>
cudaError_t launch(dim3 grid, cudaStream_t st, const CUtensorMap* maps, float* out, float* part,
                   int* counters, int N, int K, int O, int hier, int mins, int sps) {
  auto* kern = qmm_decode_kernel<PACKED, G, NT>;
  constexpr int smem = Layout<PACKED, G, NT>::kSmemBytes;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, st>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], out,
                                     part, counters, N, K, O, hier, mins, sps);
  return cudaGetLastError();
}

template <bool PACKED, int G>
cudaError_t launch_nt(int nt, dim3 grid, cudaStream_t st, const CUtensorMap* maps, float* out,
                      float* part, int* counters, int N, int K, int O, int hier, int mins,
                      int sps) {
  switch (nt) {
    case 1: return launch<PACKED, G, 1>(grid, st, maps, out, part, counters, N, K, O, hier, mins, sps);
    case 2: return launch<PACKED, G, 2>(grid, st, maps, out, part, counters, N, K, O, hier, mins, sps);
    case 4: return launch<PACKED, G, 4>(grid, st, maps, out, part, counters, N, K, O, hier, mins, sps);
    default: return launch<PACKED, G, 8>(grid, st, maps, out, part, counters, N, K, O, hier, mins, sps);
  }
}

}  // namespace

template <bool PACKED, int G>
int smem_bytes(int n_tiles) {
  switch (n_tiles) {
    case 1: return Layout<PACKED, G, 1>::kSmemBytes;
    case 2: return Layout<PACKED, G, 2>::kSmemBytes;
    case 4: return Layout<PACKED, G, 4>::kSmemBytes;
    default: return Layout<PACKED, G, 8>::kSmemBytes;
  }
}

// Shared memory a block of the kernel takes for n_tiles (1, 2, 4 or 8)
// n-tiles of 8 rows at a plane layout; tests hold the planner's copy to it.
extern "C" int qmm_decode_smem_bytes(int n_tiles, int packed, int group) {
  if (packed) return group == 32 ? smem_bytes<true, 32>(n_tiles) : smem_bytes<true, 16>(n_tiles);
  return group == 32 ? smem_bytes<false, 32>(n_tiles) : smem_bytes<false, 16>(n_tiles);
}

// x [N, K] bf16 (16-byte aligned, 1 <= N <= 63); q [R, O] int8 planes (R =
// K/2 packed, else K); sc [K/g, O] int8 (hier) or f32; d [K/256, O] f32
// (hier); mn like sc or null; dm like d or null; part [splits, N, O] f32
// scratch (splits > 1); counters [O/128] int32, zero, left zero; out [N, O]
// f32. group is 16 or 32, K a multiple of 256, O of 128; each of the
// `splits` ranges covers R / splits plane rows, a multiple of 64. Returns
// cudaGetLastError().
extern "C" int qmm_decode_launch(const void* x, const void* q, const void* sc, const void* d,
                                 const void* mn, const void* dm, void* part, void* counters,
                                 void* out, int N, int K, int O, int group, int packed, int hier,
                                 int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = packed ? K / 2 : K;
  if (N <= 0 || N > 63 || O % kBN != 0 || K % 256 != 0 || splits <= 0 ||
      R % (splits * kRows) != 0 || (group != 16 && group != 32) ||
      (splits > 1 && (part == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int nt = N <= 8 ? 1 : N <= 16 ? 2 : N <= 32 ? 4 : 8;
  // tensor maps: x [N, K] bf16 in boxes of 64 k x 8 nt rows (128-byte
  // swizzle, rows past N zero-filled); q [R, O] in 128 x 64 boxes (128-byte
  // swizzle); scales and mins [K/g, O] (64/g rows), d and dmin [K/256, O]
  // (one row), in 128-column boxes
  CUtensorMap maps[6] = {};
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int es = hier ? 1 : 4;
  bool ok = make_map(&maps[0], x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, 64, 8 * nt, true) &&
            make_map(&maps[1], q, u8, 1, O, R, kBN, kRows, true) &&
            make_map(&maps[2], sc, hier ? u8 : f32, es, O, K / group, kBN, kRows / group, false);
  if (ok && hier) ok = make_map(&maps[3], d, f32, 4, O, K / 256, kBN, 1, false);
  if (ok && mn != nullptr) {
    ok = make_map(&maps[4], mn, hier ? u8 : f32, es, O, K / group, kBN, kRows / group, false);
    if (ok && hier) ok = make_map(&maps[5], dm, f32, 4, O, K / 256, kBN, 1, false);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid(O / kBN, splits);
  const int sps = R / kRows / splits;
  const int mins = mn != nullptr;
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counters);
  cudaError_t err;
  if (packed && group == 32) {  // Q4_K
    err = launch_nt<true, 32>(nt, grid, st, maps, o, p, c, N, K, O, hier, mins, sps);
  } else if (!packed && group == 16) {  // Q6_K
    err = launch_nt<false, 16>(nt, grid, st, maps, o, p, c, N, K, O, hier, mins, sps);
  } else if (packed) {  // Q6_K planes that fit in 4 bits
    err = launch_nt<true, 16>(nt, grid, st, maps, o, p, c, N, K, O, hier, mins, sps);
  } else {
    err = launch_nt<false, 32>(nt, grid, st, maps, o, p, c, N, K, O, hier, mins, sps);
  }
  return (int)err;
}
