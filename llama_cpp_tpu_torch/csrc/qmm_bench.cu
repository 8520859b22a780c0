// The qmm microbenchmark's four probe kernels, for Hopper.
//
// Replaces the TPU Pallas kernels of scripts/bench_qmm.py:
//   stream_planes  (_stream_kernel)         B1, the stream ceiling
//   _variant_call  (_qmm4_fp_kernel,        B2, the nibble unpack in float
//                   _qmm4_i16_kernel)           arithmetic or by shift and mask
//   qmm_tiled                               B3, B2's function with the tile
//                                               sizes as arguments
//   qmm_tiled4d    (_qmm4_tiled4d_kernel)   B4, planes stored tile by tile
//
// Functions. Planes: qp [K/2, O] bytes, sc and mn [K/group, O] f32.
//   B1: out[r, o] = sum over tiles t of qp[t*tk2 + r, o] (read as a signed
//       byte) + sc[t*ts + r, o] + mn[t*ts + r, o], r = 0..7, with
//       ts = tk2 / (group/2). Only eight rows of a tile are summed, but every
//       byte of the three planes has to reach the SM: that is the probe.
//   B2-B4: y[n, o] = sum over k of x[n, k] * (nib(k, o) * sc[k/group, o]
//       + mn[k/group, o]), with the even/odd pairing: byte r of a column holds
//       row 2r in its low nibble and row 2r + 1 in its high nibble. The TPU
//       bodies round nib * sc to bf16 before the product; these kernels sum
//       nib * x per scale group (exact operands, f32 sums) and scale once per
//       group in f32, as csrc/qmm_decode.cu does up to 8 rows, so they differ
//       from the plain version by that one rounding of W (NMSE near 1e-6).
//
// What bounds them on an H100: at 8 rows of x the plane bytes over 3.35 TB/s,
// for all four. On the CUDA cores the products of B2-B4 would be 2 * 8 FMAs
// per byte, about as much time as the bytes take at the f32 peak; they go to
// the tensor cores, where 8 rows of x are exactly the n of mma.m16n8k16.
//
// Design. Nothing moves on this card unless the kernel asks, and a load whose
// value is unused is removed by the compiler, so every plane byte goes through
// a ring of shared-memory stages filled by cp.async (16 bytes a request,
// asm volatile: the copies stay). B1: 64 threads own a strip of 256 columns;
// the three planes are cut into 8 KB chunks (32 byte rows, or 8 rows of f32),
// a block walks a range of the strip's chunks through an 8-stage ring and adds
// the eight rows of each chunk that opens a tile. B2-B4: a warp owns sets of 64
// of the block's TO columns; a stage is 32 byte rows (two scale groups) with
// their scales, mins and the 64 k of x. The output columns are the M of
// mma.sync.m16n8k16, x is the B operand straight from its bf16 bytes, and the
// even/odd pairing, which costs the TPU a lane interleave, is the natural one
// here: a byte holds rows 2r and 2r + 1 of K, which is the bf16 pair an A
// fragment register wants, so a nibble pair becomes a register with three
// bit operations and no shuffle. B4's tile is one contiguous run, so its
// stages are plain linear copies (row stride TO instead of O). The sequential
// K axis of the TPU grid becomes a loop inside the block plus a split of K
// across blockIdx.z whose partial sums a second kernel adds in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// out[i] = sum over s of part[s][i], in a fixed order
__global__ void split_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 size_t count, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * count + i];
  out[i] = acc;
}

cudaError_t split_sum(const void* part, void* out, size_t count, int splits, cudaStream_t st) {
  const int threads = 256;
  split_sum_kernel<<<(unsigned)((count + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), count, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B1: the stream probe
// ---------------------------------------------------------------------------

constexpr int kStreamCols = 256;     // columns per block
constexpr int kStreamThreads = 64;   // 4 columns each
constexpr int kStreamChunk = 8192;   // bytes per stage
constexpr int kStreamStages = 8;
constexpr int kStreamQRows = kStreamChunk / kStreamCols;        // 32 byte rows
constexpr int kStreamSRows = kStreamChunk / (kStreamCols * 4);  // 8 f32 rows

// Chunk c of a strip: tile t = c / cpt, then within the tile the qp chunks,
// the sc chunks, the mn chunks. A chunk that opens its plane's tile holds the
// tile's rows 0..7.
__global__ void __launch_bounds__(kStreamThreads)
stream_planes_kernel(const int8_t* __restrict__ qp, const float* __restrict__ sc,
                     const float* __restrict__ mn, float* __restrict__ dst, int O, int tk2,
                     int ts, int n_chunks, int chunks_per_block) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x;
  const int o_blk = blockIdx.x * kStreamCols;
  const int nq = tk2 / kStreamQRows;
  const int ns = ts / kStreamSRows;
  const int cpt = nq + 2 * ns;
  const int c_begin = blockIdx.y * chunks_per_block;
  const int c_end = min(c_begin + chunks_per_block, n_chunks);

  auto fetch = [&](int c, int slot) {
    const int t = c / cpt;
    const int j = c % cpt;
    unsigned char* stage = ring + (size_t)slot * kStreamChunk;
    if (j < nq) {
      const int8_t* src = qp + ((size_t)t * tk2 + (size_t)j * kStreamQRows) * O + o_blk;
#pragma unroll
      for (int u = 0; u < kStreamChunk / 16 / kStreamThreads; ++u) {
        const int i = tid + u * kStreamThreads;  // 16-byte piece of the chunk
        const int row = i / (kStreamCols / 16);
        const int col = (i % (kStreamCols / 16)) * 16;
        cp_async16(stage + (size_t)i * 16, src + (size_t)row * O + col);
      }
    } else {
      const bool is_sc = j < nq + ns;
      const int jj = is_sc ? j - nq : j - nq - ns;
      const float* src = (is_sc ? sc : mn) + ((size_t)t * ts + (size_t)jj * kStreamSRows) * O + o_blk;
#pragma unroll
      for (int u = 0; u < kStreamChunk / 16 / kStreamThreads; ++u) {
        const int i = tid + u * kStreamThreads;
        const int row = i / (kStreamCols / 4);
        const int col = (i % (kStreamCols / 4)) * 4;
        cp_async16(stage + (size_t)i * 16, src + (size_t)row * O + col);
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStreamStages - 1; ++s) {
    if (c_begin + s < c_end) fetch(c_begin + s, s);
    cp_async_commit();
  }
  for (int c = c_begin; c < c_end; ++c) {
    cp_async_wait<kStreamStages - 2>();
    __syncthreads();  // chunk c has landed; every thread is done with chunk c - 1
    const int nxt = c + kStreamStages - 1;
    if (nxt < c_end) fetch(nxt, (nxt - c_begin) % kStreamStages);
    cp_async_commit();
    const unsigned char* stage = ring + (size_t)((c - c_begin) % kStreamStages) * kStreamChunk;
    const int j = c % cpt;
    if (j == 0) {
      const uint32_t* words = reinterpret_cast<const uint32_t*>(stage);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t w = words[r * (kStreamCols / 4) + tid];
#pragma unroll
        for (int col = 0; col < 4; ++col) {
          acc[r][col] += (float)(int8_t)((w >> (8 * col)) & 0xFFu);
        }
      }
    } else if (j == nq || j == nq + ns) {
      const float4* rows = reinterpret_cast<const float4*>(stage);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 v = rows[r * (kStreamCols / 4) + tid];
        acc[r][0] += v.x;
        acc[r][1] += v.y;
        acc[r][2] += v.z;
        acc[r][3] += v.w;
      }
    }
  }
  cp_async_wait<0>();

  float* out = dst + (size_t)blockIdx.y * 8 * O + o_blk + tid * 4;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    *reinterpret_cast<float4*>(out + (size_t)r * O) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// ---------------------------------------------------------------------------
// B2-B4: packed 4-bit GEMV, even/odd pairing, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 8;         // rows of x per block: the n of mma.m16n8k16
constexpr int kStageRows = 32;   // byte rows per stage (64 rows of K)
constexpr int kGroup = 32;       // rows of K per scale
constexpr int kG2 = kGroup / 2;  // byte rows per scale
constexpr int kGroupsPerStage = kStageRows / kG2;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4 bytes of a word (4 columns of one byte row) as 4 bf16 pairs (low
// nibble = row 2r in the low half, high nibble = row 2r+1 in the high half):
// the A fragments of the product, two ways that give the same bits.
// FP: a nibble under the exponent byte 0x43 is the bf16 value 128 + n; one
// bf16x2 subtraction of 128 leaves (lo, hi) exactly. No integer widening and
// no conversion. Otherwise: shift, mask, convert to float, round to bf16.
template <bool FP>
__device__ __forceinline__ void unpack_pairs(uint32_t w, uint32_t a[4]) {
  if (FP) {
    const uint32_t l = w & 0x0F0F0F0Fu;
    const uint32_t h = (w >> 4) & 0x0F0F0F0Fu;
    const uint32_t bias = 0x43004300u;  // bf16x2 (128, 128)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // bytes (l_j, -, h_j, -), then 0x43 over the unused bytes
      const uint32_t p = (__byte_perm(l, h, 0x4400 + 0x1111 * j) & 0x00FF00FFu) | bias;
      const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p),
                                       *reinterpret_cast<const __nv_bfloat162*>(&bias));
      a[j] = *reinterpret_cast<const uint32_t*>(&d);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo = (float)(int)((w >> (8 * j)) & 0xFu);
      const float hi = (float)(int)((w >> (8 * j + 4)) & 0xFu);
      const __nv_bfloat162 d = __floats2bfloat162_rn(lo, hi);
      a[j] = *reinterpret_cast<const uint32_t*>(&d);
    }
  }
}

// Block shape and shared-memory stage by tile width. A warp owns `kSets` sets
// of 64 columns; a stage holds 32 byte rows of the tile (each padded by 8
// words, so that the fragment loads of a warp hit 32 banks), the 2 rows of
// scales and of mins that go with them, and the 64 k of the 8 rows of x.
template <int TO>
struct EoCfg {
  static constexpr int kWarps = TO / 64 < 16 ? TO / 64 : 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSets = TO / (64 * kWarps);
  static constexpr int kStages = TO <= 256 ? 4 : TO <= 1024 ? 3 : 2;
  static constexpr int kMinBlocks = TO <= 512 ? 2 : 1;  // blocks per SM the registers allow
  static constexpr int kQStride = TO + 32;                // bytes per staged byte row
  static constexpr int kQBytes = kStageRows * kQStride;
  static constexpr int kSBytes = kGroupsPerStage * TO * 4;  // scales; as many for mins
  static constexpr int kXStride = 2 * kStageRows + 8;      // bf16 per staged row of x
  static constexpr int kXBytes = kRows * kXStride * 2;
  static constexpr int kStageBytes = kQBytes + 2 * kSBytes + kXBytes;
  static constexpr size_t kBytes = (size_t)kStages * kStageBytes;
};

// One block: TO columns, 8 rows of x, tk rows of K. Output columns are the M
// of the product: M-tile j of a set of 64 columns holds columns 4g + j (rows
// 0..7) and 32 + 4g + j (rows 8..15), so that a thread's 32-bit word of 4
// adjacent columns feeds 4 M-tiles and its results are 4 adjacent floats.
// The nibbles go to the tensor cores unscaled (exact in bf16); the sums of a
// scale group are scaled in f32 afterwards, with the mins term beside them.
template <int TO, bool FP>
__global__ void __launch_bounds__(EoCfg<TO>::kThreads, EoCfg<TO>::kMinBlocks)
qmm4_eo_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
               const float* __restrict__ sc, const float* __restrict__ mn,
               float* __restrict__ dst, int N, int K, int O, int tk, int tiled) {
  using Cfg = EoCfg<TO>;
  constexpr int NT = Cfg::kThreads;
  constexpr int STAGES = Cfg::kStages;
  constexpr int QW = Cfg::kQStride / 4;  // words per staged byte row
  constexpr int XW = Cfg::kXStride / 2;  // words per staged row of x
  extern __shared__ __align__(16) unsigned char ring[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int jo = blockIdx.x;
  const int n0 = blockIdx.y * kRows;
  const int kt = blockIdx.z;
  const uint8_t* qb;
  const float* scb;
  const float* mnb;
  size_t qs;  // row stride of the planes, in elements
  if (tiled) {  // planes stored tile by tile: [K/tk, O/TO, rows, TO]
    const size_t tile = (size_t)kt * gridDim.x + jo;
    qb = q + tile * (size_t)(tk / 2) * TO;
    scb = sc + tile * (size_t)(tk / kGroup) * TO;
    mnb = mn + tile * (size_t)(tk / kGroup) * TO;
    qs = TO;
  } else {
    qb = q + (size_t)kt * (tk / 2) * O + (size_t)jo * TO;
    scb = sc + (size_t)kt * (tk / kGroup) * O + (size_t)jo * TO;
    mnb = mn + (size_t)kt * (tk / kGroup) * O + (size_t)jo * TO;
    qs = O;
  }
  const __nv_bfloat16* xb = x + (size_t)n0 * K + (size_t)kt * tk;
  const int n_stages = tk / 2 / kStageRows;

  auto fetch = [&](int s, int slot) {
    unsigned char* stage = ring + (size_t)slot * Cfg::kStageBytes;
    const uint8_t* qsrc = qb + (size_t)s * kStageRows * qs;
    for (int i = tid; i < kStageRows * (TO / 16); i += NT) {
      const int row = i / (TO / 16);
      const int c16 = (i % (TO / 16)) * 16;
      cp_async16(stage + row * Cfg::kQStride + c16, qsrc + (size_t)row * qs + c16);
    }
    constexpr int per = kGroupsPerStage * (TO / 4);  // 16-byte pieces of a plane's rows
    for (int i = tid; i < 2 * per; i += NT) {
      const int plane = i / per;
      const int row = (i % per) / (TO / 4);
      const int c4 = ((i % per) % (TO / 4)) * 4;
      const float* src = (plane ? mnb : scb) + ((size_t)s * kGroupsPerStage + row) * qs + c4;
      cp_async16(stage + Cfg::kQBytes + plane * Cfg::kSBytes + (row * TO + c4) * 4, src);
    }
    for (int i = tid; i < kRows * 8; i += NT) {  // 64 k of a row of x: 8 pieces
      const int n = i / 8;
      const int c8 = (i % 8) * 8;
      cp_async16(stage + Cfg::kQBytes + 2 * Cfg::kSBytes + (n * Cfg::kXStride + c8) * 2,
                 xb + (size_t)n * K + (size_t)s * 2 * kStageRows + c8);
    }
  };

  float acc[Cfg::kSets][4][4];
#pragma unroll
  for (int set = 0; set < Cfg::kSets; ++set) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[set][j][e] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) fetch(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s has landed; every thread is done with stage s - 1
    const int nxt = s + STAGES - 1;
    if (nxt < n_stages) fetch(nxt, nxt % STAGES);
    cp_async_commit();

    const unsigned char* stage = ring + (size_t)(s % STAGES) * Cfg::kStageBytes;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(stage);
    const float* scs = reinterpret_cast<const float*>(stage + Cfg::kQBytes);
    const float* mns = reinterpret_cast<const float*>(stage + Cfg::kQBytes + Cfg::kSBytes);
    const uint32_t* xw =
        reinterpret_cast<const uint32_t*>(stage + Cfg::kQBytes + 2 * Cfg::kSBytes);
#pragma unroll
    for (int gi = 0; gi < kGroupsPerStage; ++gi) {
      // sums of x over the group for the rows n = 2t and 2t + 1 of this
      // thread's results: 4 lanes share a row of x, 4 words each
      float xsum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t p = xw[g * XW + gi * kG2 + t * 4 + i];
        xsum += __uint_as_float(p << 16) + __uint_as_float(p & 0xFFFF0000u);
      }
      xsum += __shfl_xor_sync(0xFFFFFFFFu, xsum, 1);
      xsum += __shfl_xor_sync(0xFFFFFFFFu, xsum, 2);
      const float xs0 = __shfl_sync(0xFFFFFFFFu, xsum, 8 * t);
      const float xs1 = __shfl_sync(0xFFFFFFFFu, xsum, 8 * t + 4);
#pragma unroll
      for (int set = 0; set < Cfg::kSets; ++set) {
        const int cb = (warp * Cfg::kSets + set) * 64;  // the set's first column
        float gsum[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) gsum[j][e] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {  // 16 rows of K = 8 byte rows a step
          const int rb = gi * kG2 + ks * 8;
          const uint32_t b0 = xw[g * XW + rb + t];
          const uint32_t b1 = xw[g * XW + rb + t + 4];
          uint32_t a00[4], a01[4], a10[4], a11[4];
          unpack_pairs<FP>(qw[(rb + t) * QW + cb / 4 + g], a00);
          unpack_pairs<FP>(qw[(rb + t) * QW + cb / 4 + g + 8], a01);
          unpack_pairs<FP>(qw[(rb + t + 4) * QW + cb / 4 + g], a10);
          unpack_pairs<FP>(qw[(rb + t + 4) * QW + cb / 4 + g + 8], a11);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t a[4] = {a00[j], a01[j], a10[j], a11[j]};
            mma_bf16(gsum[j], a, b0, b1);
          }
        }
        const float4 sa = *reinterpret_cast<const float4*>(scs + gi * TO + cb + 4 * g);
        const float4 sb = *reinterpret_cast<const float4*>(scs + gi * TO + cb + 32 + 4 * g);
        const float4 ma = *reinterpret_cast<const float4*>(mns + gi * TO + cb + 4 * g);
        const float4 mb = *reinterpret_cast<const float4*>(mns + gi * TO + cb + 32 + 4 * g);
        const float s_lo[4] = {sa.x, sa.y, sa.z, sa.w}, s_hi[4] = {sb.x, sb.y, sb.z, sb.w};
        const float m_lo[4] = {ma.x, ma.y, ma.z, ma.w}, m_hi[4] = {mb.x, mb.y, mb.z, mb.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[set][j][0] = fmaf(s_lo[j], gsum[j][0], fmaf(m_lo[j], xs0, acc[set][j][0]));
          acc[set][j][1] = fmaf(s_lo[j], gsum[j][1], fmaf(m_lo[j], xs1, acc[set][j][1]));
          acc[set][j][2] = fmaf(s_hi[j], gsum[j][2], fmaf(m_hi[j], xs0, acc[set][j][2]));
          acc[set][j][3] = fmaf(s_hi[j], gsum[j][3], fmaf(m_hi[j], xs1, acc[set][j][3]));
        }
      }
    }
  }
  cp_async_wait<0>();

  // results: rows 2t and 2t + 1 of x, columns 4g .. 4g+3 and 32 + 4g .. of each set
  float* out = dst + (size_t)kt * N * O + (size_t)n0 * O + (size_t)jo * TO;
#pragma unroll
  for (int set = 0; set < Cfg::kSets; ++set) {
    const int col = (warp * Cfg::kSets + set) * 64 + 4 * g;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* p = out + (size_t)(2 * t + (e & 1)) * O + col + (e >> 1) * 32;
      *reinterpret_cast<float4*>(p) =
          make_float4(acc[set][0][e], acc[set][1][e], acc[set][2][e], acc[set][3][e]);
    }
  }
}

template <int TO, bool FP>
cudaError_t launch_eo(const void* x, const void* q, const void* sc, const void* mn, void* dst,
                      int N, int K, int O, int tk, int tiled, cudaStream_t st) {
  auto kern = qmm4_eo_kernel<TO, FP>;
  const size_t smem = EoCfg<TO>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(O / TO, N / kRows, K / tk);
  kern<<<grid, EoCfg<TO>::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(sc), static_cast<const float*>(mn), static_cast<float*>(dst), N,
      K, O, tk, tiled);
  return cudaGetLastError();
}

// y = x . W over even/odd packed planes with a (8, to, tk) tile: the shared
// launcher of B2 (to 512, either unpack), B3 and B4 (the bit-operation unpack).
int eo_launch(const void* x, const void* q, const void* sc, const void* mn, void* part,
              void* out, int N, int K, int O, int group, int to, int tk, int fp, int tiled,
              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || N % kRows != 0 || N / kRows > 65535 || group != kGroup || to <= 0 || tk <= 0 ||
      O % to != 0 || K % tk != 0 || tk % (2 * kStageRows) != 0 || K / tk > 65535 ||
      (!fp && to != 512)) {
    return (int)cudaErrorInvalidValue;
  }
  const int splits = K / tk;
  void* dst = splits > 1 ? part : out;
  if (dst == nullptr) return (int)cudaErrorInvalidValue;
  // the tile sweeps take the cheaper unpack: both give the same bits
  cudaError_t err;
  switch (to) {
    case 128: err = launch_eo<128, true>(x, q, sc, mn, dst, N, K, O, tk, tiled, st); break;
    case 256: err = launch_eo<256, true>(x, q, sc, mn, dst, N, K, O, tk, tiled, st); break;
    case 512:
      err = fp ? launch_eo<512, true>(x, q, sc, mn, dst, N, K, O, tk, tiled, st)
               : launch_eo<512, false>(x, q, sc, mn, dst, N, K, O, tk, tiled, st);
      break;
    case 1024: err = launch_eo<1024, true>(x, q, sc, mn, dst, N, K, O, tk, tiled, st); break;
    case 2048: err = launch_eo<2048, true>(x, q, sc, mn, dst, N, K, O, tk, tiled, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) err = split_sum(part, out, (size_t)N * O, splits, st);
  return (int)err;
}

}  // namespace

// B1. qp [K2, O] int8, sc and mn [K2/g2, O] f32, part [splits, 8, O] f32
// scratch (used when splits > 1), out [8, O] f32. tk2 byte rows and
// ts = tk2/g2 scale rows make a tile; tk2 % 32 == 0, ts % 8 == 0, K2 % tk2 ==
// 0, O % 256 == 0. Each strip of 256 columns is walked by `splits` blocks.
// Returns cudaGetLastError().
extern "C" int stream_planes_launch(const void* qp, const void* sc, const void* mn, void* part,
                                    void* out, int K2, int O, int tk2, int ts, int splits,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K2 <= 0 || O <= 0 || O % kStreamCols != 0 || tk2 <= 0 || tk2 % kStreamQRows != 0 ||
      ts <= 0 || ts % kStreamSRows != 0 || K2 % tk2 != 0 || splits <= 0 || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int cpt = tk2 / kStreamQRows + 2 * (ts / kStreamSRows);
  const int n_chunks = (K2 / tk2) * cpt;
  const int per_block = (n_chunks + splits - 1) / splits;
  void* dst = splits > 1 ? part : out;
  if (dst == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kStreamStages * kStreamChunk;
  cudaError_t err = cudaFuncSetAttribute(stream_planes_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(O / kStreamCols, splits);
  stream_planes_kernel<<<grid, kStreamThreads, smem, st>>>(
      static_cast<const int8_t*>(qp), static_cast<const float*>(sc),
      static_cast<const float*>(mn), static_cast<float*>(dst), O, tk2, ts, n_chunks, per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) err = split_sum(part, out, (size_t)8 * O, splits, st);
  return (int)err;
}

// B2. x [N, K] bf16, qp [K/2, O], sc and mn [K/group, O] f32, out [N, O] f32;
// the reference's fixed tile (8, 512, 2048); fp picks the unpack. part
// [K/2048, N, O] f32 scratch when K > 2048.
extern "C" int qmm4_variant_launch(const void* x, const void* qp, const void* sc, const void* mn,
                                   void* part, void* out, int N, int K, int O, int group, int fp,
                                   void* stream) {
  return eo_launch(x, qp, sc, mn, part, out, N, K, O, group, 512, 2048, fp, 0, stream);
}

// B3. As B2 with the tile (tn, to, tk) given: tn 8; to 128, 256, 512, 1024 or
// 2048; tk a multiple of 64 that divides K. part [K/tk, N, O] when K > tk.
extern "C" int qmm_tiled_launch(const void* x, const void* qp, const void* sc, const void* mn,
                                void* part, void* out, int N, int K, int O, int group, int tn,
                                int to, int tk, void* stream) {
  if (tn != kRows) return (int)cudaErrorInvalidValue;
  return eo_launch(x, qp, sc, mn, part, out, N, K, O, group, to, tk, 1, 0, stream);
}

// B4. q4 [K/tk, O/to, tk/2, to], sc4 and mn4 [K/tk, O/to, tk/group, to]: one
// block per tile, tiles as in B3.
extern "C" int qmm_tiled4d_launch(const void* x, const void* q4, const void* sc4,
                                  const void* mn4, void* part, void* out, int N, int K, int O,
                                  int group, int to, int tk, void* stream) {
  return eo_launch(x, q4, sc4, mn4, part, out, N, K, O, group, to, tk, 1, 1, stream);
}
