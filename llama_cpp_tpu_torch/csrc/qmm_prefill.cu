// Fused dequantize + GEMM over block-scaled weight planes at prefill row
// counts, for Hopper: warpgroup MMA (wgmma) from shared memory, operands
// staged asynchronously, each weight tile dequantized once for 128 rows of x.
//
// Replaces the TPU Pallas kernels of llama_cpp_tpu/ops/pallas/qmm.py at
// 64 <= N < 1024 rows (PREFILL_MIN_N .. XLA_PREFILL_MIN_N):
//   qmm4_planes_prefill  (_qmm4_prefill_kernel_u)  packed 4-bit planes (Q4_K)
//   qmm_planes_prefill   (_qmm_prefill_kernel_u)   int8 planes (Q6_K)
// Function: y[N, O] (f32) = x[N, K] (bf16) . W[K, O], where
//   W[k, o] = q[k, o] * scale(k, o) + min(k, o)
//   scale   = sub[k/g, o] * d[k/256, o]     (hierarchical, int8 sub + f32 d)
//           | scales[k/g, o]                (flat f32)
//   min     = subm[k/g, o] * dmin[k/256, o] | mins[k/g, o] | 0
// Packed planes hold two 4-bit rows per byte, half-split: byte [r, o] has
// row r in its low nibble and row r + K/2 in its high nibble.
//
// What bounds it on an H100: the bf16 tensor-core operations (N = 512: 2 N K
// O flops over 989 TFLOP/s is 4-7x the weight bytes over 3.35 TB/s).
//
// Design. A block computes 128 rows x 128 columns of y over a range of K
// (split-K where the grid is short of the card), walking K in steps of 64.
// It has three warpgroups and one more warp, which pass shared-memory tiles
// through rings completed on mbarriers:
//  * one thread of warp 12 issues every copy by TMA (cp.async.bulk.tensor):
//    per step the x tile [128 rows, 64 k] into the A ring (K-major, 128-byte
//    swizzle, rows past N zero-filled), and up to 3 blocks ahead each raw
//    64-row block of plane bytes [64, 128] with its scale rows into a ring of
//    4;
//  * warpgroup 2 dequantizes: from a raw block it writes the bf16 weight tile
//    [64 k, 128 columns] into the B ring in the layout wgmma reads for an
//    MN-major B (128-byte swizzle, 64-column atoms). Packed planes: one raw
//    block yields two steps, the low nibbles (k = r) and the high nibbles
//    (k = K/2 + r), so every plane byte is read once, as in the Pallas
//    kernel. A nibble pair becomes bf16 by a byte permute into the mantissa
//    of 128.0, one bf16x2 subtraction and one bf16x2 FMA with the group's
//    scale and min rounded to bf16 (an NMSE near 1e-5 from the plain
//    version, which rounds only W). Int8 bytes do not fit a bf16 mantissa:
//    they go through f32 (permute into 2^23, subtract, FMA with the f32 scale
//    and min) and one f32x2 -> bf16x2 conversion a pair. These threads issue
//    no copies, so their proxy fence before each release is cheap;
//  * warpgroups 0 and 1 (64 rows each) run 4 wgmma m64n128k16 a step into 64
//    f32 registers a thread, keep one step's MMAs in flight, and release a
//    stage when its MMAs are done. 4 stages of 32 KB and 4 raw blocks of 16
//    KB: 193 KB of shared memory, one block an SM.
// Split-K partial sums go to a scratch buffer that a second kernel adds in a
// fixed order, so results do not change from run to run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;            // rows of x per block (two consumer warpgroups)
constexpr int kBN = 128;            // output columns per block
constexpr int kBK = 64;             // K per step (one 128-byte swizzle row of bf16)
constexpr int kStages = 4;          // ring of x and weight tiles
constexpr int kRawStages = 4;       // ring of raw 64-row plane blocks
constexpr int kThreads = 416;       // warpgroups 0-1 consume, 2 dequantizes; warp 12 copies
constexpr int kTileA = kBM * kBK * 2;  // 16 KB: x tile
constexpr int kTileB = kBK * kBN * 2;  // 16 KB: weight tile
constexpr int kStageBytes = kTileA + kTileB;
// a raw block: 64 plane rows x 128 columns (8 KB), then per half (low, high)
// 4 KB of scale rows: scales at 0 (hierarchical d at 512), mins at 2048
// (dmin at 2560)
constexpr int kRawBytes = 8192 + 2 * 4096;
constexpr int kBarBytes = 8 * (2 * kStages + 2 * kRawStages);
constexpr int kSmemBytes = kStages * kStageBytes + kRawStages * kRawBytes + kBarBytes + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// TMA: the box of tensor map `map` at (c0 inner, c1 row) -> shared memory at
// dst; the barrier's transaction count falls by its bytes when it lands
// (rows past the tensor's end land as zeros)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// generic-proxy shared-memory writes become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

#define QP_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] += A (64 x 16, K-major) . B (16 x 128, MN-major), bf16 in, f32 out
__device__ __forceinline__ void wgmma_m64n128k16(float d[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : QP_ACC8(0), QP_ACC8(8), QP_ACC8(16), QP_ACC8(24), QP_ACC8(32), QP_ACC8(40), QP_ACC8(48),
        QP_ACC8(56)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// orders the compiler's uses of the accumulators after the wgmma waits
__device__ __forceinline__ void fence_acc(float d[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
#undef QP_ACC8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the f32 scale and min of columns 4 cq .. 4 cq + 3 at group row gr of one
// half of a raw block (h: its scale rows in shared memory)
__device__ __forceinline__ void read_group(const unsigned char* h, int gr, int cq, bool hier,
                                           bool mins, float s[4], float m[4]) {
  if (hier) {
    const char4 sub = *reinterpret_cast<const char4*>(h + gr * kBN + 4 * cq);
    const float4 d = *reinterpret_cast<const float4*>(h + 512 + 16 * cq);
    s[0] = (float)sub.x * d.x; s[1] = (float)sub.y * d.y;
    s[2] = (float)sub.z * d.z; s[3] = (float)sub.w * d.w;
    if (mins) {
      const char4 sm = *reinterpret_cast<const char4*>(h + 2048 + gr * kBN + 4 * cq);
      const float4 dm = *reinterpret_cast<const float4*>(h + 2560 + 16 * cq);
      m[0] = (float)sm.x * dm.x; m[1] = (float)sm.y * dm.y;
      m[2] = (float)sm.z * dm.z; m[3] = (float)sm.w * dm.w;
    }
  } else {
    const float4 a = *reinterpret_cast<const float4*>(h + gr * kBN * 4 + 16 * cq);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    if (mins) {
      const float4 b = *reinterpret_cast<const float4*>(h + 2048 + gr * kBN * 4 + 16 * cq);
      m[0] = b.x; m[1] = b.y; m[2] = b.z; m[3] = b.w;
    }
  }
  if (!mins) m[0] = m[1] = m[2] = m[3] = 0.f;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 4 nibbles (one per byte of v, values 0..15) -> 2 words of bf16x2 n * s + m
__device__ __forceinline__ uint2 dequant_nibbles(uint32_t v, __nv_bfloat162 s01,
                                                 __nv_bfloat162 s23, __nv_bfloat162 m01,
                                                 __nv_bfloat162 m23) {
  const __nv_bfloat162 c128 = __floats2bfloat162_rn(128.f, 128.f);
  // bytes [n0, 0x43, n1, 0x43] are the bf16 pair (128 + n0, 128 + n1)
  uint32_t p01 = __byte_perm(v, 0x43u, 0x4140);
  uint32_t p23 = __byte_perm(v, 0x43u, 0x4342);
  __nv_bfloat162 w01 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p01), c128);
  __nv_bfloat162 w23 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p23), c128);
  return make_uint2(bf16x2_bits(__hfma2(w01, s01, m01)), bf16x2_bits(__hfma2(w23, s23, m23)));
}

// 4 int8 bytes of w -> 2 words of bf16x2 q * s + m (f32 arithmetic)
__device__ __forceinline__ uint2 dequant_int8(uint32_t w, const float s[4], const float m[4]) {
  const uint32_t u = w ^ 0x80808080u;  // int8 + 128
  float f[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    f[c] = fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + c)) - 8388736.f, s[c], m[c]);
  }
  return make_uint2(bf16x2_bits(__floats2bfloat162_rn(f[0], f[1])),
                    bf16x2_bits(__floats2bfloat162_rn(f[2], f[3])));
}

// byte offset of weight (k, n) in the MN-major 128-byte-swizzled B tile:
// 64-column atoms of 64 k rows x 128 bytes, 16-byte chunks XOR k % 8
__device__ __forceinline__ uint32_t b_offset(int k, int n) {
  return (uint32_t)((n >> 6) * (kBK * 128) + k * 128 + ((((n & 63) >> 3) ^ (k & 7)) << 4) +
                    (n & 7) * 2);
}

template <bool PACKED, int G>
__global__ void __launch_bounds__(kThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_sc,
                 const __grid_constant__ CUtensorMap tm_d,
                 const __grid_constant__ CUtensorMap tm_mn,
                 const __grid_constant__ CUtensorMap tm_dm, float* __restrict__ out, int N,
                 int K, int O, int hier, int mins, int rows_per_split) {
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms need 1024-byte alignment of every tile
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_addr);
  const uint32_t raw_base = base + kStages * kStageBytes;
  const uint32_t bars = raw_base + kRawStages * kRawBytes;
  // full[s], empty[s], raw_full[t], raw_empty[t]
  const uint32_t full = bars, empty = bars + 8 * kStages;
  const uint32_t raw_full = bars + 16 * kStages, raw_empty = raw_full + 8 * kRawStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int o_blk = blockIdx.x * kBN;
  const int n0 = blockIdx.y * kBM;
  const int r_begin = blockIdx.z * rows_per_split;
  const int n_blocks = rows_per_split / 64;            // 64-row blocks of plane rows
  constexpr int kParts = PACKED ? 2 : 1;               // K steps of 64 a block
  const int n_steps = n_blocks * kParts;
  const int half = K / 2;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1 + 128);    // the copying thread + dequantizing threads
      mbar_init(empty + 8 * s, 256);       // every consumer thread
    }
    for (int t = 0; t < kRawStages; ++t) {
      mbar_init(raw_full + 8 * t, 1);      // the copying thread
      mbar_init(raw_empty + 8 * t, 128);   // dequantizing threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 384) {
    // ---------------- one thread issues every copy (TMA) ----------------
    if (tid != 384) return;
    const int es = hier ? 1 : 4;  // bytes of a scale element
    const uint32_t half_bytes = ((64 / G) * kBN * es + (hier ? 512 : 0)) * (mins ? 2 : 1);
    const uint32_t raw_bytes = 8192 + kParts * half_bytes;
    auto issue_raw = [&](int j) {
      const int t = j % kRawStages;
      mbar_wait(raw_empty + 8 * t, ((j / kRawStages) & 1) ^ 1);
      const uint32_t bar = raw_full + 8 * t;
      mbar_expect_tx(bar, raw_bytes);
      const uint32_t dst = raw_base + t * kRawBytes;
      const int rb = r_begin + 64 * j;
      tma_load(dst, &tm_q, o_blk, rb, bar);
#pragma unroll
      for (int h = 0; h < kParts; ++h) {
        const uint32_t hd = dst + 8192 + h * 4096;
        const int kb = rb + h * half;
        tma_load(hd, &tm_sc, o_blk, kb / G, bar);
        if (hier) tma_load(hd + 512, &tm_d, o_blk, kb / 256, bar);
        if (mins) {
          tma_load(hd + 2048, &tm_mn, o_blk, kb / G, bar);
          if (hier) tma_load(hd + 2560, &tm_dm, o_blk, kb / 256, bar);
        }
      }
    };
    // raw blocks run up to kRawStages - 1 blocks ahead of the x tiles
    int j_raw = 0;
    for (int it = 0; it < n_steps; ++it) {
      const int j = it / kParts;
      for (; j_raw < n_blocks && j_raw < j + kRawStages - 1; ++j_raw) issue_raw(j_raw);
      const int s = it % kStages;
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);  // the stage is free
      // x [n0 .. n0+128, kx .. kx+64) -> A (K-major, 128-byte swizzle)
      mbar_expect_tx(full + 8 * s, kTileA);
      tma_load(base + s * kStageBytes, &tm_x, r_begin + 64 * j + (it % kParts ? half : 0), n0,
               full + 8 * s);
    }
  } else if (wg == 2) {
    // ---------------- dequantizing warpgroup ----------------
    const int p = tid - 256;
    const int pw = p >> 5;         // rows 16 pw .. 16 pw + 15 of a 64-row block
    const int cq = p & 31;         // columns 4 cq .. 4 cq + 3 of the tile
    const int gr = 16 * pw / G;    // their scale group within the block
    int it = 0;
    for (int j = 0; j < n_blocks; ++j) {
      const int t = j % kRawStages;
      mbar_wait(raw_full + 8 * t, (j / kRawStages) & 1);
      const unsigned char* raw = smem + kStages * kStageBytes + t * kRawBytes;
      uint32_t w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        w[i] = *reinterpret_cast<const uint32_t*>(raw + (16 * pw + i) * kBN + 4 * cq);
      }
      float sf[kParts][4], mf[kParts][4];
#pragma unroll
      for (int h = 0; h < kParts; ++h) {
        read_group(raw + 8192 + h * 4096, gr, cq, hier, mins, sf[h], mf[h]);
      }
      mbar_arrive(raw_empty + 8 * t);  // the raw block is in registers
#pragma unroll
      for (int h = 0; h < kParts; ++h) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);  // the stage is free
        unsigned char* b_tile = smem + s * kStageBytes + kTileA;
        // the weight tile: rows 16 pw + i, columns 4 cq .. 4 cq + 3
        if (PACKED) {
          const __nv_bfloat162 s01 = __floats2bfloat162_rn(sf[h][0], sf[h][1]);
          const __nv_bfloat162 s23 = __floats2bfloat162_rn(sf[h][2], sf[h][3]);
          const __nv_bfloat162 m01 = __floats2bfloat162_rn(mf[h][0], mf[h][1]);
          const __nv_bfloat162 m23 = __floats2bfloat162_rn(mf[h][2], mf[h][3]);
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const uint32_t v = (h ? (w[i] >> 4) : w[i]) & 0x0F0F0F0Fu;
            *reinterpret_cast<uint2*>(b_tile + b_offset(16 * pw + i, 4 * cq)) =
                dequant_nibbles(v, s01, s23, m01, m23);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            *reinterpret_cast<uint2*>(b_tile + b_offset(16 * pw + i, 4 * cq)) =
                dequant_int8(w[i], sf[h], mf[h]);
          }
        }
        fence_proxy_async();
        mbar_arrive(full + 8 * s);
        ++it;
      }
    }
  } else {
    // ---------------- consumers ----------------
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t a_tile = base + s * kStageBytes + wg * (64 * 128);
      const uint32_t b_tile = base + s * kStageBytes + kTileA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: 8-row groups 1024 bytes apart, k advances 32 bytes in the row;
        // B: 64-column atoms 8 KB apart, 8-row k groups 1024 bytes apart
        wgmma_m64n128k16(acc, make_desc(a_tile + kk * 32, 16, 1024),
                         make_desc(b_tile + kk * 16 * 128, kBK * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's MMAs are done: release its stage
      if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // accumulator fragment: warp w of the warpgroup holds rows 16 w .. 16 w + 15;
    // acc[4 j + e] is row lane / 4 (+ 8 for e >= 2), column 8 j + 2 (lane % 4) + e % 2
    const int lane = tid & 31;
    const int row = n0 + wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
    float* dst = out + (size_t)blockIdx.z * N * O;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = o_blk + 8 * j + 2 * (lane & 3);
      if (row < N) {
        *reinterpret_cast<float2*>(dst + (size_t)row * O + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      }
      if (row + 8 < N) {
        *reinterpret_cast<float2*>(dst + (size_t)(row + 8) * O + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// out[i] = sum over s of part[s][i], in a fixed order
__global__ void prefill_split_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                         size_t count, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * count + i];
  out[i] = acc;
}

// cuTensorMapEncodeTiled, looked up once at run time through
// cudaGetDriverEntryPoint (no link against libcuda)
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// a 2-D row-major tensor [rows, cols] of `elem` bytes, boxes of box_cols x
// box_rows; the 128-byte swizzle for the x tiles
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem,
              uint64_t cols, uint64_t rows, uint32_t box_cols, uint32_t box_rows, bool swizzle) {
  const auto fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estrides,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <bool PACKED, int G>
cudaError_t launch_layout(dim3 grid, cudaStream_t st, const CUtensorMap* maps, float* dst, int N,
                          int K, int O, int hier, int mins, int rows_per_split) {
  auto* kern = qmm_wgmma_kernel<PACKED, G>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, kSmemBytes, st>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
                                           dst, N, K, O, hier, mins, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// x [N, K] bf16 (16-byte aligned rows); q [R, O] int8 planes (R = K/2
// packed, else K); sc [K/g, O] int8 (hier) or f32; d [K/256, O] f32 (hier);
// mn like sc or null; dm like d or null; part [splits, N, O] f32 scratch
// (used when splits > 1); out [N, O] f32. group is 16 or 32, K a multiple
// of 256, O of 128; each of the `splits` ranges covers R / splits plane
// rows, a multiple of 64. Returns cudaGetLastError().
extern "C" int qmm_prefill_launch(const void* x, const void* q, const void* sc, const void* d,
                                  const void* mn, const void* dm, void* part, void* out, int N,
                                  int K, int O, int group, int packed, int hier, int splits,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = packed ? K / 2 : K;
  if (N <= 0 || O % kBN != 0 || K % 256 != 0 || splits <= 0 || R % (splits * 64) != 0 ||
      (group != 16 && group != 32)) {
    return (int)cudaErrorInvalidValue;
  }
  // tensor maps: x [N, K] bf16 in 64 x 128 boxes (128-byte swizzle); the
  // planes in 128-column boxes of one 64-row block: q [R, O], scales and
  // mins [K/g, O] (64/g rows), d and dmin [K/256, O] (one row)
  CUtensorMap maps[6] = {};
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int es = hier ? 1 : 4;
  bool ok = make_map(&maps[0], x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, kBK, kBM, true) &&
            make_map(&maps[1], q, u8, 1, O, R, kBN, 64, false) &&
            make_map(&maps[2], sc, hier ? u8 : f32, es, O, K / group, kBN, 64 / group, false);
  if (ok && hier) ok = make_map(&maps[3], d, f32, 4, O, K / 256, kBN, 1, false);
  if (ok && mn != nullptr) {
    ok = make_map(&maps[4], mn, hier ? u8 : f32, es, O, K / group, kBN, 64 / group, false);
    if (ok && hier) ok = make_map(&maps[5], dm, f32, 4, O, K / 256, kBN, 1, false);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  const dim3 grid(O / kBN, (N + kBM - 1) / kBM, splits);
  const int rps = R / splits;
  const int mins = mn != nullptr;
  cudaError_t err;
  if (packed && group == 32) {  // Q4_K
    err = launch_layout<true, 32>(grid, st, maps, dst, N, K, O, hier, mins, rps);
  } else if (!packed && group == 16) {  // Q6_K
    err = launch_layout<false, 16>(grid, st, maps, dst, N, K, O, hier, mins, rps);
  } else if (packed) {  // Q6_K planes that fit in 4 bits
    err = launch_layout<true, 16>(grid, st, maps, dst, N, K, O, hier, mins, rps);
  } else {
    err = launch_layout<false, 32>(grid, st, maps, dst, N, K, O, hier, mins, rps);
  }
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const size_t count = (size_t)N * O;
    const int threads = 256;
    prefill_split_sum_kernel<<<(unsigned)((count + threads - 1) / threads), threads, 0, st>>>(
        static_cast<const float*>(part), static_cast<float*>(out), count, splits);
    err = cudaGetLastError();
  }
  return (int)err;
}
