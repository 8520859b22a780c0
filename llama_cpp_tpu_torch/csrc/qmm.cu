// Fused dequantize + GEMV/GEMM over block-scaled weight planes, for Hopper.
//
// Replaces the TPU Pallas kernels of llama_cpp_tpu/ops/pallas/qmm.py:
//   qmm4_planes          (_qmm4_kernel_u)          packed 4-bit, decode rows
//   qmm4_planes_prefill  (_qmm4_prefill_kernel_u)  packed 4-bit, 64..1023 rows
//   qmm_planes           (_qmm_kernel_u)           int8 planes, decode rows
//   qmm_planes_prefill   (_qmm_prefill_kernel_u)   int8 planes, 64..1023 rows
// The GEMV/prefill split there is a VMEM tile policy of the TPU. Here the
// row count picks between two kernels that compute the same function: a
// CUDA-core GEMV for N <= gemv_max_n (the wrapper passes 4, the measured
// crossover on an H100) and a tensor-core (mma.sync bf16) GEMM above.
//
// Function: y[N, O] (f32) = x[N, K] (bf16) . W[K, O], where
//   W[k, o] = q[k, o] * scale(k, o) + min(k, o)
//   scale   = sub[k/g, o] * d[k/256, o]     (hierarchical, int8 sub + f32 d)
//           | scales[k/g, o]                (flat f32)
//   min     = subm[k/g, o] * dmin[k/256, o] | mins[k/g, o] | 0
// Packed planes hold two 4-bit rows per byte, half-split: byte [r, o] has
// row r in its low nibble and row r + K/2 in its high nibble. The plain
// version (ops/kernels/qmm.py qmm_plain) is the JAX package's dequant -> dot:
// W rounded to bf16 once, f32 accumulation. The GEMM kernel rounds W the same
// way; the GEMV keeps q * scale in f32 (scale and min applied per group), so
// it differs from the plain version by that one bf16 rounding of W.
//
// What bounds it on an H100: at decode (N <= 32) the weight bytes, 0.5 B per
// Q4_K element (+1/32 B of int8 sub-scales), 0.8 B per Q6_K element; at
// N = 512 the bf16 tensor-core FLOPs.
//
// Design. GEMV: one warp per block, each thread owns 4 adjacent output
// columns (one 32-bit load per plane row, a warp reads 128 contiguous bytes:
// coalesced). Bytes become floats with a byte permute into the mantissa of
// 2^23 and one subtraction (full-rate ops, no int->float conversion);
// products q * x are summed per scale group and scaled once per group, the
// mins term taken from per-group sums of x. Decode shapes have too few
// column blocks for 132 SMs, so K is split across blockIdx.z.
// GEMM: 4 warps per block, a BM x 128 output tile (BM = 16, 32 or 64 rows);
// per 32-deep K step the block stages x (bf16) and the dequantized weight
// tile (bf16, column-major, padded rows: conflict-free fragment loads) in
// shared memory and each warp runs mma.sync m16n8k16 on its 32 columns,
// while the next step's x and weight words load into registers.
// Split-K partial sums of both go to a scratch buffer that a second kernel
// adds in a fixed order, so results do not change from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;   // output columns per block
constexpr int kChunk = 64;   // GEMV: plane rows of x staged per step
constexpr int kBK = 32;      // GEMM: K per step
constexpr int kPad = 8;      // GEMM: bf16 padding of a shared-memory row

// 4 unsigned bytes -> 4 exact floats: 0x4B0000bb is 2^23 + b
__device__ __forceinline__ void ubytes_to_float4(uint32_t w, float bias, float f[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    f[c] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + c)) - bias;
  }
}

// the 4 weights of plane-row word `wb` for the low or high half, as floats
template <bool PACKED>
__device__ __forceinline__ void decode_q(uint32_t wb, bool hi, float f[4]) {
  if (PACKED) {
    ubytes_to_float4((hi ? (wb >> 4) : wb) & 0x0F0F0F0Fu, 8388608.f, f);
  } else {
    ubytes_to_float4(wb ^ 0x80808080u, 8388736.f, f);  // int8 + 128, unbiased
  }
}

// effective scale and min of 4 columns for (weight) row k
__device__ __forceinline__ void load_group(const void* sc, const float* d, const void* mn,
                                           const float* dm, int k, int g, int O, int o0,
                                           int hier, float s[4], float m[4]) {
  const size_t gi = (size_t)(k / g) * O + o0;
  if (hier) {
    const char4 sub = *reinterpret_cast<const char4*>(static_cast<const int8_t*>(sc) + gi);
    const float4 dd = *reinterpret_cast<const float4*>(d + (size_t)(k / 256) * O + o0);
    s[0] = __fmul_rn((float)sub.x, dd.x);
    s[1] = __fmul_rn((float)sub.y, dd.y);
    s[2] = __fmul_rn((float)sub.z, dd.z);
    s[3] = __fmul_rn((float)sub.w, dd.w);
    if (mn != nullptr) {
      const char4 sm = *reinterpret_cast<const char4*>(static_cast<const int8_t*>(mn) + gi);
      const float4 dmm = *reinterpret_cast<const float4*>(dm + (size_t)(k / 256) * O + o0);
      m[0] = __fmul_rn((float)sm.x, dmm.x);
      m[1] = __fmul_rn((float)sm.y, dmm.y);
      m[2] = __fmul_rn((float)sm.z, dmm.z);
      m[3] = __fmul_rn((float)sm.w, dmm.w);
    } else {
      m[0] = m[1] = m[2] = m[3] = 0.f;
    }
  } else {
    const float4 ss = *reinterpret_cast<const float4*>(static_cast<const float*>(sc) + gi);
    s[0] = ss.x; s[1] = ss.y; s[2] = ss.z; s[3] = ss.w;
    if (mn != nullptr) {
      const float4 mm = *reinterpret_cast<const float4*>(static_cast<const float*>(mn) + gi);
      m[0] = mm.x; m[1] = mm.y; m[2] = mm.z; m[3] = mm.w;
    } else {
      m[0] = m[1] = m[2] = m[3] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// GEMV, N <= gemv_max_n (BN = 1, 2, 4 or 8 rows per launch)
// ---------------------------------------------------------------------------

template <int BN, bool PACKED, int G>
__global__ void __launch_bounds__(32)
qmm_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                const void* __restrict__ sc, const float* __restrict__ d,
                const void* __restrict__ mn, const float* __restrict__ dm,
                float* __restrict__ out, int N, int K, int O, int hier, int rows_per_split) {
  constexpr int NX = PACKED ? 2 : 1;  // x halves (lo rows, hi rows)
  constexpr int NG = kChunk / G;      // scale groups per chunk
  __shared__ __align__(16) float xs[NX][kChunk][BN];
  __shared__ float xsum[NX][NG][BN];

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * kCols + tid * 4;
  const int half = K / 2;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = r_begin + rows_per_split;

  float acc[BN][4];
#pragma unroll
  for (int n = 0; n < BN; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  }

  for (int rc = r_begin; rc < r_end; rc += kChunk) {
    __syncthreads();
    // stage x[0 .. BN, rc .. rc+64) (+ the hi half); consecutive threads read
    // consecutive k (coalesced)
    for (int i = tid; i < NX * BN * kChunk; i += 32) {
      const int rr = i % kChunk;
      const int n = (i / kChunk) % BN;
      const int hx = i / (kChunk * BN);
      float v = 0.f;
      if (n < N) v = __bfloat162float(x[(size_t)n * K + rc + rr + hx * half]);
      xs[hx][rr][n] = v;
    }
    __syncthreads();
    for (int i = tid; i < NX * NG * BN; i += 32) {
      const int n = i % BN;
      const int gi = (i / BN) % NG;
      const int hx = i / (BN * NG);
      float s = 0.f;
      for (int j = 0; j < G; ++j) s += xs[hx][gi * G + j][n];
      xsum[hx][gi][n] = s;
    }
    __syncthreads();

#pragma unroll 1
    for (int gi = 0; gi < NG; ++gi) {
      const int r0 = rc + gi * G;
      float gl[BN][4], gh[BN][4];
#pragma unroll
      for (int n = 0; n < BN; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) gl[n][c] = gh[n][c] = 0.f;
      }
#pragma unroll 8
      for (int j = 0; j < G; ++j) {
        const uint32_t wb = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(r0 + j) * O + o0));
        float ql[4], qh[4];
        decode_q<PACKED>(wb, false, ql);
        if (PACKED) decode_q<PACKED>(wb, true, qh);
#pragma unroll
        for (int n = 0; n < BN; ++n) {
          const float xl = xs[0][gi * G + j][n];
#pragma unroll
          for (int c = 0; c < 4; ++c) gl[n][c] = fmaf(ql[c], xl, gl[n][c]);
          if (PACKED) {
            const float xh = xs[NX - 1][gi * G + j][n];
#pragma unroll
            for (int c = 0; c < 4; ++c) gh[n][c] = fmaf(qh[c], xh, gh[n][c]);
          }
        }
      }
      float s_lo[4], m_lo[4];
      load_group(sc, d, mn, dm, r0, G, O, o0, hier, s_lo, m_lo);
#pragma unroll
      for (int n = 0; n < BN; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[n][c] = fmaf(s_lo[c], gl[n][c], fmaf(m_lo[c], xsum[0][gi][n], acc[n][c]));
        }
      }
      if (PACKED) {
        float s_hi[4], m_hi[4];
        load_group(sc, d, mn, dm, r0 + half, G, O, o0, hier, s_hi, m_hi);
#pragma unroll
        for (int n = 0; n < BN; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[n][c] = fmaf(s_hi[c], gh[n][c], fmaf(m_hi[c], xsum[NX - 1][gi][n], acc[n][c]));
          }
        }
      }
    }
  }

  float* dst = out + (size_t)blockIdx.z * N * O;
#pragma unroll
  for (int n = 0; n < BN; ++n) {
    if (n < N) {
      *reinterpret_cast<float4*>(dst + (size_t)n * O + o0) =
          make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// GEMM on the tensor cores, N > gemv_max_n
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

template <int MI, bool PACKED, int G>
__global__ void __launch_bounds__(128)
qmm_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
               const void* __restrict__ sc, const float* __restrict__ d,
               const void* __restrict__ mn, const float* __restrict__ dm,
               float* __restrict__ out, int N, int K, int O, int hier, int k_per_split) {
  constexpr int BM = 16 * MI;
  constexpr int ST = kBK + kPad;  // shared row stride in bf16 (80 bytes)
  __shared__ __align__(16) __nv_bfloat16 xs[BM][ST];
  __shared__ __align__(16) __nv_bfloat16 ws[kCols][ST];  // [column][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int o_blk = blockIdx.x * kCols;
  const int n0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int half = K / 2;
  // this thread's share of the weight tile: 4 columns x 8 k rows
  const int col4 = (tid & 31) * 4;
  const int kq = tid >> 5;

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
    }
  }

  // the next K step's x and weight words are loaded into registers while
  // the tensor cores work on the current one
  constexpr int XR = (BM * (kBK / 8) + 127) / 128;  // 16-byte x chunks per thread
  uint4 xreg[XR];
  uint32_t wreg[8];
  auto load_step = [&](int k0) {
#pragma unroll
    for (int u = 0; u < XR; ++u) {
      const int i = tid + u * 128;
      const int r = i / (kBK / 8);
      const int c8 = (i % (kBK / 8)) * 8;
      xreg[u] = make_uint4(0, 0, 0, 0);
      if (i < BM * (kBK / 8) && n0 + r < N) {
        xreg[u] = *reinterpret_cast<const uint4*>(x + (size_t)(n0 + r) * K + k0 + c8);
      }
    }
    const int kk = k0 + kq * 8;
    const int r_plane = PACKED && kk >= half ? kk - half : kk;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wreg[j] = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(r_plane + j) * O + o_blk + col4));
    }
  };

  const int k_end = k_begin + k_per_split;
  load_step(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous step's fragments are read
#pragma unroll
    for (int u = 0; u < XR; ++u) {
      const int i = tid + u * 128;
      if (i < BM * (kBK / 8)) {
        *reinterpret_cast<uint4*>(&xs[i / (kBK / 8)][(i % (kBK / 8)) * 8]) = xreg[u];
      }
    }
    {
      const int kk = k0 + kq * 8;
      const bool hi = PACKED && kk >= half;
      float s[4], m[4];
      load_group(sc, d, mn, dm, kk, G, O, o_blk + col4, hier, s, m);
      uint32_t packed_w[4][4];  // [column][k pair]
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        float f0[4], f1[4];
        decode_q<PACKED>(wreg[j], hi, f0);
        decode_q<PACKED>(wreg[j + 1], hi, f1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          packed_w[c][j / 2] = pack_bf16x2(__fadd_rn(__fmul_rn(f0[c], s[c]), m[c]),
                                           __fadd_rn(__fmul_rn(f1[c], s[c]), m[c]));
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<uint4*>(&ws[col4 + c][kq * 8]) =
            make_uint4(packed_w[c][0], packed_w[c][1], packed_w[c][2], packed_w[c][3]);
      }
    }
    if (k0 + kBK < k_end) load_step(k0 + kBK);
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < kBK; kb += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = warp * 32 + nt * 8 + g;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(&ws[col][kb + 2 * t]);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(&ws[col][kb + 2 * t + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = mi * 16 + g;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(&xs[row][kb + 2 * t]);
        a[1] = *reinterpret_cast<const uint32_t*>(&xs[row + 8][kb + 2 * t]);
        a[2] = *reinterpret_cast<const uint32_t*>(&xs[row][kb + 2 * t + 8]);
        a[3] = *reinterpret_cast<const uint32_t*>(&xs[row + 8][kb + 2 * t + 8]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mi][nt], a, b[nt]);
      }
    }
  }

  float* dst = out + (size_t)blockIdx.z * N * O;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int row = n0 + mi * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = o_blk + warp * 32 + nt * 8 + 2 * t;
      if (row < N) {
        *reinterpret_cast<float2*>(dst + (size_t)row * O + col) =
            make_float2(acc[mi][nt][0], acc[mi][nt][1]);
      }
      if (row + 8 < N) {
        *reinterpret_cast<float2*>(dst + (size_t)(row + 8) * O + col) =
            make_float2(acc[mi][nt][2], acc[mi][nt][3]);
      }
    }
  }
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

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* q;
  const void* sc;
  const float* d;
  const void* mn;
  const float* dm;
  float* dst;
  int N, K, O, hier;
};

template <bool PACKED, int G>
cudaError_t launch_layout(const Args& a, int splits, int gemv_max_n, cudaStream_t st) {
  if (a.N <= gemv_max_n) {
    const int bn = a.N <= 1 ? 1 : a.N <= 2 ? 2 : a.N <= 4 ? 4 : 8;
    const int rps = (PACKED ? a.K / 2 : a.K) / splits;
    const dim3 grid(a.O / kCols, 1, splits);
#define QMM_GEMV(B)                                                                  \
  case B:                                                                            \
    qmm_gemv_kernel<B, PACKED, G><<<grid, 32, 0, st>>>(a.x, a.q, a.sc, a.d, a.mn,    \
                                                       a.dm, a.dst, a.N, a.K, a.O,   \
                                                       a.hier, rps);                 \
    break;
    switch (bn) {
      QMM_GEMV(1)
      QMM_GEMV(2)
      QMM_GEMV(4)
      QMM_GEMV(8)
    }
#undef QMM_GEMV
  } else {
    const int mi = a.N <= 16 ? 1 : a.N <= 32 ? 2 : 4;
    const int kps = a.K / splits;
    const dim3 grid(a.O / kCols, (a.N + 16 * mi - 1) / (16 * mi), splits);
#define QMM_MMA(M)                                                                    \
  case M:                                                                             \
    qmm_mma_kernel<M, PACKED, G><<<grid, 128, 0, st>>>(a.x, a.q, a.sc, a.d, a.mn, a.dm, \
                                                       a.dst, a.N, a.K, a.O, a.hier,  \
                                                       kps);                          \
    break;
    switch (mi) {
      QMM_MMA(1)
      QMM_MMA(2)
      QMM_MMA(4)
    }
#undef QMM_MMA
  }
  return cudaGetLastError();
}

}  // namespace

// x [N, K] bf16; q [R, O] (R = K/2 packed, else K) int8; sc [K/g, O] int8
// (hier) or f32; d [K/256, O] f32 (hier); mn like sc or null; dm like d or
// null; part [splits, N, O] f32 scratch (used when splits > 1); out [N, O].
// group is 16 or 32, K a multiple of 256. Rows N <= gemv_max_n (at most 8)
// go to the GEMV, more to the tensor-core GEMM. A split covers R/splits
// plane rows (GEMV) or K/splits of K (GEMM), a multiple of 64. Returns
// cudaGetLastError().
extern "C" int qmm_launch(const void* x, const void* q, const void* sc, const void* d,
                          const void* mn, const void* dm, void* part, void* out, int N,
                          int K, int O, int group, int packed, int hier, int splits,
                          int gemv_max_n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int units = N <= gemv_max_n && packed ? K / 2 : K;
  if (N <= 0 || O % kCols != 0 || K % 256 != 0 || splits <= 0 ||
      units % (splits * 64) != 0 || gemv_max_n < 0 || gemv_max_n > 8) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q), sc,
               static_cast<const float*>(d), mn, static_cast<const float*>(dm),
               static_cast<float*>(splits > 1 ? part : out), N, K, O, hier};
  cudaError_t err;
  if (packed && group == 32) {  // Q4_K
    err = launch_layout<true, 32>(a, splits, gemv_max_n, st);
  } else if (!packed && group == 16) {  // Q6_K
    err = launch_layout<false, 16>(a, splits, gemv_max_n, st);
  } else if (packed && group == 16) {  // Q6_K planes that fit in 4 bits
    err = launch_layout<true, 16>(a, splits, gemv_max_n, st);
  } else if (!packed && group == 32) {
    err = launch_layout<false, 32>(a, splits, gemv_max_n, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const size_t count = (size_t)N * O;
    const int threads = 256;
    split_sum_kernel<<<(unsigned)((count + threads - 1) / threads), threads, 0, st>>>(
        static_cast<const float*>(part), static_cast<float*>(out), count, splits);
    err = cudaGetLastError();
  }
  return (int)err;
}
