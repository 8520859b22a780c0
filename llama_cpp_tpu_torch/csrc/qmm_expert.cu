// Indexed-expert fused dequantize + GEMV over stacked int8 weight planes, for
// Hopper: row r of the output is x[r] . W[ids[r]].
//
// Replaces the TPU Pallas kernel qmm_planes_expert of
// llama_cpp_tpu/ops/pallas/qmm.py (_qmm_id_kernel, _qmm_id_min_kernel), the
// MoE decode product (GGML_OP_MUL_MAT_ID analog) that streams only the
// selected experts' planes.
//
// Function: y[R, O] (f32), y[r] = x[r] (bf16) . W[e], e = ids[r], where
//   W[e][k, o] = q[e, k, o] * scales[e, k/g, o] + mins[e, k/g, o]   (mins or 0)
// over int8 planes q [E, K, O] with flat f32 scales (and mins) [E, K/g, O],
// g = 16 or 32. The TPU kernel rounds q * scale to bf16 before its dot and
// adds the affine term (group sums of x) . mins in f32; this kernel keeps
// q * scale in f32 (scale applied once per group to the group's sum of
// q * x), so it differs from the plain version (ops/kernels/qmm_expert.py)
// by that one bf16 rounding of W.
//
// What bounds it on an H100: bytes. A Mixtral-8x7B decode step at B=1 reads
// two experts of 58.7 M int8 weights (+ f32 scales, 1/4 or 1/8 of that) per
// matrix for 2 rows of activations; there is nothing to reuse but the rows
// that picked the same expert.
//
// Design: the int8-plane GEMV of qmm.cu with the expert picked inside the
// kernel. Grid (O / 128, R, K splits), one warp per block, each thread owns 4
// adjacent output columns (one 32-bit load per plane row, a warp reads 128
// contiguous bytes). Block (., r, .) reads ids itself: the rows with the same
// expert as r are numbered in row order, and only a row whose number is a
// multiple of 4 leads a block, which computes up to 4 such rows from one pass
// over the expert's planes (with the loop body built for 1, 2 or 4 rows, so
// a lone row pays for no other); the others exit at once. So each group of
// 4 rows that share an expert reads that expert's planes once, with no
// sort, no host round trip and a fixed summation order. The expert's plane
// offset is 64-bit (E * K * O passes 2^31 for 128-expert models). K is split
// across blockIdx.z; a second kernel adds the partial sums in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;  // output columns per block
constexpr int kChunk = 64;  // plane rows of x staged per step
constexpr int kMaxRows = 4;  // rows of one expert that one block computes

// 4 int8 -> 4 exact floats: bytes + 128 into the mantissa of 2^23
__device__ __forceinline__ void i8x4_to_float4(uint32_t w, float f[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    f[c] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + c)) - 8388736.f;
  }
}

// one pass over expert e's planes for the BN rows in `rows` (n_rows <= BN of
// them are real, the rest stage zeros)
template <int BN, int G>
__device__ __forceinline__ void expert_rows(const __nv_bfloat16* __restrict__ x,
                                            const int8_t* __restrict__ qe,
                                            const float* __restrict__ sce,
                                            const float* __restrict__ mne,
                                            float* __restrict__ dst, const int* rows,
                                            int n_rows, int K, int O, int k_begin, int k_end,
                                            float (*xs)[kMaxRows], float (*xsum)[kMaxRows]) {
  constexpr int NG = kChunk / G;  // scale groups per chunk
  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * kCols + tid * 4;
  float acc[BN][4];
#pragma unroll
  for (int n = 0; n < BN; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  }

  for (int kc = k_begin; kc < k_end; kc += kChunk) {
    __syncthreads();
    // stage x[rows, kc .. kc+64); consecutive threads read consecutive k
    for (int i = tid; i < BN * kChunk; i += 32) {
      const int kk = i % kChunk;
      const int n = i / kChunk;
      float v = 0.f;
      if (n < n_rows) v = __bfloat162float(x[(size_t)rows[n] * K + kc + kk]);
      xs[kk][n] = v;
    }
    __syncthreads();
    for (int i = tid; i < NG * BN; i += 32) {
      const int n = i % BN;
      const int gi = i / BN;
      float s = 0.f;
      for (int j = 0; j < G; ++j) s += xs[gi * G + j][n];
      xsum[gi][n] = s;
    }
    __syncthreads();

#pragma unroll 1
    for (int gi = 0; gi < NG; ++gi) {
      const int k0 = kc + gi * G;
      float gs[BN][4];
#pragma unroll
      for (int n = 0; n < BN; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) gs[n][c] = 0.f;
      }
#pragma unroll 8
      for (int j = 0; j < G; ++j) {
        const uint32_t wb =
            __ldg(reinterpret_cast<const uint32_t*>(qe + (size_t)(k0 + j) * O + o0));
        float qf[4];
        i8x4_to_float4(wb, qf);
#pragma unroll
        for (int n = 0; n < BN; ++n) {
          const float xv = xs[gi * G + j][n];
#pragma unroll
          for (int c = 0; c < 4; ++c) gs[n][c] = fmaf(qf[c], xv, gs[n][c]);
        }
      }
      const size_t gidx = (size_t)(k0 / G) * O + o0;
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(sce + gidx));
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
      float m[4] = {0.f, 0.f, 0.f, 0.f};
      if (mne != nullptr) {
        const float4 m4 = __ldg(reinterpret_cast<const float4*>(mne + gidx));
        m[0] = m4.x; m[1] = m4.y; m[2] = m4.z; m[3] = m4.w;
      }
#pragma unroll
      for (int n = 0; n < BN; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[n][c] = fmaf(s[c], gs[n][c], fmaf(m[c], xsum[gi][n], acc[n][c]));
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < BN; ++n) {
    if (n < n_rows) {
      *reinterpret_cast<float4*>(dst + (size_t)rows[n] * O + o0) =
          make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(32)
qmm_expert_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ ids,
                  const int8_t* __restrict__ q, const float* __restrict__ sc,
                  const float* __restrict__ mn, float* __restrict__ out, int R, int E, int K,
                  int O, int rows_per_split) {
  __shared__ __align__(16) float xs[kChunk][kMaxRows];
  __shared__ float xsum[kChunk / G][kMaxRows];
  __shared__ int rows_s[kMaxRows];
  __shared__ int n_rows_s;

  const int r_lead = blockIdx.y;
  const int e = min(max(ids[r_lead], 0), E - 1);  // clamped: never read outside the stack
  if (threadIdx.x == 0) {
    int rank = 0;
    for (int r = 0; r < r_lead; ++r) rank += min(max(ids[r], 0), E - 1) == e;
    int n = 0;
    if (rank % kMaxRows == 0) {
      for (int r = r_lead; r < R && n < kMaxRows; ++r) {
        if (min(max(ids[r], 0), E - 1) == e) rows_s[n++] = r;
      }
    }
    n_rows_s = n;
  }
  __syncthreads();
  const int n_rows = n_rows_s;
  if (n_rows == 0) return;  // another block computes this row

  const int k_begin = blockIdx.z * rows_per_split;
  const int k_end = k_begin + rows_per_split;
  const int8_t* qe = q + (size_t)e * K * O;
  const float* sce = sc + (size_t)e * (K / G) * O;
  const float* mne = mn != nullptr ? mn + (size_t)e * (K / G) * O : nullptr;
  float* dst = out + (size_t)blockIdx.z * R * O;
  if (n_rows == 1) {
    expert_rows<1, G>(x, qe, sce, mne, dst, rows_s, 1, K, O, k_begin, k_end, xs, xsum);
  } else if (n_rows == 2) {
    expert_rows<2, G>(x, qe, sce, mne, dst, rows_s, 2, K, O, k_begin, k_end, xs, xsum);
  } else {
    expert_rows<kMaxRows, G>(x, qe, sce, mne, dst, rows_s, n_rows, K, O, k_begin, k_end, xs,
                             xsum);
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

template <int G>
cudaError_t launch_group(const __nv_bfloat16* x, const int* ids, const int8_t* q,
                         const float* sc, const float* mn, float* dst, int R, int E, int K,
                         int O, int splits, cudaStream_t st) {
  const dim3 grid(O / kCols, R, splits);
  qmm_expert_kernel<G><<<grid, 32, 0, st>>>(x, ids, q, sc, mn, dst, R, E, K, O, K / splits);
  return cudaGetLastError();
}

}  // namespace

// x [R, K] bf16; ids [R] int32 (clamped to [0, E)); q [E, K, O] int8; sc
// [E, K/group, O] f32; mn like sc or null; part [splits, R, O] f32 scratch
// (used when splits > 1); out [R, O] f32. group is 16 or 32, K a multiple of
// 256 and of 64 * splits, O of 128, R at most 65535. Returns
// cudaGetLastError().
extern "C" int qmm_expert_launch(const void* x, const void* ids, const void* q, const void* sc,
                                 const void* mn, void* part, void* out, int R, int E, int K,
                                 int O, int group, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || R > 65535 || E <= 0 || O % kCols != 0 || K % 256 != 0 || splits <= 0 ||
      K % (splits * kChunk) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* idp = static_cast<const int*>(ids);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* scp = static_cast<const float*>(sc);
  const auto* mnp = static_cast<const float*>(mn);
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  cudaError_t err;
  if (group == 16) {
    err = launch_group<16>(xb, idp, qp, scp, mnp, dst, R, E, K, O, splits, st);
  } else if (group == 32) {
    err = launch_group<32>(xb, idp, qp, scp, mnp, dst, R, E, K, O, splits, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const size_t count = (size_t)R * O;
    const int threads = 256;
    split_sum_kernel<<<(unsigned)((count + threads - 1) / threads), threads, 0, st>>>(
        static_cast<const float*>(part), static_cast<float*>(out), count, splits);
    err = cudaGetLastError();
  }
  return (int)err;
}
