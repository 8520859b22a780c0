// Flash attention straight off the paged KV pool (int8 or bf16), for Hopper.
//
// Replaces the TPU Pallas kernel flash_attention_paged of
// llama_cpp_tpu/ops/pallas/flash_attn.py (fold path _fa_kernel_allheads +
// _allheads_update, per-head fallback _fa_kernel).
//
// Function: for batch row b, KV head h and query row r (R = G*T rows, the
// GQA group folded into rows), over the pool rows of pages
// table[b, 0 .. lim) with lim = clip(max_row_pos // page + 1, 1, MP):
//   s   = (q . k) * k_scale * sm_scale   [softcap * tanh(s / softcap)]
//   s   masked to -inf unless pos >= 0 and pos <= row_pos
//         [and pos > row_pos - window]
//   out = sum softmax(s) * v_scale * v over the unmasked columns, with an
//         optional sink logit per row in the softmax denominator only.
// An int8 pool carries f32 row scales; a bf16 pool has none (scale 1).
// Rows with no unmasked column (padding) come out as 0; callers drop them.
//
// What bounds it on an H100: at decode the bytes of the K/V pages (int8:
// about 2 * 128 + 8 bytes per KV row and head, bf16: 2 * 256); the prefill
// ubatch (R = 4 * 512 rows per head) is bounded by FP32 CUDA-core FMAs in
// this first version, which does not use the tensor cores.
//
// Design: one block per (query-row tile, KV head, batch row * KV split).
// 4 warps, each owning RPW query rows (f32 in shared memory). The block walks
// its pages in 64-row tiles: K (row stride padded by one word so a lane per
// column reads without bank conflicts), V, scales and position labels go to
// shared memory; each lane scores two columns, the warp does the
// online-softmax update for its rows, then each lane accumulates 4 of the
// 128 output dims. At decode (few rows, B*Hkv blocks) the KV tiles are split
// across blocks (flash decoding) so more SMs stream the pool; a second kernel
// merges the splits' (max, sum, acc) and adds the sink term.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // KV rows per tile
constexpr int kD = 128;    // head dim (K and V)

__device__ __forceinline__ float4 unpack_i8x4(uint32_t w) {
  return make_float4((float)(int8_t)(w & 0xFF), (float)(int8_t)((w >> 8) & 0xFF),
                     (float)(int8_t)((w >> 16) & 0xFF), (float)(int8_t)(w >> 24));
}

__device__ __forceinline__ float4 unpack_bf16x4(uint32_t w0, uint32_t w1) {
  return make_float4(__uint_as_float(w0 << 16), __uint_as_float(w0 & 0xFFFF0000u),
                     __uint_as_float(w1 << 16), __uint_as_float(w1 & 0xFFFF0000u));
}

// dims 4*i .. 4*i+3 of a K/V row in shared memory (words from `row`)
template <bool BF16>
__device__ __forceinline__ float4 load_dims4(const uint32_t* row, int i) {
  if (BF16) return unpack_bf16x4(row[2 * i], row[2 * i + 1]);
  return unpack_i8x4(row[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int RPW, bool BF16>
__global__ void __launch_bounds__(kThreads)
fa_paged_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                const void* __restrict__ v, const float* __restrict__ ks,
                const float* __restrict__ vs, const int* __restrict__ pos,
                const int* __restrict__ row_pos, const int* __restrict__ table,
                float* __restrict__ part_acc, float* __restrict__ part_m,
                float* __restrict__ part_l, int B, int Hkv, int R, long long S_pool, int MP,
                int page, float sm_scale, int window, float softcap, int splits,
                int tiles_per_split) {
  constexpr int BR = kWarps * RPW;
  constexpr int EB = BF16 ? 2 : 1;  // bytes per K/V element
  constexpr int KW = kD * EB / 4;  // 32-bit words per K/V row
  constexpr int KST = KW + 1;  // padded K row stride in words
  __shared__ __align__(16) float qs[BR][kD];
  __shared__ uint32_t kt[kTile * KST];
  __shared__ uint32_t vt[kTile * KW];
  __shared__ float kss[kTile];
  __shared__ float vss[kTile];
  __shared__ int cps[kTile];
  __shared__ float ps[kWarps][RPW][kTile];
  __shared__ int lim_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;

  for (int i = tid; i < BR * kD; i += kThreads) {
    const int rr = i / kD;
    const int dd = i % kD;
    const int r = r0 + rr;
    qs[rr][dd] = r < R ? __bfloat162float(q[(((size_t)b * Hkv + h) * R + r) * kD + dd]) : 0.f;
  }
  int rp[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = r0 + warp * RPW + rr;
    rp[rr] = r < R ? row_pos[(size_t)b * R + r] : -1;
  }
  if (tid == 0) {
    // causal live-page clamp over this block's rows (flash_attn.py:509-510)
    int rmax = -1;
    bool any = false;
    for (int rr = 0; rr < BR && r0 + rr < R; ++rr) {
      const int p = row_pos[(size_t)b * R + r0 + rr];
      rmax = any ? max(rmax, p) : p;
      any = true;
    }
    const int fl = rmax >= 0 ? rmax / page : -1;  // floor division for rmax < 0
    lim_s = min(max(fl + 1, 1), MP);
  }
  __syncthreads();

  const int tiles_per_page = page / kTile;
  const int n_tiles = lim_s * tiles_per_page;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  float m[RPW], l[RPW], acc[RPW][4];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
    acc[rr][0] = acc[rr][1] = acc[rr][2] = acc[rr][3] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int pg = table[(size_t)b * MP + t / tiles_per_page];
    const long long row0 = (long long)pg * page + (long long)(t % tiles_per_page) * kTile;
    __syncthreads();  // the previous tile's shared data is no longer read
    const uint32_t* kg = reinterpret_cast<const uint32_t*>(
        static_cast<const char*>(k) + ((size_t)h * S_pool + row0) * kD * EB);
    const uint32_t* vg = reinterpret_cast<const uint32_t*>(
        static_cast<const char*>(v) + ((size_t)h * S_pool + row0) * kD * EB);
    for (int i = tid; i < kTile * KW; i += kThreads) {
      kt[(i / KW) * KST + (i % KW)] = __ldg(kg + i);
      vt[i] = __ldg(vg + i);
    }
    for (int i = tid; i < kTile; i += kThreads) {
      kss[i] = BF16 ? 1.f : __ldg(ks + (size_t)h * S_pool + row0 + i);
      vss[i] = BF16 ? 1.f : __ldg(vs + (size_t)h * S_pool + row0 + i);
      cps[i] = __ldg(pos + row0 + i);
    }
    __syncthreads();

    // scores of columns lane and lane + 32 for this warp's rows
    float s[RPW][2];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) s[rr][0] = s[rr][1] = 0.f;
#pragma unroll 4
    for (int w = 0; w < kD / 4; ++w) {
      const float4 k0 = load_dims4<BF16>(kt + lane * KST, w);
      const float4 k1 = load_dims4<BF16>(kt + (lane + 32) * KST, w);
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[warp * RPW + rr][w * 4]);
        s[rr][0] = fmaf(qv.x, k0.x, fmaf(qv.y, k0.y, fmaf(qv.z, k0.z, fmaf(qv.w, k0.w, s[rr][0]))));
        s[rr][1] = fmaf(qv.x, k1.x, fmaf(qv.y, k1.y, fmaf(qv.z, k1.z, fmaf(qv.w, k1.w, s[rr][1]))));
      }
    }
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = lane + cc * 32;
      const float kscale = kss[c];
      const int cp = cps[c];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        float sv = s[rr][cc] * kscale * sm_scale;
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        const bool valid = cp >= 0 && cp <= rp[rr] && (window <= 0 || cp > rp[rr] - window);
        s[rr][cc] = valid ? sv : -INFINITY;
      }
    }
    // online softmax update per row
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(s[rr][0], s[rr][1])));
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[rr] - m_new);
        p0 = expf(s[rr][0] - m_new);
        p1 = expf(s[rr][1] - m_new);
      }
      l[rr] = l[rr] * alpha + warp_sum(p0 + p1);
      m[rr] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rr][e] *= alpha;
      ps[warp][rr][lane] = p0 * vss[lane];
      ps[warp][rr][lane + 32] = p1 * vss[lane + 32];
    }
    __syncwarp();
    // acc[rr][dims 4*lane .. 4*lane+4) += sum_c p[c] * v[c]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float4 vf = load_dims4<BF16>(vt + c * KW, lane);
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float pc = ps[warp][rr][c];
        acc[rr][0] = fmaf(pc, vf.x, acc[rr][0]);
        acc[rr][1] = fmaf(pc, vf.y, acc[rr][1]);
        acc[rr][2] = fmaf(pc, vf.z, acc[rr][2]);
        acc[rr][3] = fmaf(pc, vf.w, acc[rr][3]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = r0 + warp * RPW + rr;
    if (r >= R) continue;
    const size_t idx = (((size_t)split * B + b) * Hkv + h) * R + r;
    if (lane == 0) {
      part_m[idx] = m[rr];
      part_l[idx] = l[rr];
    }
    *reinterpret_cast<float4*>(part_acc + idx * kD + lane * 4) =
        make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
  }
}

// merge the KV splits of each row and add the sink logit; one block per row
__global__ void __launch_bounds__(kD)
fa_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                  const float* __restrict__ part_l, const float* __restrict__ sinks,
                  float* __restrict__ out, int Hkv, int R, size_t n_rows, int splits) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const int r = (int)(row % R);
  const int h = (int)((row / R) % Hkv);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_m[s * n_rows + row]);
  const float sink = sinks != nullptr ? sinks[(size_t)h * R + r] : -INFINITY;
  mx = fmaxf(mx, sink);
  float res = 0.f;
  if (mx != -INFINITY) {
    float lsum = sink != -INFINITY ? expf(sink - mx) : 0.f;
    float a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(part_m[s * n_rows + row] - mx);
      lsum += part_l[s * n_rows + row] * w;
      a += part_acc[(s * n_rows + row) * kD + d] * w;
    }
    res = lsum > 0.f ? a / lsum : 0.f;
  }
  out[row * kD + d] = res;
}

}  // namespace

// q [B, Hkv, R, 128] bf16; k, v [Hkv, S_pool, 128] int8 with ks, vs
// [Hkv, S_pool] f32 row scales, or bf16 with ks = vs = null; pos [S_pool]
// int32; row_pos [B, R] int32; table [B, MP] int32; sinks [Hkv, R] f32 or
// null; part_acc [splits, B, Hkv, R, 128], part_m/part_l [splits, B, Hkv, R]
// f32 scratch; out [B, Hkv, R, 128] f32. rows_per_warp is 1 or 4; page a
// multiple of 64. Returns cudaGetLastError().
extern "C" int fa_paged_launch(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* pos, const void* row_pos,
                               const void* table, const void* sinks, void* part_acc,
                               void* part_m, void* part_l, void* out, int B, int Hkv, int R,
                               long long S_pool, int MP, int page, float sm_scale, int window,
                               float softcap, int rows_per_warp, int splits, int bf16_kv,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (page % kTile != 0 || splits <= 0 || B <= 0 || R <= 0 || Hkv <= 0 ||
      (bf16_kv == 0) != (ks != nullptr && vs != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_per_split = (MP * (page / kTile) + splits - 1) / splits;
  const int br = kWarps * rows_per_warp;
  const dim3 grid((R + br - 1) / br, Hkv, B * splits);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* vsf = static_cast<const float*>(vs);
  const auto* posi = static_cast<const int*>(pos);
  const auto* rpi = static_cast<const int*>(row_pos);
  const auto* tbl = static_cast<const int*>(table);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
#define FA_PAGED(RPW, BF)                                                                 \
  fa_paged_kernel<RPW, BF><<<grid, kThreads, 0, st>>>(qb, k, v, ksf, vsf, posi, rpi, tbl, pa, \
                                                      pm, pl, B, Hkv, R, S_pool, MP, page,  \
                                                      sm_scale, window, softcap, splits,    \
                                                      tiles_per_split)
  if (rows_per_warp == 1) {
    if (bf16_kv) FA_PAGED(1, true); else FA_PAGED(1, false);
  } else if (rows_per_warp == 4) {
    if (bf16_kv) FA_PAGED(4, true); else FA_PAGED(4, false);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef FA_PAGED
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n_rows = (size_t)B * Hkv * R;
  fa_combine_kernel<<<(unsigned)n_rows, kD, 0, st>>>(pa, pm, pl, static_cast<const float*>(sinks),
                                                      static_cast<float*>(out), Hkv, R, n_rows,
                                                      splits);
  return (int)cudaGetLastError();
}
