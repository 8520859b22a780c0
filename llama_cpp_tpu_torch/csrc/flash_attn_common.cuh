// Online-softmax attention over an int8 or bf16 KV memory, for Hopper: the
// device code shared by the paged-pool kernel (flash_attn_paged.cu) and the
// slot-table kernel (flash_attn.cu). The two differ only in where a KV tile
// lives and in how many tiles a block of query rows may see.
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
// Design: one block per (query-row tile, KV head, batch row * KV split).
// 4 warps, each owning RPW query rows (f32 in shared memory). The block walks
// its live tiles of 64 KV rows: K (row stride padded by one word so a lane
// per column reads without bank conflicts), V, scales and position labels go
// to shared memory; each lane scores two columns, the warp does the
// online-softmax update for its rows, then each lane accumulates D / 32
// output dims, at least 4 (with heads under 128 the warp's lanes form 128 / D
// groups that take alternate columns and add their sums at the end). Shared
// memory is dynamic: heads of 256 need up to 85 KB. The live tiles are split
// evenly across `splits` blocks (flash decoding), so at decode, where there
// are only B * Hkv (row tile, head) pairs, more SMs stream the memory; a
// second kernel merges the splits' (max, sum, acc) and adds the sink term.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // KV rows per tile

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

// Where the memory lives. PAGED: k, v [Hkv, S, D] and ks, vs [Hkv, S] over
// the pool's S rows, pos [S], index = page table [B, MP]; the live limit is
// clip(max_row_pos // page + 1, 1, MP) pages. Slot table: k, v
// [n_seqs, Hkv, S, D], ks, vs [n_seqs, Hkv, S], pos [n_seqs, S], index =
// seq_idx [B] (the kernel addresses the sequence itself, nothing is
// gathered); the live limit is clip(max_row_pos // 64 + 1, 1, S / 64) tiles,
// or every tile when `ring` (wrapped slots: slot order is not position
// order).
struct Layout {
  long long S;  // pool rows, or slots per sequence
  int MP;       // paged: pages per sequence
  int page;     // paged: rows per page
  int n_seqs;   // slot table: sequences in the cache
  int ring;     // slot table: visit every tile
};

// Shared memory of one block, in bytes from the start of the dynamic
// allocation; every region starts on 16 bytes (q rows are read as float4).
template <int D, int RPW, bool BF16>
struct Smem {
  static constexpr int BR = kWarps * RPW;
  static constexpr int KW = D * (BF16 ? 2 : 1) / 4;  // 32-bit words per K/V row
  static constexpr int KST = KW + 1;                  // padded K row stride in words
  static constexpr int qs = 0;                        // float [BR][D]
  static constexpr int kt = qs + BR * D * 4;          // uint32 [kTile][KST]
  static constexpr int vt = kt + kTile * KST * 4;     // uint32 [kTile][KW]
  static constexpr int kss = vt + kTile * KW * 4;     // float [kTile]
  static constexpr int vss = kss + kTile * 4;         // float [kTile]
  static constexpr int cps = vss + kTile * 4;         // int [kTile]
  static constexpr int ps = cps + kTile * 4;          // float [kWarps][RPW][kTile]
  static constexpr int bytes = ps + kWarps * RPW * kTile * 4;
};

template <int D, int RPW, bool BF16, bool PAGED>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
          const void* __restrict__ v, const float* __restrict__ ks,
          const float* __restrict__ vs, const int* __restrict__ pos,
          const int* __restrict__ row_pos, const int* __restrict__ index,
          float* __restrict__ part_acc, float* __restrict__ part_m,
          float* __restrict__ part_l, int B, int Hkv, int R, Layout lay, float sm_scale,
          int window, float softcap, int splits) {
  using L = Smem<D, RPW, BF16>;
  constexpr int BR = L::BR;
  constexpr int EB = BF16 ? 2 : 1;  // bytes per K/V element
  constexpr int KW = L::KW;
  constexpr int KST = L::KST;
  // P.V: a warp's lanes form HALVES groups that take alternate KV columns;
  // a lane adds up NV float4s of output dims (dims 4 * (dl + LPH * j))
  constexpr int HALVES = D >= 128 ? 1 : 128 / D;
  constexpr int LPH = 32 / HALVES;
  constexpr int NV = D > 128 ? D / 128 : 1;
  static_assert(D % 32 == 0 && D <= 256 && LPH * NV * 4 == D, "head dim 32, 64, 128 or 256");
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::qs);
  uint32_t* kt = reinterpret_cast<uint32_t*>(smem + L::kt);
  uint32_t* vt = reinterpret_cast<uint32_t*>(smem + L::vt);
  float* kss = reinterpret_cast<float*>(smem + L::kss);
  float* vss = reinterpret_cast<float*>(smem + L::vss);
  int* cps = reinterpret_cast<int*>(smem + L::cps);
  float* ps = reinterpret_cast<float*>(smem + L::ps);
  __shared__ int n_tiles_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;

  for (int i = tid; i < BR * D; i += kThreads) {
    const int rr = i / D;
    const int dd = i % D;
    const int r = r0 + rr;
    qs[rr * D + dd] = r < R ? __bfloat162float(q[(((size_t)b * Hkv + h) * R + r) * D + dd]) : 0.f;
  }
  int rp[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = r0 + warp * RPW + rr;
    rp[rr] = r < R ? row_pos[(size_t)b * R + r] : -1;
  }
  if (tid == 0) {
    // causal live-tile clamp over this block's rows
    int rmax = -1;
    bool any = false;
    for (int rr = 0; rr < BR && r0 + rr < R; ++rr) {
      const int p = row_pos[(size_t)b * R + r0 + rr];
      rmax = any ? max(rmax, p) : p;
      any = true;
    }
    if (PAGED) {
      const int fl = rmax >= 0 ? rmax / lay.page : -1;  // floor division for rmax < 0
      n_tiles_s = min(max(fl + 1, 1), lay.MP) * (lay.page / kTile);
    } else {
      const int all = (int)(lay.S / kTile);
      const int fl = rmax >= 0 ? rmax / kTile : -1;
      n_tiles_s = lay.ring ? all : min(max(fl + 1, 1), all);
    }
  }
  __syncthreads();

  const int n_tiles = n_tiles_s;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int tiles_per_page = PAGED ? lay.page / kTile : 1;
  const long long seq = PAGED ? 0 : min(max(index[b], 0), lay.n_seqs - 1);

  float m[RPW], l[RPW], acc[RPW][NV][4];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      acc[rr][j][0] = acc[rr][j][1] = acc[rr][j][2] = acc[rr][j][3] = 0.f;
    }
  }
  const int sub = lane / LPH;  // which columns of a tile this lane adds up
  const int dl = lane % LPH;   // its output dims are 4 * (dl + LPH * j) .. + 3

  for (int t = t_begin; t < t_end; ++t) {
    long long kv_row, pos_row;  // first row of the tile in k/v/scales, in pos
    if (PAGED) {
      const int pg = index[(size_t)b * lay.MP + t / tiles_per_page];
      pos_row = (long long)pg * lay.page + (long long)(t % tiles_per_page) * kTile;
      kv_row = (long long)h * lay.S + pos_row;
    } else {
      pos_row = seq * lay.S + (long long)t * kTile;
      kv_row = (seq * Hkv + h) * lay.S + (long long)t * kTile;
    }
    __syncthreads();  // the previous tile's shared data is no longer read
    const uint32_t* kg = reinterpret_cast<const uint32_t*>(
        static_cast<const char*>(k) + (size_t)kv_row * D * EB);
    const uint32_t* vg = reinterpret_cast<const uint32_t*>(
        static_cast<const char*>(v) + (size_t)kv_row * D * EB);
    for (int i = tid; i < kTile * KW; i += kThreads) {
      kt[(i / KW) * KST + (i % KW)] = __ldg(kg + i);
      vt[i] = __ldg(vg + i);
    }
    for (int i = tid; i < kTile; i += kThreads) {
      kss[i] = BF16 ? 1.f : __ldg(ks + kv_row + i);
      vss[i] = BF16 ? 1.f : __ldg(vs + kv_row + i);
      cps[i] = __ldg(pos + pos_row + i);
    }
    __syncthreads();

    // scores of columns lane and lane + 32 for this warp's rows
    float s[RPW][2];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) s[rr][0] = s[rr][1] = 0.f;
#pragma unroll 4
    for (int w = 0; w < D / 4; ++w) {
      const float4 k0 = load_dims4<BF16>(kt + lane * KST, w);
      const float4 k1 = load_dims4<BF16>(kt + (lane + 32) * KST, w);
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[(warp * RPW + rr) * D + w * 4]);
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
    float* pw = ps + warp * RPW * kTile;
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
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rr][j][e] *= alpha;
      }
      pw[rr * kTile + lane] = p0 * vss[lane];
      pw[rr * kTile + lane + 32] = p1 * vss[lane + 32];
    }
    __syncwarp();
    // acc[rr][j] += sum over this lane's columns of p[c] * v[c, its dims]
#pragma unroll 4
    for (int c = sub; c < kTile; c += HALVES) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float4 vf = load_dims4<BF16>(vt + c * KW, dl + LPH * j);
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
          const float pc = pw[rr * kTile + c];
          acc[rr][j][0] = fmaf(pc, vf.x, acc[rr][j][0]);
          acc[rr][j][1] = fmaf(pc, vf.y, acc[rr][j][1]);
          acc[rr][j][2] = fmaf(pc, vf.z, acc[rr][j][2]);
          acc[rr][j][3] = fmaf(pc, vf.w, acc[rr][j][3]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    // add up the column groups' sums (lanes dl, dl + LPH, ...)
#pragma unroll
    for (int o = 16; o >= LPH; o >>= 1) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rr][j][e] += __shfl_xor_sync(0xffffffffu, acc[rr][j][e], o);
      }
    }
    const int r = r0 + warp * RPW + rr;
    if (r >= R) continue;
    const size_t idx = (((size_t)split * B + b) * Hkv + h) * R + r;
    if (lane == 0) {
      part_m[idx] = m[rr];
      part_l[idx] = l[rr];
    }
    if (sub == 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        *reinterpret_cast<float4*>(part_acc + idx * D + (dl + LPH * j) * 4) =
            make_float4(acc[rr][j][0], acc[rr][j][1], acc[rr][j][2], acc[rr][j][3]);
      }
    }
  }
}

// merge the KV splits of each row and add the sink logit; one block per row,
// one thread per output dim
static __global__ void fa_combine_kernel(const float* __restrict__ part_acc,
                                  const float* __restrict__ part_m,
                                  const float* __restrict__ part_l,
                                  const float* __restrict__ sinks, float* __restrict__ out,
                                  int Hkv, int R, size_t n_rows, int splits) {
  const size_t row = blockIdx.x;
  const int D = blockDim.x;
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
      a += part_acc[(s * n_rows + row) * D + d] * w;
    }
    res = lsum > 0.f ? a / lsum : 0.f;
  }
  out[row * D + d] = res;
}

struct Args {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pos;
  const int* row_pos;
  const int* index;
  float* part_acc;
  float* part_m;
  float* part_l;
  int B, Hkv, R;
  Layout lay;
  float sm_scale;
  int window;
  float softcap;
  int splits;
};

// one instantiation; above 48 KB of shared memory (heads of 256) the kernel
// is first allowed that much dynamic shared memory
template <int D, int RPW, bool BF16, bool PAGED>
cudaError_t run(dim3 grid, cudaStream_t st, const Args& a) {
  constexpr int bytes = Smem<D, RPW, BF16>::bytes;
  auto* kern = fa_kernel<D, RPW, BF16, PAGED>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, bytes, st>>>(a.q, a.k, a.v, a.ks, a.vs, a.pos, a.row_pos, a.index,
                                      a.part_acc, a.part_m, a.part_l, a.B, a.Hkv, a.R, a.lay,
                                      a.sm_scale, a.window, a.softcap, a.splits);
  return cudaGetLastError();
}

template <int D, bool PAGED>
cudaError_t run_d(dim3 grid, cudaStream_t st, const Args& a, int rows_per_warp, int bf16_kv) {
  if (rows_per_warp == 1) {
    return bf16_kv ? run<D, 1, true, PAGED>(grid, st, a) : run<D, 1, false, PAGED>(grid, st, a);
  }
  return bf16_kv ? run<D, 4, true, PAGED>(grid, st, a) : run<D, 4, false, PAGED>(grid, st, a);
}

// Launch the attention kernel for head dim 32, 64, 128 or 256, 1 or 4 rows
// per warp, an int8 or bf16 memory, then the merge. part_acc [splits, B,
// Hkv, R, D], part_m/part_l [splits, B, Hkv, R] f32 scratch; out [B, Hkv,
// R, D] f32. Returns cudaGetLastError().
template <bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, const void* row_pos, const void* index, const void* sinks,
           void* part_acc, void* part_m, void* part_l, void* out, int B, int Hkv, int R,
           Layout lay, int D, float sm_scale, int window, float softcap, int rows_per_warp,
           int splits, int bf16_kv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits <= 0 || B <= 0 || R <= 0 || Hkv <= 0 || lay.S % kTile != 0 ||
      (bf16_kv == 0) != (ks != nullptr && vs != nullptr) ||
      (rows_per_warp != 1 && rows_per_warp != 4) ||
      (D != 32 && D != 64 && D != 128 && D != 256)) {
    return (int)cudaErrorInvalidValue;
  }
  const int br = kWarps * rows_per_warp;
  const dim3 grid((R + br - 1) / br, Hkv, B * splits);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  const Args a{static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const int*>(pos),
               static_cast<const int*>(row_pos), static_cast<const int*>(index), pa, pm, pl,
               B, Hkv, R, lay, sm_scale, window, softcap, splits};
  cudaError_t err;
  switch (D) {
    case 32: err = run_d<32, PAGED>(grid, st, a, rows_per_warp, bf16_kv); break;
    case 64: err = run_d<64, PAGED>(grid, st, a, rows_per_warp, bf16_kv); break;
    case 128: err = run_d<128, PAGED>(grid, st, a, rows_per_warp, bf16_kv); break;
    default: err = run_d<256, PAGED>(grid, st, a, rows_per_warp, bf16_kv); break;
  }
  if (err != cudaSuccess) return (int)err;
  const size_t n_rows = (size_t)B * Hkv * R;
  fa_combine_kernel<<<(unsigned)n_rows, D, 0, st>>>(pa, pm, pl, static_cast<const float*>(sinks),
                                                    static_cast<float*>(out), Hkv, R, n_rows,
                                                    splits);
  return (int)cudaGetLastError();
}

}  // namespace fa
