// Multi-head Latent Attention over an int8 or bf16 KV memory, for Hopper:
// the instantiation of the two attention kernels (the paged pool,
// flash_attn_paged.cu, and the slot table, flash_attn.cu) at unequal K/V
// head dims with one KV head, as an absorbed MLA cache holds it: K rows of
// [c_kv | pad | k_pe] and V rows of c_kv, at (Dk, Dv) = (576 | 640, 512)
// (DeepSeek-V2/V3, PLM) or (384, 256) (MiniCPM3: kv_lora_rank 256, 32 rope
// dims, padded to 384). The function is flash_attn_common.cuh's without window, softcap
// or sinks (MLA uses none; the launch refuses them): s = (q . k) * k_scale *
// sm_scale, causal mask from positions, softmax(s) * v_scale * v, rows with
// nothing visible 0. Its arithmetic is the same too: bf16 q times k (int8
// values exact in bf16) into f32, an online softmax in f32 in the log2
// domain, p * v_scale rounded to bf16 times v into f32.
//
// Why a kernel of its own: at these dims the equal-dim kernels' tiles do not
// fit. A 64-row wgmma Q tile at Dk = 640 is 80 KB in bf16, a 64-row K tile
// 80 KB, a V tile 64 KB, and O at 64 rows x 512 f32 is 128 KB of registers
// a block. The design, chosen for a first kernel that is right:
//  * KV sub-tiles of 16 rows (K 20 KB and V 16 KB in bf16) in a ring of 3
//    cp.async stages (int8: raw stages turned into one bf16 tile in shared
//    memory); the Q tile stays in shared memory for the whole walk.
//  * Warp w owns 16 query rows (rows 16 (w % NW)) and half of Dv (columns
//    Dv / 2 (w / NW)): Dv / 4 f32 accumulators a thread (128 at Dv = 512).
//    The two warps of a row group both compute S = Q K^T over the whole Dk
//    from the shared Q and K
//    (S is recomputed, 1.56x the tensor-core work at Dk = 640, rather than
//    shared through shared memory with a barrier per sub-tile), so each
//    holds its rows' softmax state itself. mma.sync m16n8k16: S as two n8
//    tiles, P in the registers of S's accumulators as P V's A fragment, V
//    read by ldmatrix.trans.
//  * One block holds NW row groups (NW = 4: 64 rows, 256 threads, the
//    prefill route; NW = 1: 16 rows, 64 threads, the decode route at up to
//    16 rows, e.g. DeepSeek-V2-Lite's 16 heads at one token). All rows of a
//    KV head's block read each K/V sub-tile once. The decode route splits
//    the live tiles over blocks (flash decoding) and the last block of each
//    row tile merges the splits in order (an atomic counter it resets), in
//    one launch; the prefill route runs one split and walks the last row
//    tiles first.
// What bounds it on an H100: at decode the live K/V bytes (bf16: (Dk + Dv)
// * 2 bytes a KV row; int8: Dk + Dv + 8); at a prefill ubatch the
// tensor-core operations (2 (Dk + Dv) a visible query-key pair), which
// mma.sync with the recomputed S does not reach. Rows past R (MiniCPM3's 40
// heads at one token fill 40 of a 64-row block) are read as zeros and never
// written.

#pragma once

#include "flash_attn_common.cuh"

namespace fa {

constexpr int kMlaKv = 16;  // KV rows a sub-tile (one k16 step of P V)

// Shared memory of an MLA block (16-byte aligned offsets): the Q tile [16 NW
// rows][Dk + 8] bf16 (rows padded by 16 bytes: ldmatrix without bank
// conflicts), a ring of NS stages and, over int8, the bf16 tile the warps
// read. A bf16 tile: K [16][Dk + 8], V [16][Dv + 8], then 16 k scales, 16
// v scales and 16 positions. A raw int8 stage: K [16][Dk], V [16][Dv]
// contiguous, then the same three rows. After the walk the Q tile holds the
// last block's merge: the splits' weights [kMaxSplits][rows], M and L.
template <int DK, int DV, int NW, bool BF16>
struct MlaSmem {
  static constexpr int QS = DK + 8;
  static constexpr int VS = DV + 8;
  static constexpr int kRows = 16 * NW;
  static constexpr int kThreads = 64 * NW;
  static constexpr int NS = 3;
  static constexpr int st_k = 0;
  static constexpr int st_v = kMlaKv * QS * 2;
  static constexpr int st_side = st_v + kMlaKv * VS * 2;
  static constexpr int kTileB = st_side + 3 * kMlaKv * 4;
  static constexpr int rw_v = kMlaKv * DK;
  static constexpr int rw_side = rw_v + kMlaKv * DV;
  static constexpr int kRawB = rw_side + 3 * kMlaKv * 4;
  static constexpr int kStage = BF16 ? kTileB : kRawB;
  static constexpr int q = 0;
  static constexpr int ring = kRows * QS * 2;
  static constexpr int conv = ring + NS * kStage;
  static constexpr int bytes = conv + (BF16 ? 0 : kTileB);
  static constexpr int mg_w = 0;
  static constexpr int mg_m = mg_w + kMaxSplits * kRows * 4;
  static constexpr int mg_l = mg_m + kRows * 4;
  static_assert(mg_l + kRows * 4 <= ring, "the merge fits the Q tile");
  static_assert(QS * 2 % 16 == 0 && VS * 2 % 16 == 0 && kStage % 16 == 0, "16-byte rows");
};

template <int DK, int DV, int NW, bool BF16, bool PAGED>
__global__ void __launch_bounds__(MlaSmem<DK, DV, NW, BF16>::kThreads, 1)
fa_mla(const __grid_constant__ Params p) {
  using L = MlaSmem<DK, DV, NW, BF16>;
  constexpr int kMlaDv = DV;        // V head dim (the latent c_kv)
  constexpr int kMlaHalf = DV / 2;  // V columns a warp owns
  constexpr int QS = L::QS;
  constexpr int VS = L::VS;
  constexpr int NS = L::NS;
  constexpr int NT = L::kThreads;
  constexpr int KS = DK / 16;             // k16 steps of Q K^T
  constexpr int NO = kMlaHalf / 8;        // 8-column output tiles a warp
  constexpr int SUB = kTile / kMlaKv;     // sub-tiles a 64-row tile
  constexpr int EB = BF16 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[NT / 32];
  __shared__ int last_block;
  __shared__ int pages[kTableSmem];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = warp % NW;  // query rows 16 rw .. 16 rw + 15 of the block
  const int dh = warp / NW;  // V columns Dv/2 dh .. Dv/2 (dh + 1) - 1
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int n_rt = gridDim.y;
  const int rt = n_rt - 1 - (int)blockIdx.y;  // the last row tiles first
  const size_t bh = blockIdx.z;               // b * Hkv + h
  const int b = (int)(bh / p.Hkv);
  const int h = (int)(bh % p.Hkv);
  const int R = p.R;
  const int r0 = rt * L::kRows;
  const int nr = min(L::kRows, R - r0);

  // the Q tile (rows past R as zeros), the page table row, the rows' largest
  // position
  const __nv_bfloat16* qg = p.q + (bh * R + r0) * DK;
  for (int i = tid; i < L::kRows * (DK / 8); i += NT) {
    const int rr = i / (DK / 8);
    const int c = i % (DK / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (rr < nr) v = *reinterpret_cast<const uint4*>(qg + (size_t)rr * DK + c * 8);
    *reinterpret_cast<uint4*>(smem + L::q + rr * QS * 2 + c * 16) = v;
  }
  if (PAGED) {
    for (int i = tid; i < min(p.lay.MP, kTableSmem); i += NT) {
      pages[i] = p.index[(size_t)b * p.lay.MP + i];
    }
  }
  {
    int rm = INT_MIN;
    if (tid < nr) rm = p.row_pos[(size_t)b * R + r0 + tid];
    rm = warp_max_int(rm);
    if (lane == 0) red[warp] = rm;
  }
  const long long seq = PAGED ? 0 : min(max(p.index[b], 0), p.lay.n_seqs - 1);
  __syncthreads();
  int rmax = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) rmax = max(rmax, red[w]);
  const int n_tiles = live_tiles<PAGED>(p.lay, rmax);
  const int tps = (n_tiles + splits - 1) / splits;
  const int t_begin = split * tps;
  const int n_sub = max(min(t_begin + tps, n_tiles) - t_begin, 0) * SUB;

  // sub-tile j of this split -> ring stage `stage`
  auto issue = [&](int j, int stage) {
    long long kv_row, pos_row;
    if (PAGED) {
      page_rows(p, pages, b, h, t_begin + j / SUB, kv_row, pos_row);
    } else {
      slot_rows(p, h, seq, t_begin + j / SUB, kv_row, pos_row);
    }
    kv_row += (j % SUB) * kMlaKv;
    pos_row += (j % SUB) * kMlaKv;
    unsigned char* st = smem + L::ring + stage * L::kStage;
    const char* kg = static_cast<const char*>(p.k) + (size_t)kv_row * DK * EB;
    const char* vg = static_cast<const char*>(p.v) + (size_t)kv_row * kMlaDv * EB;
    constexpr int KC = DK * EB / 16;      // 16-byte chunks a K row
    constexpr int VC = kMlaDv * EB / 16;  // and a V row
    for (int i = tid; i < kMlaKv * (KC + VC); i += NT) {
      const bool isv = i >= kMlaKv * KC;
      const int ii = isv ? i - kMlaKv * KC : i;
      int so;
      if (BF16) {
        so = isv ? L::st_v + (ii / VC) * VS * 2 + (ii % VC) * 16
                 : L::st_k + (ii / KC) * QS * 2 + (ii % KC) * 16;
      } else {
        so = (isv ? L::rw_v : 0) + ii * 16;
      }
      cp_async16(smem_u32(st + so), (isv ? vg : kg) + (size_t)ii * 16);
    }
    const int side = BF16 ? L::st_side : L::rw_side;
    if (tid < 4) {
      cp_async16(smem_u32(st + side + 128 + tid * 16), p.pos + pos_row + tid * 4);
    } else if (!BF16 && tid < 8) {
      cp_async16(smem_u32(st + side + (tid - 4) * 16), p.ks + kv_row + (tid - 4) * 4);
    } else if (!BF16 && tid < 12) {
      cp_async16(smem_u32(st + side + 64 + (tid - 8) * 16), p.vs + kv_row + (tid - 8) * 4);
    }
  };
  // an int8 stage -> the bf16 tile (exact), with its scales and positions
  auto convert = [&](const unsigned char* st) {
    unsigned char* dst = smem + L::conv;
    constexpr int KC = DK / 16;
    constexpr int VC = kMlaDv / 16;
    for (int i = tid; i < kMlaKv * (KC + VC); i += NT) {
      const bool isv = i >= kMlaKv * KC;
      const int ii = isv ? i - kMlaKv * KC : i;
      const uint4 w = *reinterpret_cast<const uint4*>(st + (isv ? L::rw_v : 0) + ii * 16);
      uint4 lo, hi;
      i8x16_to_bf16(w, lo, hi);
      unsigned char* o = dst + (isv ? L::st_v + (ii / VC) * VS * 2 + (ii % VC) * 32
                                    : L::st_k + (ii / KC) * QS * 2 + (ii % KC) * 32);
      *reinterpret_cast<uint4*>(o) = lo;
      *reinterpret_cast<uint4*>(o + 16) = hi;
    }
    if (tid < 12) {
      *reinterpret_cast<uint4*>(dst + L::st_side + tid * 16) =
          *reinterpret_cast<const uint4*>(st + L::rw_side + tid * 16);
    }
  };

  int rp[2];  // this thread's rows rr0 and rr0 + 8 of the block
  const int rr0 = rw * 16 + g;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + rr0 + 8 * j;
    rp[j] = r < R ? p.row_pos[(size_t)b * R + r] : -1;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 domain)
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  float acc[NO][4];                     // O: columns Dv/2 dh + 8 j + 2 t4 (+1)
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const uint32_t q_base = smem_u32(smem + L::q) + rw * 16 * QS * 2;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_sub) issue(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_sub; ++i) {
    if (i + NS - 1 < n_sub) issue(i + NS - 1, (i + NS - 1) % NS);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();  // sub-tile i has landed for every thread
    const unsigned char* tile = smem + L::ring + (i % NS) * L::kStage;
    if (!BF16) {
      convert(tile);
      __syncthreads();
      tile = smem + L::conv;
    }
    const float* kss = reinterpret_cast<const float*>(tile + L::st_side);
    const float* vss = kss + kMlaKv;
    const int* cps = reinterpret_cast<const int*>(kss + 2 * kMlaKv);
    const uint32_t k_base = smem_u32(tile + L::st_k);
    const uint32_t v_base = smem_u32(tile + L::st_v) + dh * kMlaHalf * 2;

    // S [16 rows x 16 KV rows] = Q K^T over Dk: s[nt][e] is row rr0 + 8 (e >>
    // 1), KV row 8 nt + 2 t4 + (e & 1)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], kb[4];
      ldsm_x4(a, q_base + ((lane & 15) * QS + kk * 16 + (lane >> 4) * 8) * 2);
      ldsm_x4(kb, k_base + (((lane & 7) + (lane >> 4) * 8) * QS + kk * 16 +
                            ((lane >> 3) & 1) * 8) * 2);
      mma_bf16(s[0], a, kb[0], kb[1]);
      mma_bf16(s[1], a, kb[2], kb[3]);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t4 + (e & 1);
        s[nt][e] = score<false>(s[nt][e], BF16 ? 1.f : kss[col], p, cps[col], rp[e >> 1]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      alpha[j] = mx[j] == -INFINITY ? 1.f : ex2(m[j] - mx[j]);
      m[j] = mx[j];
      l[j] *= alpha[j];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // P (f32 sums), p * v_scale in bf16 as P V's A fragment
    uint32_t pa[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = m[e >> 1] == -INFINITY ? 0.f : ex2(s[nt][e] - m[e >> 1]);
        l[e >> 1] += pe;
        pv[e] = BF16 ? pe : pe * vss[8 * nt + 2 * t4 + (e & 1)];
      }
      pa[2 * nt] = pack_bf16(pv[0], pv[1]);
      pa[2 * nt + 1] = pack_bf16(pv[2], pv[3]);
    }
    // O [16 x Dv/2] += P [16 x 16] V [16 x Dv/2], V by ldmatrix.trans
#pragma unroll
    for (int jj = 0; jj < NO / 2; ++jj) {
      uint32_t vb[4];
      ldsm_x4_t(vb, v_base + (((lane & 7) + ((lane >> 3) & 1) * 8) * VS + jj * 16 +
                              (lane >> 4) * 8) * 2);
      mma_bf16(acc[2 * jj], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * jj + 1], pa, vb[2], vb[3]);
    }
    __syncthreads();  // the stage (and the bf16 tile) are free
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + rr0 + 8 * j;
      if (r >= R) continue;
      const float inv = l[j] > 0.f ? 1.f / l[j] : 0.f;
      float* o = p.out + (bh * R + r) * kMlaDv + dh * kMlaHalf + 2 * t4;
#pragma unroll
      for (int k = 0; k < NO; ++k) {
        *reinterpret_cast<float2*>(o + 8 * k) =
            make_float2(acc[k][2 * j] * inv, acc[k][2 * j + 1] * inv);
      }
    }
    return;
  }
  // the split's partial sums, unnormalised, with its (max, sum) per row
  const size_t n_rows = (size_t)p.B * p.Hkv * R;
  if (t_begin < n_tiles) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + rr0 + 8 * j;
      if (r >= R) continue;
      float* o = p.part_acc + ((size_t)split * n_rows + bh * R + r) * kMlaDv + dh * kMlaHalf +
                 2 * t4;
#pragma unroll
      for (int k = 0; k < NO; ++k) {
        *reinterpret_cast<float2*>(o + 8 * k) = make_float2(acc[k][2 * j], acc[k][2 * j + 1]);
      }
      if (dh == 0 && t4 == 0) {
        p.part_ml[(size_t)split * n_rows + bh * R + r] = m[j];
        p.part_ml[((size_t)splits + split) * n_rows + bh * R + r] = l[j];
      }
    }
  }
  // the last block of this row tile merges the splits in order
  __threadfence();
  __syncthreads();
  const size_t cidx = bh * n_rt + rt;
  if (tid == 0) last_block = atomicAdd(&p.counters[cidx], 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int n_live = tps > 0 ? (n_tiles + tps - 1) / tps : 0;  // splits that hold tiles
  float* wts = reinterpret_cast<float*>(smem + L::mg_w);
  float* mrow = reinterpret_cast<float*>(smem + L::mg_m);
  float* lrow = reinterpret_cast<float*>(smem + L::mg_l);
  for (int rr = warp; rr < nr; rr += NT / 32) {
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
      wts[(lane + 32 * k) * L::kRows + rr] = wt;
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
  // the accumulators, 4 columns a thread and eight splits' loads in flight
  // (the block's few threads read every split's rows: latency, not bytes)
  constexpr int C4 = kMlaDv / 4;
  for (int i = tid; i < nr * C4; i += NT) {
    const int rr = i / C4;
    const size_t off = (bh * R + r0 + rr) * kMlaDv + (i % C4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_live; s0 += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u] = s0 + u < n_live
                   ? __ldcg(reinterpret_cast<const float4*>(p.part_acc +
                                                            (s0 + u) * n_rows * kMlaDv + off))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float w = s0 + u < n_live ? wts[(s0 + u) * L::kRows + rr] : 0.f;
        a.x += v[u].x * w;
        a.y += v[u].y * w;
        a.z += v[u].z * w;
        a.w += v[u].w * w;
      }
    }
    const float Ls = lrow[rr];
    const float inv = Ls > 0.f ? 1.f / Ls : 0.f;
    *reinterpret_cast<float4*>(p.out + off) = make_float4(a.x * inv, a.y * inv, a.z * inv,
                                                          a.w * inv);
  }
  if (tid == 0) p.counters[cidx] = 0;  // ready for the next launch
}

template <int DK, int DV, int NW, bool BF16, bool PAGED>
cudaError_t run_mla(const Params& p, cudaStream_t st) {
  using L = MlaSmem<DK, DV, NW, BF16>;
  static unsigned long long ready = 0;
  auto* kern = fa_mla<DK, DV, NW, BF16, PAGED>;
  cudaError_t err = allow_smem(kern, L::bytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.splits, (p.R + L::kRows - 1) / L::kRows, p.B * p.Hkv);
  kern<<<grid, L::kThreads, L::bytes, st>>>(p);
  return cudaGetLastError();
}

template <int DK, int DV, bool PAGED>
cudaError_t run_mla_dk(const Params& p, bool wide, int bf16_kv, cudaStream_t st) {
  if (wide) {
    return bf16_kv ? run_mla<DK, DV, 4, true, PAGED>(p, st)
                   : run_mla<DK, DV, 4, false, PAGED>(p, st);
  }
  return bf16_kv ? run_mla<DK, DV, 1, true, PAGED>(p, st)
                 : run_mla<DK, DV, 1, false, PAGED>(p, st);
}

// the (Dk, Dv) pairs of the instantiation
inline bool mla_pair(int Dk, int Dv) {
  return (Dv == 512 && (Dk == 576 || Dk == 640)) || (Dv == 256 && Dk == 384);
}

// Launch the MLA kernel at (Dk, Dv) = (576 | 640, 512) or (384, 256) with one KV head:
// prefill != 0 takes the prefill route (64-row blocks, one split); else the
// decode route over `splits` (1-64) blocks a row tile, 16-row blocks up to 16
// rows and 64-row blocks above, with the merge scratch of fa_slots_launch
// (part_acc [splits, B, Hkv, R, Dv], part_ml [2, splits, B, Hkv, R],
// counters [B * Hkv * row tiles]) when splits > 1. No window, softcap or
// sinks. Returns cudaGetLastError().
template <bool PAGED>
int launch_mla(const Params& p, int Dk, int Dv, int prefill, int bf16_kv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.B <= 0 || p.R <= 0 || p.Hkv != 1 || !mla_pair(Dk, Dv) ||
      p.lay.S % kTile != 0 || (bf16_kv == 0) != (p.ks != nullptr && p.vs != nullptr) ||
      p.window != 0 || p.softcap != 0.f || p.sinks != nullptr || p.splits <= 0 ||
      p.splits > kMaxSplits || (prefill && p.splits != 1) ||
      (p.splits > 1 && (p.part_acc == nullptr || p.part_ml == nullptr || p.counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = prefill || p.R > 16;
  cudaError_t err;
  if (Dk == 384) {
    err = run_mla_dk<384, 256, PAGED>(p, wide, bf16_kv, st);
  } else if (Dk == 576) {
    err = run_mla_dk<576, 512, PAGED>(p, wide, bf16_kv, st);
  } else {
    err = run_mla_dk<640, 512, PAGED>(p, wide, bf16_kv, st);
  }
  return (int)err;
}

// dynamic shared memory of an MLA block (wide: 64 rows, else 16); -1 for a
// pair the kernel does not take
inline int mla_smem_bytes(int Dk, int Dv, int wide, int bf16_kv) {
#define FA_MLA_SMEM(DD, VV)                                                       \
  if (Dk == DD && Dv == VV) {                                                     \
    if (wide) {                                                                   \
      return bf16_kv ? MlaSmem<DD, VV, 4, true>::bytes : MlaSmem<DD, VV, 4, false>::bytes; \
    }                                                                             \
    return bf16_kv ? MlaSmem<DD, VV, 1, true>::bytes : MlaSmem<DD, VV, 1, false>::bytes;   \
  }
  FA_MLA_SMEM(384, 256)
  FA_MLA_SMEM(576, 512)
  FA_MLA_SMEM(640, 512)
#undef FA_MLA_SMEM
  return -1;
}

}  // namespace fa
