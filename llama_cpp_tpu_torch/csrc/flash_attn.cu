// Flash attention over the slot-table KV cache (int8 or bf16), for Hopper.
//
// Replaces the TPU Pallas kernel flash_attention of
// llama_cpp_tpu/ops/pallas/flash_attn.py (_fa_kernel + _fa_tile), the
// attention of every memory that is not the page pool. The device code is
// flash_attn_common.cuh with the slot-table layout: the cache holds
// [n_seqs, Hkv, S, D] per layer and batch row b reads sequence seq_idx[b]
// in place (the JAX caller gathers cache[seq_idx] first, a copy of the
// layer's cache every step). Live tiles: clip(max_row_pos // 64 + 1, 1,
// S / 64), or all S / 64 for a ring (wrapped) table.
//
// What bounds it on an H100: at decode the bytes of the live K/V rows (int8:
// about 2 * D + 8 bytes per row and head, bf16: 4 * D); the prefill ubatch
// by its bf16 tensor-core operations (4 D flops per visible query-key pair).

// The MLA instantiation over the slot table (one KV head; K rows of 576 or
// 640 and V rows of 512: DeepSeek-V2/V3, PLM; K rows of 384 and V rows of
// 256: MiniCPM3) is flash_attn_mla.cuh with the same layout.

#include "flash_attn_common.cuh"
#include "flash_attn_mla.cuh"

// q [B, Hkv, R, D] bf16, D = 32, 64, 128 or 256; k, v [n_seqs, Hkv, S, D] int8 with
// ks, vs [n_seqs, Hkv, S] f32 row scales, or bf16 with ks = vs = null; pos
// [n_seqs, S] int32; row_pos [B, R] int32; seq_idx [B] int32 (clamped to the
// cache); sinks [Hkv, R] f32 or null; out [B, Hkv, R, D] f32. prefill != 0
// takes the prefill kernel; else the decode kernel over `splits` (1-64)
// blocks a row group, with part_acc [splits, B, Hkv, R, D] and part_ml [2,
// splits, B, Hkv, R] f32 scratch and counters [B * Hkv * ceil(R / 8)] int32
// (zero, left zero) when splits > 1. Every pointer 16-byte aligned, S a
// multiple of 64. Returns cudaGetLastError().
extern "C" int fa_slots_launch(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* pos, const void* row_pos,
                               const void* seq_idx, const void* sinks, void* part_acc,
                               void* part_ml, void* counters, void* out, int B, int Hkv, int R,
                               long long S, int n_seqs, int D, float sm_scale, int window,
                               float softcap, int ring, int prefill, int splits, int bf16_kv,
                               void* stream) {
  if (n_seqs <= 0) return (int)cudaErrorInvalidValue;
  const fa::Params p{static_cast<const __nv_bfloat16*>(q), k, v,
                     static_cast<const float*>(ks), static_cast<const float*>(vs),
                     static_cast<const int*>(pos), static_cast<const int*>(row_pos),
                     static_cast<const int*>(seq_idx), static_cast<const float*>(sinks),
                     static_cast<float*>(out), static_cast<float*>(part_acc),
                     static_cast<float*>(part_ml), static_cast<int*>(counters), B, Hkv, R,
                     fa::Layout{S, 0, 0, n_seqs, ring}, sm_scale, window, softcap, splits};
  return fa::launch<false>(p, D, prefill, bf16_kv, stream);
}

// The MLA instantiation (flash_attn_mla.cuh) over the slot table: q [B, 1,
// R, Dk] bf16, (Dk, Dv) = (576 | 640, 512) or (384, 256); k [n_seqs, 1, S,
// Dk] and v [n_seqs, 1, S, Dv], int8 with row scales or bf16; out [B, 1, R,
// Dv] f32; the other
// arguments as fa_slots_launch, without window, softcap, sinks or ring.
extern "C" int fa_slots_mla_launch(const void* q, const void* k, const void* v, const void* ks,
                                   const void* vs, const void* pos, const void* row_pos,
                                   const void* seq_idx, void* part_acc, void* part_ml,
                                   void* counters, void* out, int B, int Hkv, int R, long long S,
                                   int n_seqs, int Dk, int Dv, float sm_scale, int prefill,
                                   int splits, int bf16_kv, void* stream) {
  if (n_seqs <= 0) return (int)cudaErrorInvalidValue;
  const fa::Params p{static_cast<const __nv_bfloat16*>(q), k, v,
                     static_cast<const float*>(ks), static_cast<const float*>(vs),
                     static_cast<const int*>(pos), static_cast<const int*>(row_pos),
                     static_cast<const int*>(seq_idx), nullptr, static_cast<float*>(out),
                     static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                     static_cast<int*>(counters), B, Hkv, R, fa::Layout{S, 0, 0, n_seqs, 0},
                     sm_scale, 0, 0.f, splits};
  return fa::launch_mla<false>(p, Dk, Dv, prefill, bf16_kv, stream);
}
