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
// about 2 * D + 8 bytes per row and head, bf16: 4 * D); the prefill ubatch is
// bounded by FP32 CUDA-core FMAs in this version (no tensor cores).

#include "flash_attn_common.cuh"

// q [B, Hkv, R, D] bf16, D = 32, 64, 128 or 256; k, v [n_seqs, Hkv, S, D] int8 with
// ks, vs [n_seqs, Hkv, S] f32 row scales, or bf16 with ks = vs = null; pos
// [n_seqs, S] int32; row_pos [B, R] int32; seq_idx [B] int32 (clamped to the
// cache); sinks [Hkv, R] f32 or null; part_acc [splits, B, Hkv, R, D],
// part_m/part_l [splits, B, Hkv, R] f32 scratch; out [B, Hkv, R, D] f32.
// rows_per_warp is 1 or 4; S a multiple of 64. Returns cudaGetLastError().
extern "C" int fa_slots_launch(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* pos, const void* row_pos,
                               const void* seq_idx, const void* sinks, void* part_acc,
                               void* part_m, void* part_l, void* out, int B, int Hkv, int R,
                               long long S, int n_seqs, int D, float sm_scale, int window,
                               float softcap, int ring, int rows_per_warp, int splits,
                               int bf16_kv, void* stream) {
  if (n_seqs <= 0) return (int)cudaErrorInvalidValue;
  const fa::Layout lay{S, 0, 0, n_seqs, ring};
  return fa::launch<false>(q, k, v, ks, vs, pos, row_pos, seq_idx, sinks, part_acc, part_m,
                           part_l, out, B, Hkv, R, lay, D, sm_scale, window, softcap,
                           rows_per_warp, splits, bf16_kv, stream);
}
