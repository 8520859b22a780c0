// Flash attention straight off the paged KV pool (int8 or bf16), for Hopper.
//
// Replaces the TPU Pallas kernel flash_attention_paged of
// llama_cpp_tpu/ops/pallas/flash_attn.py (fold path _fa_kernel_allheads +
// _allheads_update, per-head fallback _fa_kernel). The device code is
// flash_attn_common.cuh with the page-table layout: batch row b walks the
// pool rows of pages table[b, 0 .. lim), lim = clip(max_row_pos // page + 1,
// 1, MP).
//
// What bounds it on an H100: at decode the bytes of the K/V pages (int8:
// about 2 * D + 8 bytes per KV row and head, bf16: 4 * D); the prefill
// ubatch (R = 4 * 512 rows per head) is bounded by FP32 CUDA-core FMAs in
// this version, which does not use the tensor cores.

#include "flash_attn_common.cuh"

// q [B, Hkv, R, D] bf16, D = 32, 64, 128 or 256; k, v [Hkv, S_pool, D] int8 with ks, vs
// [Hkv, S_pool] f32 row scales, or bf16 with ks = vs = null; pos [S_pool]
// int32; row_pos [B, R] int32; table [B, MP] int32; sinks [Hkv, R] f32 or
// null; part_acc [splits, B, Hkv, R, D], part_m/part_l [splits, B, Hkv, R]
// f32 scratch; out [B, Hkv, R, D] f32. rows_per_warp is 1 or 4; page a
// multiple of 64. Returns cudaGetLastError().
extern "C" int fa_paged_launch(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* pos, const void* row_pos,
                               const void* table, const void* sinks, void* part_acc,
                               void* part_m, void* part_l, void* out, int B, int Hkv, int R,
                               long long S_pool, int MP, int page, int D, float sm_scale,
                               int window, float softcap, int rows_per_warp, int splits,
                               int bf16_kv, void* stream) {
  if (page <= 0 || page % fa::kTile != 0 || MP <= 0) return (int)cudaErrorInvalidValue;
  const fa::Layout lay{S_pool, MP, page, 0, 0};
  return fa::launch<true>(q, k, v, ks, vs, pos, row_pos, table, sinks, part_acc, part_m,
                          part_l, out, B, Hkv, R, lay, D, sm_scale, window, softcap,
                          rows_per_warp, splits, bf16_kv, stream);
}
