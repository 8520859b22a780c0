// Flash attention straight off the paged KV pool (int8 or bf16), for Hopper.
//
// Replaces the TPU Pallas kernel flash_attention_paged of
// llama_cpp_tpu/ops/pallas/flash_attn.py (fold path _fa_kernel_allheads +
// _allheads_update, per-head fallback _fa_kernel). The device code is
// flash_attn_common.cuh with the page-table layout: batch row b walks the
// pool rows of pages table[b, 0 .. lim), lim = clip(max_row_pos // page + 1,
// 1, MP); a 64-row tile of a page is 64 D contiguous elements of a head.
//
// What bounds it on an H100: at decode the bytes of the K/V pages (int8:
// about 2 * D + 8 bytes per KV row and head, bf16: 4 * D); the prefill
// ubatch (R = 4 * 512 rows per head) by its bf16 tensor-core operations.

#include "flash_attn_common.cuh"

// q [B, Hkv, R, D] bf16, D = 32, 64, 128 or 256; k, v [Hkv, S_pool, D] int8 with ks, vs
// [Hkv, S_pool] f32 row scales, or bf16 with ks = vs = null; pos [S_pool]
// int32; row_pos [B, R] int32; table [B, MP] int32; sinks [Hkv, R] f32 or
// null; out [B, Hkv, R, D] f32. prefill, splits, part_acc, part_ml and
// counters as fa_slots_launch (flash_attn.cu). Every pointer 16-byte
// aligned, page a multiple of 64. Returns cudaGetLastError().
extern "C" int fa_paged_launch(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* pos, const void* row_pos,
                               const void* table, const void* sinks, void* part_acc,
                               void* part_ml, void* counters, void* out, int B, int Hkv, int R,
                               long long S_pool, int MP, int page, int D, float sm_scale,
                               int window, float softcap, int prefill, int splits, int bf16_kv,
                               void* stream) {
  if (page <= 0 || page % fa::kTile != 0 || MP <= 0) return (int)cudaErrorInvalidValue;
  const fa::Params p{static_cast<const __nv_bfloat16*>(q), k, v,
                     static_cast<const float*>(ks), static_cast<const float*>(vs),
                     static_cast<const int*>(pos), static_cast<const int*>(row_pos),
                     static_cast<const int*>(table), static_cast<const float*>(sinks),
                     static_cast<float*>(out), static_cast<float*>(part_acc),
                     static_cast<float*>(part_ml), static_cast<int*>(counters), B, Hkv, R,
                     fa::Layout{S_pool, MP, page, 0, 0}, sm_scale, window, softcap, splits};
  return fa::launch<true>(p, D, prefill, bf16_kv, stream);
}

// Dynamic shared memory of one block of the prefill (prefill != 0) or
// decode kernel at head dim D over an int8 or bf16 memory; -1 for a head
// dim the kernels do not take.
extern "C" int fa_smem_bytes(int D, int prefill, int bf16_kv) {
  return fa::smem_bytes(D, prefill, bf16_kv);
}
