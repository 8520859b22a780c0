"""Turn the JAX package's model parameters into the port's, so both compute
the same function in the tests.

The input is the JAX package's `Model.params` with every array converted to
numpy (for instance `jax.tree_util.tree_map(np.asarray, params)`): dense
weights are numpy arrays, quantized weights are objects with the JAX
QuantTensor's fields (q, scales, mins, d, dmin as numpy arrays; group,
ggml_type, transposed, packed, out_dim, sgroup); stacked expert weights are
such objects with 3-D planes, the router a dense array; every key of a
layer (biases, q/k norms, post-norms, the recurrent mixers' ssm_*,
shortconv_* and attn_gate, RWKV's time_mix_* and channel_mix_*, bitnet's
sub-norms and talkie's layer_out_scale included) comes across as it is; an
encoder's token_types, T5's enc_layers (attn_rel_b among their keys) and
its decoder layers' cross_attn_*, nomic-bert-moe's expert stacks, Gemma
3n's AltUp, LAUREL and per-layer tensors (the [A-1, E, E] AltUp
projections dense) and MiniMax-M3's indexer too; nanbeige's looped layers
stay one set of tensors (n_loops).
kv_cache_from_jax does the same for a slot-table KVCache, iswa_from_jax
for an ISWACache on slot tables (a shared-KV layer's aliased indices
included), dsa_from_jax for a DSAMemory and recurrent_from_jax for a
RecurrentState, so a test can continue a JAX prefill in the port. Nothing
of JAX is imported.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.qtensor import QuantTensor
from ..runtime.kv_cache import ISWACache, KVCache
from ..runtime.memory import DSAMemory, RecurrentState


def _tensor(a, device) -> torch.Tensor | None:
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)  # a writable copy
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device)


def _weight(w, device):
    if hasattr(w, "q") and hasattr(w, "scales"):
        return QuantTensor(
            q=_tensor(w.q, device), scales=_tensor(w.scales, device),
            mins=_tensor(w.mins, device), group=int(w.group), ggml_type=int(w.ggml_type),
            transposed=bool(w.transposed), packed=bool(w.packed), out_dim=int(w.out_dim),
            d=_tensor(w.d, device), dmin=_tensor(w.dmin, device), sgroup=int(w.sgroup))
    return _tensor(w, device)


def params_from_jax(jparams: dict[str, Any], device="cpu", n_loops: int = 1) -> dict[str, Any]:
    """JAX `Model.params` (arrays as numpy) -> the port's params on `device`.
    n_loops (nanbeige's cfg.extra["n_loops"]): the layer list is the
    physical stack n_loops times, so only its first pass is converted and
    the rest refer to it, as the port's loader lists it (a converted tree
    of numpy arrays no longer shows which dicts were one)."""
    out: dict[str, Any] = {}
    for key, val in jparams.items():
        if key == "layers" and n_loops > 1:
            phys = [{k: _weight(w, device) for k, w in lw.items()}
                    for lw in val[: len(val) // n_loops]]
            out[key] = phys * n_loops
        elif key in ("layers", "enc_layers"):  # decoder blocks; T5's encoder blocks
            out[key] = [{k: _weight(w, device) for k, w in lw.items()} for lw in val]
        else:
            out[key] = _weight(val, device)
    return out


def kv_cache_from_jax(jkv, device="cpu") -> KVCache:
    """The JAX package's slot-table KVCache (fields k, v [L, n_seqs, Hkv,
    n_slots, D], pos, k_scale, v_scale as numpy arrays, ring) -> the port's,
    one tensor per layer."""
    def layers(a):
        if a is None:
            return None
        t = _tensor(a, device)
        return [t[i].contiguous() for i in range(t.shape[0])]

    return KVCache(k=layers(jkv.k), v=layers(jkv.v), pos=_tensor(jkv.pos, device),
                   k_scale=layers(jkv.k_scale), v_scale=layers(jkv.v_scale),
                   ring=bool(jkv.ring))


def iswa_from_jax(jkv, device="cpu") -> ISWACache:
    """The JAX package's ISWACache (fields full and swa, slot-table KVCaches
    whose arrays are numpy; is_swa, full_idx, swa_idx) -> the port's."""
    if hasattr(jkv.full, "table"):
        raise ValueError("iswa_from_jax takes an ISWACache on slot tables (Context(paged="
                         "False)), not one whose full layers are on the page pool")
    return ISWACache(full=kv_cache_from_jax(jkv.full, device),
                     swa=kv_cache_from_jax(jkv.swa, device), is_swa=tuple(jkv.is_swa),
                     full_idx=tuple(jkv.full_idx), swa_idx=tuple(jkv.swa_idx))


def recurrent_from_jax(jrs, device="cpu") -> RecurrentState:
    """The JAX package's RecurrentState (conv [L, n_seqs, d_conv - 1, C],
    ssm [L, n_seqs, d_state, d_inner] as numpy arrays) -> the port's."""
    return RecurrentState(conv=_tensor(jrs.conv, device), ssm=_tensor(jrs.ssm, device))


def dsa_from_jax(jkv, device="cpu") -> DSAMemory:
    """The JAX package's DSAMemory (kv and idx, slot-table KVCaches whose
    arrays are numpy) -> the port's."""
    return DSAMemory(kv=kv_cache_from_jax(jkv.kv, device), idx=kv_cache_from_jax(jkv.idx, device))
