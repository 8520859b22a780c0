"""Context and sequence state files (session files, slot save/restore;
port of the JAX package's runtime/state.py).

Analog of reference llama_state_save_file/load_file and llama_state_seq_*
(include/llama.h:829-923, src/llama-context.cpp:3021-3213). Format: one
.npz blob (a zip of npy arrays) with a JSON header carrying the magic
"tpu-llm-state", version 3, the model fingerprint (arch, n_layers,
n_kv_heads, head_dim_k, head_dim_v, quantized) and the memory class name,
as the JAX package writes it; bf16 tensors are stored as their uint16 bit
patterns.

- Per-sequence blobs (save_seq_state / load_seq_state) keep the JAX
  package's layout: the sequence's rows in position order, "positions"
  [n], "k"/"v" [L, H, n, D] and for an int8 memory "k_scale"/"v_scale"
  [L, H, n] (ISWA memories: "full_" and "swa_" prefixed); a recurrent
  state's "rs_conv" [L, d_conv - 1, C] and "rs_ssm" [L, d_state, d_inner]
  (a hybrid memory's attention rows "kv_" prefixed beside them). A blob
  written by either package loads into the other.
- Whole-context files (save_state / load_state) hold this package's own
  tensors under the names memory_tensors gives, in its order, and the
  header's "layout" names that layout. The JAX package's whole-context
  files hold its memory pytree's leaves instead and are refused with a
  ValueError, never loaded wrong; except for a RecurrentState (the Mamba
  and RWKV stacks' memory), whose two leaves are this package's conv and
  ssm tensors in the same order and shapes: its file is written in the
  JAX package's layout ("leaf_0", "leaf_1", n_leaves 2), so whole-context
  files of it move between the two packages both ways.

Loads copy into the memory's existing tensors, so a context's captured
decode loops go on reading the right storage; the page allocator is rebuilt
from the restored table (whole files) or extended for the restored
positions (sequences).
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from .kv_cache import ISWACache, KVCache
from .memory import DSAMemory, HybridMemory, RecurrentState
from .paged_kv import PagedKVCache

STATE_MAGIC = "tpu-llm-state"
STATE_VERSION = 3
LAYOUT = "llama_cpp_tpu_torch/memory_tensors-1"
LEAVES = "memory pytree leaves (the JAX package)"


def _pack(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> npz-safe numpy (bf16 as its uint16 bit pattern)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _unpack(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """npz array -> a tensor of `like`'s dtype on its device."""
    a = np.ascontiguousarray(a)
    if like.dtype == torch.bfloat16:
        if a.dtype != np.uint16:
            raise ValueError(f"bf16 state stored as {a.dtype}, not uint16 bit patterns")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(like.device)
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


def _fingerprint(ctx) -> dict:
    cfg = ctx.cfg
    return {
        "arch": cfg.arch,
        "n_layers": cfg.n_layers,
        "n_kv_heads": cfg.n_kv_heads,
        "head_dim_k": cfg.head_dim_k,
        "head_dim_v": cfg.head_dim_v,
        "quantized": bool(ctx.kv.quantized),
    }


def _write(header: dict, arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
                        **arrays)
    return buf.getvalue()


def _header(z) -> dict:
    return json.loads(bytes(z["header"]).decode())


# ---------------------------------------------------------------------------
# whole-context state: this package's memory tensors
# ---------------------------------------------------------------------------

def memory_tensors(kv) -> list[tuple[str, torch.Tensor]]:
    """The tensors of a KV memory, named, in the order a state file holds
    them: k.<il> for every layer, v.<il>, then for an int8 memory
    k_scale.<il> and v_scale.<il>, then pos, and the pool's page table;
    an ISWA memory's full tier under "full." and its rings under "swa.";
    a recurrent state's conv and ssm; a hybrid memory's attention part
    under "kv." and its recurrent state under "rs."; a DSAMemory's main KV
    under "kv." and its indexer keys under "idx."."""
    if isinstance(kv, ISWACache):
        return ([("full." + n, t) for n, t in memory_tensors(kv.full)]
                + [("swa." + n, t) for n, t in memory_tensors(kv.swa)])
    if isinstance(kv, RecurrentState):
        return [("conv", kv.conv), ("ssm", kv.ssm)]
    if isinstance(kv, HybridMemory):
        return ([("kv." + n, t) for n, t in memory_tensors(kv.kv)]
                + [("rs." + n, t) for n, t in memory_tensors(kv.rs)])
    if isinstance(kv, DSAMemory):
        return ([("kv." + n, t) for n, t in memory_tensors(kv.kv)]
                + [("idx." + n, t) for n, t in memory_tensors(kv.idx)])
    out = [(f"k.{i}", t) for i, t in enumerate(kv.k)]
    out += [(f"v.{i}", t) for i, t in enumerate(kv.v)]
    if kv.quantized:
        out += [(f"k_scale.{i}", t) for i, t in enumerate(kv.k_scale)]
        out += [(f"v_scale.{i}", t) for i, t in enumerate(kv.v_scale)]
    out.append(("pos", kv.pos))
    if isinstance(kv, PagedKVCache):
        out.append(("table", kv.table))
    return out


def _file_tensors(kv) -> tuple[list[tuple[str, torch.Tensor]], str]:
    """A whole-context file's (name, tensor) pairs and its layout: a
    RecurrentState's conv and ssm as the JAX package's leaves, any other
    memory's memory_tensors."""
    if isinstance(kv, RecurrentState):
        return [("leaf_0", kv.conv), ("leaf_1", kv.ssm)], LEAVES
    return memory_tensors(kv), LAYOUT


def save_state(ctx, path: str, extra: dict | None = None) -> int:
    """Snapshot the whole context (every sequence). Returns the bytes
    written. `extra` rides along in the header (the prompt cache's token
    list)."""
    tensors, layout = _file_tensors(ctx.kv)
    arrays = {name: _pack(t) for name, t in tensors}
    arrays["seq_len"] = np.asarray(ctx.seq_len)
    header = {
        "magic": STATE_MAGIC,
        "version": STATE_VERSION,
        "model": _fingerprint(ctx),
        "n_ctx": ctx.n_ctx,
        "n_seqs": ctx.n_seqs,
        "n_slots": ctx.n_slots,
        "memory": type(ctx.kv).__name__,
        "layout": layout,
        "tensors": [name for name, _ in tensors],
        "n_leaves": len(tensors),
        "extra": extra or {},
    }
    data = _write(header, arrays)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load_state(ctx, path: str) -> dict:
    """Restore a snapshot written by save_state into a compatible context,
    in place. Returns the header's `extra` dict. Raises ValueError, naming
    the mismatch, for a file of another model, geometry, memory or layout."""
    z = np.load(path)
    header = _header(z)
    if header.get("magic") != STATE_MAGIC:
        raise ValueError("not a tpu-llm state file")
    if header.get("version") > STATE_VERSION:
        raise ValueError(f"state version {header['version']} too new")
    if header["model"] != _fingerprint(ctx):
        raise ValueError(f"state/model mismatch: {header['model']} vs {_fingerprint(ctx)}")
    if header["n_slots"] != ctx.n_slots or header["n_seqs"] != ctx.n_seqs:
        raise ValueError("context geometry mismatch (n_slots/n_seqs)")
    if header.get("memory") != type(ctx.kv).__name__:
        raise ValueError(f"memory type mismatch ({header.get('memory')} vs "
                         f"{type(ctx.kv).__name__})")
    tensors, layout = _file_tensors(ctx.kv)
    held = header.get("layout") or LEAVES
    if held != layout:
        raise ValueError(
            f"state layout mismatch: the file holds {held}, this package reads {layout}; "
            "per-sequence blobs (save_seq_state) move between the two packages, whole-context "
            "files only for a recurrent state")
    if any(name not in z.files for name, _ in tensors) or header.get(
            "n_leaves", len(tensors)) != len(tensors):
        raise ValueError("memory structure mismatch (tensor names)")
    new = []
    for name, cur in tensors:
        a = z[name]
        if tuple(a.shape) != tuple(cur.shape):
            raise ValueError(f"state tensor {name} shape mismatch {a.shape} vs "
                             f"{tuple(cur.shape)}")
        new.append(_unpack(a, cur))
    for (_, cur), t in zip(tensors, new):
        cur.copy_(t)
    ctx.seq_len[:] = z["seq_len"]
    if ctx.alloc is not None:
        _rebuild_allocator(ctx)
    return header.get("extra", {})


def _rebuild_allocator(ctx) -> None:
    """Re-derive the host page allocator from a restored device table."""
    alloc = ctx.alloc
    table = ctx._pool().table.cpu().numpy()
    alloc.table = table.copy()
    used = set()
    for s in range(table.shape[0]):
        n = 0
        for j in range(table.shape[1]):
            if table[s, j] != alloc.trash:
                n = j + 1
                used.add(int(table[s, j]))
        alloc.count[s] = n
    alloc.free = [p for p in range(alloc.n_pages - 2, -1, -1) if p not in used]
    alloc.dirty = False


# ---------------------------------------------------------------------------
# per-sequence state (slot save/restore and migration): the JAX layout
# ---------------------------------------------------------------------------

def _kv_extract(kvc: KVCache, seq: int, prefix: str) -> dict:
    """A slot table's rows of one sequence, ordered by position."""
    pos = kvc.pos[seq].cpu().numpy()
    idx = np.nonzero(pos >= 0)[0]
    idx = idx[np.argsort(pos[idx], kind="stable")]
    sel = torch.from_numpy(idx).to(kvc.pos.device)
    out = {
        prefix + "positions": pos[idx],
        prefix + "k": _pack(torch.stack([k[seq][:, sel] for k in kvc.k])),  # [L, H, n, Dk]
        prefix + "v": _pack(torch.stack([v[seq][:, sel] for v in kvc.v])),
    }
    if kvc.quantized:
        out[prefix + "k_scale"] = _pack(torch.stack([s[seq][:, sel] for s in kvc.k_scale]))
        out[prefix + "v_scale"] = _pack(torch.stack([s[seq][:, sel] for s in kvc.v_scale]))
    return out


def _kv_inject(kvc: KVCache, seq: int, z, prefix: str) -> int:
    """Scatter saved rows into `seq` of a cleared slot table; slots derive
    from positions by the cache's slot policy (identity, or a ring's
    position % capacity keeping the last occupant of each slot)."""
    positions = np.asarray(z[prefix + "positions"])
    cap = kvc.n_slots - 1
    sel = None
    if kvc.ring:
        host_slots = positions % cap
        keep = {}
        for j, s in enumerate(host_slots):
            keep[int(s)] = j
        sel = np.asarray(sorted(keep.values()), dtype=np.int64)
        positions, host_slots = positions[sel], host_slots[sel]
    else:
        host_slots = np.minimum(positions, cap - 1)
    dev = kvc.pos.device
    slots = torch.from_numpy(host_slots.astype(np.int64)).to(dev)

    def put(bufs, name):
        a = z[prefix + name]
        if sel is not None:
            a = a[:, :, sel]
        for il, buf in enumerate(bufs):
            buf[seq][:, slots] = _unpack(a[il], buf)

    put(kvc.k, "k")
    put(kvc.v, "v")
    if kvc.quantized:
        put(kvc.k_scale, "k_scale")
        put(kvc.v_scale, "v_scale")
    kvc.pos[seq, slots] = torch.from_numpy(positions.astype(np.int32)).to(dev)
    return int(positions.size)


def _paged_extract(ctx, kvc: PagedKVCache, seq: int, prefix: str) -> dict:
    """A pool's rows of one sequence, ordered by position."""
    pages = ctx.alloc.seq_pages(seq)
    rows = (pages[:, None] * kvc.page + np.arange(kvc.page)[None, :]).reshape(-1)
    pos = kvc.pos.cpu().numpy()[rows]
    occ = np.nonzero(pos >= 0)[0]
    occ = occ[np.argsort(pos[occ], kind="stable")]
    sel = torch.from_numpy(rows[occ].astype(np.int64)).to(kvc.pos.device)
    out = {
        prefix + "positions": pos[occ],
        prefix + "k": _pack(torch.stack([k[:, sel] for k in kvc.k])),  # [L, H, n, Dk]
        prefix + "v": _pack(torch.stack([v[:, sel] for v in kvc.v])),
    }
    if kvc.quantized:
        out[prefix + "k_scale"] = _pack(torch.stack([s[:, sel] for s in kvc.k_scale]))
        out[prefix + "v_scale"] = _pack(torch.stack([s[:, sel] for s in kvc.v_scale]))
    return out


def _paged_inject(ctx, kvc: PagedKVCache, seq: int, z, prefix: str) -> int:
    positions = np.asarray(z[prefix + "positions"]).astype(np.int64)
    if positions.size:
        ctx.alloc.ensure(seq, int(positions.max()) + 1)
        ctx._sync_table()
    pg = ctx.alloc.table[seq, positions // kvc.page].astype(np.int64)
    dev = kvc.pos.device
    slots = torch.from_numpy(pg * kvc.page + positions % kvc.page).to(dev)

    def put(bufs, name):
        a = z[prefix + name]
        for il, buf in enumerate(bufs):
            buf[:, slots] = _unpack(a[il], buf)

    put(kvc.k, "k")
    put(kvc.v, "v")
    if kvc.quantized:
        put(kvc.k_scale, "k_scale")
        put(kvc.v_scale, "v_scale")
    kvc.pos[slots] = torch.from_numpy(positions.astype(np.int32)).to(dev)
    return int(positions.size)


def _rs_extract(rs: RecurrentState, seq: int, prefix: str) -> dict:
    return {prefix + "conv": _pack(rs.conv[:, seq]), prefix + "ssm": _pack(rs.ssm[:, seq])}


def _rs_inject(rs: RecurrentState, seq: int, z, prefix: str) -> int:
    rs.conv[:, seq] = _unpack(z[prefix + "conv"], rs.conv)
    rs.ssm[:, seq] = _unpack(z[prefix + "ssm"], rs.ssm)
    return 1


def _seq_parts(kv) -> list[tuple[object, str]]:
    """-> [(sub-memory, npz key prefix)]: the per-type state writers of the
    reference (src/llama-kv-cache*.cpp, llama-memory-recurrent.cpp,
    llama-memory-hybrid.cpp)."""
    if isinstance(kv, (PagedKVCache, KVCache)):
        return [(kv, "")]
    if isinstance(kv, ISWACache):
        return [(kv.full, "full_"), (kv.swa, "swa_")]
    if isinstance(kv, RecurrentState):
        return [(kv, "rs_")]
    if isinstance(kv, HybridMemory):
        return [(kv.kv, "kv_"), (kv.rs, "rs_")]
    if isinstance(kv, DSAMemory):
        return [(kv.kv, "kv_"), (kv.idx, "idx_")]
    raise ValueError(f"per-sequence state unsupported for {type(kv).__name__}")


def save_seq_state(ctx, seq: int) -> bytes:
    """One sequence's memory as a portable blob (positions and rows),
    independent of the source context's geometry."""
    arrays: dict = {}
    for sub, prefix in _seq_parts(ctx.kv):
        if isinstance(sub, RecurrentState):
            arrays.update(_rs_extract(sub, seq, prefix))
        elif isinstance(sub, PagedKVCache):
            arrays.update(_paged_extract(ctx, sub, seq, prefix))
        else:
            arrays.update(_kv_extract(sub, seq, prefix))
    header = {"magic": STATE_MAGIC, "version": STATE_VERSION, "model": _fingerprint(ctx),
              "memory": type(ctx.kv).__name__, "seq_len": int(ctx.seq_len[seq])}
    return _write(header, arrays)


def load_seq_state(ctx, seq: int, blob: bytes) -> int:
    """Scatter a saved sequence into `seq` of this context, in place.
    Returns the number of restored cells (attention rows, or 1 for a
    recurrent state alone)."""
    z = np.load(io.BytesIO(blob))
    header = _header(z)
    if header.get("magic") != STATE_MAGIC:
        raise ValueError("not a tpu-llm sequence state blob")
    if header["model"] != _fingerprint(ctx):
        raise ValueError(f"sequence state/model mismatch: {header['model']} vs "
                         f"{_fingerprint(ctx)}")
    if header.get("memory", "KVCache") != type(ctx.kv).__name__:
        raise ValueError(f"sequence state memory-type mismatch ({header.get('memory')} vs "
                         f"{type(ctx.kv).__name__})")
    if header["seq_len"] > ctx.n_ctx:
        raise ValueError("sequence longer than target context")
    ctx.seq_rm(seq)
    n = 0
    for sub, prefix in _seq_parts(ctx.kv):
        if isinstance(sub, RecurrentState):
            n = max(n, _rs_inject(sub, seq, z, prefix))
        elif isinstance(sub, PagedKVCache):
            n = max(n, _paged_inject(ctx, sub, seq, z, prefix))
        else:
            n = max(n, _kv_inject(sub, seq, z, prefix))
    ctx.seq_len[seq] = header["seq_len"]
    return n
