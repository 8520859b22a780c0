"""Kernel conformance sweep of the port: every row of the JAX package's
scripts/conformance.py (the test-backend-ops analog) through the port's
kernels, each held against the same f64 numpy oracle under the reference's
threshold (NMSE < 5e-3).

    python -m llama_cpp_tpu_torch.tools.conformance [--device cpu] [--out PATH]

On the card (the default) each row goes through the port's CUDA kernel,
and the launch counters must show exactly one launch of the kernel its
route names; the rows are written to docs/conformance_h100.csv (or --out):
the reference's columns (kernel, config, backend, nmse, pass) plus the
card (nvidia-smi name and power limit) and the route. With --device cpu
each row goes through the kernel's plain PyTorch version instead, and the
CSV is written only where --out says. A row whose shape the port's kernels
do not take (K and V heads that differ: the MLA rows) is written as
`raises` with the error's text; any other error is a FAIL. The data are
the reference's: the same seeds, drawn in the same order. Exit code 1 if a
row fails.
"""

from __future__ import annotations

import argparse
import csv
import functools
import io
import os
import subprocess
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..models.loader import resolve_device
from ..ops.kernels import flash_attn as fa
from ..ops.kernels import qmm
from ..ops.kernels import qmm_expert as qe
from ..ops.qtensor import QuantTensor

NMSE_LIMIT = 5e-3  # the reference's threshold (scripts/conformance.py)
COLUMNS = ("kernel", "config", "backend", "nmse", "pass", "device", "route")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "docs", "conformance_h100.csv")


class Unsupported(ValueError):
    """The port's kernels do not take this row's shape."""


@dataclass(frozen=True)
class Case:
    kernel: str
    config: str
    run: object = None  # device -> (got [..] f32 numpy, route); None when only listed
    want: object = None  # () -> the f64 oracle


@dataclass(frozen=True)
class Row:
    kernel: str
    config: str
    nmse: float | None
    status: str  # PASS, FAIL or raises
    route: str


# -- the reference's oracles and plane builders (copies) --------------------------

def nmse(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / (np.mean(want ** 2) + 1e-12))


def ref_attention(q, k, v, row_pos, col_pos, scale, window=0, softcap=0.0, sinks=None,
                  k_scale=None, v_scale=None):
    """f64 numpy online-softmax reference."""
    q = np.asarray(q, np.float64)
    k = np.asarray(k, np.float64)
    v = np.asarray(v, np.float64)
    if k_scale is not None:
        k = k * np.asarray(k_scale, np.float64)[..., None]
        v = v * np.asarray(v_scale, np.float64)[..., None]
    s = np.einsum("bhrd,bhsd->bhrs", q, k) * scale
    if softcap:
        s = softcap * np.tanh(s / softcap)
    rp = np.asarray(row_pos)[:, None, :, None]
    cp = np.asarray(col_pos)[:, None, None, :]
    mask = (cp >= 0) & (cp <= rp)
    if window > 0:
        mask &= cp > rp - window
    s = np.where(mask, s, -1e30)
    m = s.max(axis=-1, keepdims=True)
    if sinks is not None:
        m = np.maximum(m, np.asarray(sinks, np.float64)[None, :, :, None])
    p = np.exp(s - m)
    denom = p.sum(-1, keepdims=True)
    if sinks is not None:
        denom = denom + np.exp(np.asarray(sinks, np.float64)[None, :, :, None] - m)
    p = p / np.maximum(denom, 1e-30)
    return np.einsum("bhrs,bhsd->bhrd", p, v)


def _pack_halfsplit(u):
    """[K, O] uint8 nibbles -> [K/2, O] packed: row k low, row k + K/2 high."""
    half = u.shape[0] // 2
    return (u[:half] | (u[half:] << 4)).astype(np.uint8)


def _hier_factor(rng, K, O, g, lo, hi, sgroup=256):
    """Hierarchical scales: int8 sub x f32 per-superblock d, and the flat f32
    plane they make for the oracle."""
    sub = rng.integers(1, 64, size=(K // g, O)).astype(np.int8)
    d = rng.uniform(lo, hi, size=(K // sgroup, O)).astype(np.float32)
    flat = sub.astype(np.float32) * np.repeat(d, sgroup // g, axis=0)
    return sub, d, flat


# -- running a row through the port ---------------------------------------------------

def _launched(counter: dict, key: str, device: torch.device, call):
    """call(); on the card exactly one launch of `key` and nothing else."""
    before = dict(counter)
    out = call()
    if device.type == "cuda":
        torch.cuda.synchronize()
        if counter != {**before, key: before[key] + 1}:
            raise RuntimeError(f"expected one launch of {key}, the counts went from {before} "
                               f"to {counter}")
    return out.float().cpu().numpy()


def _attention(device, paged: bool, q, k, v, row_pos, cols, index, ks, vs, sinks, scale, *,
               window=0, softcap=0.0, page=0):
    """The slot-table (cols: col_pos [B, S], index: seq_idx) or paged (cols:
    pos [S_pool], index: table_b) kernel on numpy inputs: q in bf16, an f32
    K/V memory in bf16, an int8 one with its f32 row scales."""
    name = "flash_attention_paged" if paged else "flash_attention"
    D, Dv = q.shape[-1], v.shape[-1]
    kv_dtype = torch.int8 if k.dtype == np.int8 else torch.bfloat16
    if not fa.supported(D, Dv, page if paged else k.shape[2], kv_dtype):
        raise Unsupported(f"{name}: the kernels take K and V head dims alike in "
                          f"{fa.HEAD_DIMS}, got Dk={D}, Dv={Dv}")

    def t(a, dtype=None):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(
            device, dtype)

    args = (t(q, torch.bfloat16), t(k, kv_dtype), t(v, kv_dtype), t(row_pos), t(cols),
            t(index), t(ks), t(vs), t(sinks))
    kw = dict(sm_scale=scale, window=window, softcap=softcap)
    fn = fa.flash_attention_paged if paged else fa.flash_attention
    if paged:
        kw["page"] = page
    route = f"{name}/{fa.route(q.shape[2])}" if device.type == "cuda" else f"{name}_plain"
    return _launched(fa.launches, route, device, lambda: fn(*args, **kw)), route


def _product(device, x, w_np: dict):
    """qmm on a transposed-plane QuantTensor built from numpy planes."""
    planes = {k: None if w_np.get(k) is None else torch.from_numpy(
        np.ascontiguousarray(w_np[k])).to(device) for k in ("q", "scales", "mins", "d", "dmin")}
    w = QuantTensor(**planes, group=w_np["group"], ggml_type=int(GGMLType.Q4_K),
                    transposed=True, packed=w_np.get("packed", False))
    if not qmm.supported(w):
        raise Unsupported(f"qmm: the kernels do not take this layout (packed={w.packed}, "
                          f"group={w.group}, hier={w.hier}, shape={tuple(w.q.shape)})")
    xt = torch.from_numpy(x).to(device, torch.bfloat16)
    route = qmm.kernel_name(w, x.shape[0]) if device.type == "cuda" else "qmm_plain"
    return _launched(qmm.launches, route, device, lambda: qmm.qmm(xt, w)), route


def _expert(device, x, ids, q, sc, g):
    w = QuantTensor(q=torch.from_numpy(q).to(device), scales=torch.from_numpy(sc).to(device),
                    mins=None, group=g, ggml_type=int(GGMLType.Q8_0), transposed=True)
    if not qe.supported(w):
        raise Unsupported("qmm_expert: the kernel does not take this stack")
    xt = torch.from_numpy(x).to(device, torch.bfloat16)
    it = torch.from_numpy(ids).to(device)
    route = "qmm_planes_expert" if device.type == "cuda" else "qmm_expert_plain"
    return _launched(qe.launches, route, device, lambda: qe.qmm_expert(xt, it, w)), route


# -- the reference's sweeps, row by row (rng None: the rows' names only) -------------

def _fill_pages(rng, B, page, npages, mp, depth):
    """Each sequence's pages scattered over the pool: the page table and the
    position labels (the reference's page fill)."""
    pos2 = np.full((npages, page), -1, np.int32)
    table = np.full((B, mp), npages - 1, np.int32)
    perm = rng.permutation(npages - 1)
    pi = 0
    for b in range(B):
        for j in range(-(-depth // page)):
            pg = int(perm[pi])
            pi += 1
            table[b, j] = pg
            n = min(page, depth - j * page)
            pos2[pg, :n] = np.arange(j * page, j * page + n)
    return pos2, table


def _paged_case(kernel, config, q, k4, v4, pos2, table, row_pos, page, ks=None, vs=None):
    """A paged row: the pool [H, pages, page, D] as the port's [H, pages *
    page, D]; the oracle on each sequence's gathered view."""
    H, npages, _, Dk = k4.shape
    B, mp = table.shape
    scale = 1.0 / Dk ** 0.5

    def run(device):
        flat = (lambda a: None if a is None else a.reshape(H, npages * page))
        return _attention(device, True, q, k4.reshape(H, npages * page, Dk),
                          v4.reshape(H, npages * page, v4.shape[-1]), row_pos,
                          pos2.reshape(-1), table, flat(ks), flat(vs), None, scale, page=page)

    def want():
        def view(a):
            return a[:, table].transpose(1, 0, 2, 3, 4).reshape(B, H, mp * page, a.shape[-1])
        scales = [None if s is None else s[:, table].transpose(1, 0, 2, 3).reshape(
            B, H, mp * page) for s in (ks, vs)]
        return ref_attention(q, view(k4), view(v4), row_pos, pos2[table].reshape(B, mp * page),
                             scale, k_scale=scales[0], v_scale=scales[1])

    return Case(kernel, config, run, want)


def sweep_flash(rng):
    cases = [(B, 8 if D <= 128 else 4, R, D, Dv, S, feat)
             for D, Dv in ((128, 128), (64, 64), (256, 256)) for S in (512, 1024)
             for B, R in ((1, 8), (4, 16))
             for feat in ("plain", "window", "softcap", "sinks", "int8")]
    for B, H, R, D, Dv, S, feat in cases:
        config = f"B{B}H{H}R{R}D{D}S{S}-{feat}"
        if rng is None:
            yield Case("flash_attn", config)
            continue
        q = rng.standard_normal((B, H, R, D)).astype(np.float32)
        k = rng.standard_normal((B, H, S, D)).astype(np.float32)
        v = rng.standard_normal((B, H, S, Dv)).astype(np.float32)
        depth = S - 7
        row_pos = np.tile(np.arange(depth - R, depth, dtype=np.int32), (B, 1))
        col_pos = np.tile(np.where(np.arange(S) < depth, np.arange(S), -1).astype(np.int32),
                          (B, 1))
        scale = 1.0 / D ** 0.5
        kw = {}
        sinks = ks = vs = None
        if feat == "window":
            kw["window"] = S // 4
        elif feat == "softcap":
            kw["softcap"] = 30.0
        elif feat == "sinks":
            sinks = rng.standard_normal((H, R)).astype(np.float32)
        elif feat == "int8":
            ks = (np.abs(k).max(-1) / 127.0).astype(np.float32)
            vs = (np.abs(v).max(-1) / 127.0).astype(np.float32)
            k = np.round(k / ks[..., None]).astype(np.int8)
            v = np.round(v / vs[..., None]).astype(np.int8)
        seq_idx = np.arange(B, dtype=np.int32)
        yield Case("flash_attn", config,
                   functools.partial(_attention, paged=False, q=q, k=k, v=v, row_pos=row_pos,
                                     cols=col_pos, index=seq_idx, ks=ks, vs=vs, sinks=sinks,
                                     scale=scale, **kw),
                   functools.partial(ref_attention, q, k, v, row_pos, col_pos, scale,
                                     window=kw.get("window", 0),
                                     softcap=kw.get("softcap", 0.0), sinks=sinks, k_scale=ks,
                                     v_scale=vs))


def sweep_flash_paged(rng):
    page = 256
    for B, H, R, D, npages, mp in ((2, 4, 8, 128, 9, 4), (1, 8, 16, 128, 17, 8),
                                   (4, 2, 8, 256, 17, 4)):
        config = f"B{B}H{H}R{R}D{D}p{page}"
        if rng is None:
            yield Case("flash_attn_paged", config)
            continue
        k4 = rng.standard_normal((H, npages, page, D)).astype(np.float32)
        v4 = rng.standard_normal((H, npages, page, D)).astype(np.float32)
        depth = int(page * 2.5)
        pos2, table = _fill_pages(rng, B, page, npages, mp, depth)
        q = rng.standard_normal((B, H, R, D)).astype(np.float32)
        row_pos = np.tile(np.arange(depth - R, depth, dtype=np.int32), (B, 1))
        yield _paged_case("flash_attn_paged", config, q, k4, v4, pos2, table, row_pos, page)


def sweep_flash_paged_holes(rng):
    for B, H, R, D, page, npages, mp, depth in ((2, 1, 8, 128, 256, 21, 8, 1500),
                                                (1, 4, 8, 128, 512, 11, 9, 4096),
                                                (2, 2, 16, 256, 256, 21, 6, 1200)):
        config = f"B{B}H{H}R{R}D{D}p{page}d{depth}"
        if rng is None:
            yield Case("flash_attn_paged_holes", config)
            continue
        k4 = rng.standard_normal((H, npages, page, D)).astype(np.float32)
        v4 = rng.standard_normal((H, npages, page, D)).astype(np.float32)
        pos2, table = _fill_pages(rng, B, page, npages, mp, depth)
        for b in range(B):  # a range of rows invalidated inside an owned page
            hole_pg = int(table[b, -(-depth // page) // 2])
            pos2[hole_pg, page // 4: page // 2] = -1
        q = rng.standard_normal((B, H, R, D)).astype(np.float32)
        row_pos = np.tile(np.arange(depth - R, depth, dtype=np.int32), (B, 1))
        yield _paged_case("flash_attn_paged_holes", config, q, k4, v4, pos2, table, row_pos,
                          page)


def sweep_flash_paged_variants(rng):
    for label, B, H, R, Dk, Dv, page, npages, mp, depth, int8 in (
            ("int8-fold", 2, 8, 8, 128, 128, 256, 13, 6, 1200, True),
            ("int8-nonfold", 1, 16, 8, 256, 256, 1024, 7, 4, 3000, True),
            ("bf16-nonfold", 1, 8, 16, 256, 256, 1024, 7, 4, 3000, False),
            ("mla-576", 2, 1, 16, 576, 512, 256, 17, 8, 1800, False),
            ("mla-576-int8", 2, 1, 16, 576, 512, 256, 17, 8, 1800, True)):
        if rng is None:
            yield Case("flash_attn_paged", label)
            continue
        k4 = rng.standard_normal((H, npages, page, Dk)).astype(np.float32)
        v4 = rng.standard_normal((H, npages, page, Dv)).astype(np.float32)
        ks = vs = None
        if int8:
            ks = (np.abs(k4).max(-1) / 127.0).astype(np.float32)
            vs = (np.abs(v4).max(-1) / 127.0).astype(np.float32)
            k4 = np.round(k4 / ks[..., None]).astype(np.int8)
            v4 = np.round(v4 / vs[..., None]).astype(np.int8)
        pos2, table = _fill_pages(rng, B, page, npages, mp, depth)
        q = rng.standard_normal((B, H, R, Dk)).astype(np.float32)
        row_pos = np.tile(np.arange(depth - R, depth, dtype=np.int32), (B, 1))
        yield _paged_case("flash_attn_paged", label, q, k4, v4, pos2, table, row_pos, page,
                          ks, vs)


def _qmm_case(kernel, config, x, planes, w_flat):
    """A product row: the port's qmm on `planes`, the oracle x . w_flat in f64."""
    return Case(kernel, config, functools.partial(_product, x=x, w_np=planes),
                lambda: x.astype(np.float64) @ np.asarray(w_flat, np.float64))


def sweep_qmm(rng):
    for N, K, O, g in ((8, 512, 512, 32), (64, 1024, 512, 32), (8, 512, 256, 16),
                       (8, 2048, 1024, 32), (16, 4096, 512, 32)):
        for mins in (False, True):
            config = f"N{N}K{K}O{O}g{g}{'m' if mins else ''}"
            if rng is None:
                yield Case("qmm_planes", config)
                continue
            q = rng.integers(-8, 8, size=(K, O)).astype(np.int8)
            sc = rng.uniform(0.005, 0.02, size=(K // g, O)).astype(np.float32)
            mn = (rng.uniform(-0.05, 0.05, size=(K // g, O)).astype(np.float32) if mins
                  else None)
            x = rng.standard_normal((N, K)).astype(np.float32)
            w = np.repeat(sc, g, axis=0) * q
            if mn is not None:
                w = w + np.repeat(mn, g, axis=0)
            yield _qmm_case("qmm_planes", config, x, dict(q=q, scales=sc, mins=mn, group=g), w)
    for N, K, O, g in ((8, 512, 256, 16), (8, 4096, 1024, 16), (8, 14336, 512, 16),
                       (8, 1024, 512, 16), (16, 2048, 256, 16), (8, 4096, 4096, 32)):
        config = f"N{N}K{K}O{O}g{g}h"
        if rng is None:
            yield Case("qmm_planes", config)
            continue
        q = rng.integers(-32, 32, size=(K, O)).astype(np.int8)
        sub, d, sc_flat = _hier_factor(rng, K, O, g, 0.0005, 0.001)
        x = rng.standard_normal((N, K)).astype(np.float32)
        yield _qmm_case("qmm_planes", config, x, dict(q=q, scales=sub, d=d, group=g),
                        np.repeat(sc_flat, g, axis=0) * q)
    E, K, O, g, R = 8, 512, 256, 32, 16
    config = f"E{E}R{R}K{K}O{O}"
    if rng is None:
        yield Case("qmm_planes_expert", config)
        return
    q = rng.integers(-8, 8, size=(E, K, O)).astype(np.int8)
    sc = rng.uniform(0.005, 0.02, size=(E, K // g, O)).astype(np.float32)
    ids = rng.integers(0, E, size=R).astype(np.int32)
    x = rng.standard_normal((R, K)).astype(np.float32)
    yield Case("qmm_planes_expert", config,
               functools.partial(_expert, x=x, ids=ids, q=q, sc=sc, g=g),
               lambda: np.stack([x[i].astype(np.float64) @ (np.repeat(sc[e], g, axis=0) * q[e])
                                 for i, e in enumerate(ids)]))


def sweep_qmm4(rng):
    for N, K, O, g in ((8, 512, 512, 32), (8, 1024, 256, 32), (16, 512, 256, 16),
                       (8, 4096, 1024, 32), (8, 2048, 512, 32)):
        for mins in (False, True):
            for hier in ((False, True) if K % 512 == 0 else (False,)):
                config = f"N{N}K{K}O{O}g{g}{'m' if mins else ''}{'h' if hier else ''}"
                if rng is None:
                    yield Case("qmm4_planes", config)
                    continue
                u = rng.integers(0, 16, size=(K, O)).astype(np.uint8)
                packed = _pack_halfsplit(u).view(np.int8)
                x = rng.standard_normal((N, K)).astype(np.float32)
                if hier:
                    sub, d, sc_flat = _hier_factor(rng, K, O, g, 0.001, 0.002)
                    planes = dict(q=packed, scales=sub, d=d, group=g, packed=True)
                    mn_flat = None
                    if mins:
                        subm, dm, mn_flat = _hier_factor(rng, K, O, g, -0.01, -0.002)
                        planes.update(mins=subm, dmin=dm)
                else:
                    sc_flat = rng.uniform(0.005, 0.02, size=(K // g, O)).astype(np.float32)
                    mn_flat = (rng.uniform(-0.1, 0.0, size=(K // g, O)).astype(np.float32)
                               if mins else None)
                    planes = dict(q=packed, scales=sc_flat, mins=mn_flat, group=g, packed=True)
                w = np.repeat(sc_flat, g, axis=0) * u
                if mn_flat is not None:
                    w = w + np.repeat(mn_flat, g, axis=0)
                yield _qmm_case("qmm4_planes", config, x, planes, w)
    for N, K, O, g in ((512, 1024, 512, 32), (1024, 4096, 512, 32)):
        for hier in (False, True):
            config = f"N{N}K{K}O{O}g{g}{'h' if hier else ''}"
            if rng is None:
                yield Case("qmm4_prefill", config)
                continue
            u = rng.integers(0, 16, size=(K, O)).astype(np.uint8)
            packed = _pack_halfsplit(u).view(np.int8)
            x = rng.standard_normal((N, K)).astype(np.float32)
            if hier:
                sub, d, sc_flat = _hier_factor(rng, K, O, g, 0.001, 0.002)
                planes = dict(q=packed, scales=sub, d=d, group=g, packed=True)
            else:
                sc_flat = rng.uniform(0.005, 0.02, size=(K // g, O)).astype(np.float32)
                planes = dict(q=packed, scales=sc_flat, group=g, packed=True)
            yield _qmm_case("qmm4_prefill", config, x, planes, np.repeat(sc_flat, g, axis=0) * u)


def sweep_qmm_prefill(rng):
    for N, K, O, g in ((512, 1024, 512, 32), (1024, 512, 256, 32), (512, 512, 256, 16)):
        for mins in (False, True):
            config = f"N{N}K{K}O{O}g{g}{'m' if mins else ''}"
            if rng is None:
                yield Case("qmm_prefill", config)
                continue
            q = rng.integers(-8, 8, size=(K, O)).astype(np.int8)
            sc = rng.uniform(0.005, 0.02, size=(K // g, O)).astype(np.float32)
            mn = (rng.uniform(-0.05, 0.05, size=(K // g, O)).astype(np.float32) if mins
                  else None)
            x = rng.standard_normal((N, K)).astype(np.float32)
            w = np.repeat(sc, g, axis=0) * q
            if mn is not None:
                w = w + np.repeat(mn, g, axis=0)
            yield _qmm_case("qmm_prefill", config, x, dict(q=q, scales=sc, mins=mn, group=g), w)
    for N, K, O, g in ((512, 1024, 256, 16), (1024, 4096, 512, 16)):
        config = f"N{N}K{K}O{O}g{g}h"
        if rng is None:
            yield Case("qmm_prefill", config)
            continue
        q = rng.integers(-32, 32, size=(K, O)).astype(np.int8)
        sub, d, sc_flat = _hier_factor(rng, K, O, g, 0.0005, 0.001)
        x = rng.standard_normal((N, K)).astype(np.float32)
        yield _qmm_case("qmm_prefill", config, x, dict(q=q, scales=sub, d=d, group=g),
                        np.repeat(sc_flat, g, axis=0) * q)


# the reference's sweeps in its order, each with its generator's seed
SWEEPS = ((sweep_flash, 0), (sweep_flash_paged, 1), (sweep_flash_paged_holes, 7),
          (sweep_flash_paged_variants, 11), (sweep_qmm, 2), (sweep_qmm4, 5),
          (sweep_qmm_prefill, 6))


def configs() -> list[tuple[str, str]]:
    """(kernel, config) of every row, in the reference's order; no data."""
    return [(c.kernel, c.config) for sweep, _ in SWEEPS for c in sweep(None)]


def cases():
    """Every row with its data, drawn as the reference draws them."""
    for sweep, seed in SWEEPS:
        yield from sweep(np.random.default_rng(seed))


def check(case: Case, device: torch.device) -> Row:
    """One row through the port on `device`, against the oracle."""
    try:
        got, route = case.run(device)
    except Unsupported as e:
        return Row(case.kernel, case.config, None, "raises", f"raises: {e}")
    except (RuntimeError, ValueError) as e:
        return Row(case.kernel, case.config, None, "FAIL", f"error: {e}")
    e = nmse(got, case.want())
    return Row(case.kernel, case.config, e, "PASS" if e < NMSE_LIMIT else "FAIL", route)


def run(device) -> list[Row]:
    return [check(c, torch.device(device)) for c in cases()]


def device_label(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def to_csv(rows: list[Row], device: torch.device) -> str:
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(COLUMNS)
    label = device_label(device)
    for r in rows:
        w.writerow((r.kernel, r.config, device.type, "" if r.nmse is None else f"{r.nmse:.3e}",
                    r.status, label, r.route))
    return buf.getvalue()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("conformance", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default): the port's kernels; cpu: their plain versions")
    ap.add_argument("--out", default=None,
                    help=f"CSV path (default on the card: {os.path.relpath(DEFAULT_OUT, ROOT)})")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = run(device)
    text = to_csv(rows, device)
    out = args.out or (DEFAULT_OUT if device.type == "cuda" else None)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(text)
    print(text, end="")
    counts = {s: sum(r.status == s for r in rows) for s in ("PASS", "FAIL", "raises")}
    print(f"# {len(rows)} rows on {device.type}: {counts['PASS']} PASS, {counts['FAIL']} FAIL, "
          f"{counts['raises']} raises" + (f"; written to {out}" if out else ""))
    return 1 if counts["FAIL"] else 0


if __name__ == "__main__":
    sys.exit(main())
