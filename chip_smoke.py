#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (llama_cpp_tpu_torch) on one NVIDIA
H100.

    python3 chip_smoke.py        # several minutes

Phases, each of which fails the run:
  1. the card's name and power limit, torch / CUDA / nvcc versions;
  2. build the CUDA kernels from the package's csrc/ (ptxas register and
     shared-memory lines printed);
  3. every kernel at the main path's shapes on the card, held against its
     plain PyTorch version (NMSE < 5e-3), timed by CUDA events (L2 flushed
     before each launch) beside its bound, the plain version and one
     PyTorch library call: the qmm decode kernel (csrc/qmm_decode.cu) at
     every main-path decode shape of an 8B layer and the vocab head and
     N = 1, 2, 4, 8, 16, 32, 63 (and held, untimed, at the TinyLlama
     layer's), then K1 and K2 at N = 1, 8, 32 beside the stream probe's
     rate; the wgmma prefill GEMM (K3, K4) held, untimed, at every
     main-path shape (the 8B and TinyLlama layers) and 64, 65, 200, 512 and
     1023 rows, timed at 64-1023 rows, beside its registers and spills;
     the attention kernel on a bf16 pool and, int8 and bf16, with heads of
     32 and 256 at decode and at a prefill ubatch; the
     indexed-expert kernel at Mixtral-8x7B and Qwen3-30B-A3B expert shapes,
     the slot-table attention kernel at the same depths as the paged one,
     and both attention kernels once with 64-wide heads; the microbenchmark's
     four probe kernels (stream probe, the two nibble unpacks, the tile sweep
     flat and tile by tile) at the gate/up and down shapes of an 8B llama,
     and the tile sweep once, untimed, at every shape and tile the
     microbenchmark entry point launches it at, the vocab head included;
  4. the main paths through the port's entry points, each with the launch
     counters set to 0 before it and read after it, and each held against
     the plain path (Context(kernels=False)) on the prefill's last-token
     logits and greedy ids:
     - a Llama-3-8B-shaped Q4_K_M model (random weights from a seed, full
       width, depth cut to 4 layers), load_model, a Context with a paged
       int8 KV pool, a 2048-token prefill, 32 greedy tokens at B=1 and
       decode_steps_greedy at B=8 and B=32 over 512-token prefills;
     - the same model on the slot-table cache (Context(paged=False)): every
       attention goes through the slot-table kernel;
     - a Mixtral-8x7B-shaped MoE model (full width, depth cut to 2 layers):
       the sort-by-expert prefill, B=1 decode through the indexed-expert
       kernel, batched decode at B=8;
     - a TinyLlama-shaped model with 64-wide heads on both memories;
     every path's qmm calls through the kernels its route names (decode
     rows through the decode kernel, ubatches through the wgmma GEMM; a
     path that launches any other kernel fails), and 32 of 32 greedy ids
     equal to the plain path's;
     - path C, the qmm microbenchmark entry point
       (llama_cpp_tpu_torch.tools.bench_qmm) with every case at full width,
       the 4096 x 128256 vocab head included;
     - path D, the command-line tool (llama_cpp_tpu_torch.tools.cli) on the
       4-layer llama file, text in and text out: greedy, held against
       Context.generate on the encoded prompt, and sampled under a seed twice.
The last two lines are the kernels JSON object and
{"ok": true, "device": {...}}. Without a card, or without the port next to
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
NMSE_LIMIT = 5e-3  # the reference's conformance threshold
SMOKE_LAYERS = 4
CLI_PROMPT = "the cat is on the mat and that was the end of it"
MOE_LAYERS = 2  # experts are 97% of a Mixtral layer's bytes
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def nmse(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float(((got - ref) ** 2).mean() / ((ref ** 2).mean() + 1e-30))


def plane_bytes(w) -> int:
    return sum(t.numel() * t.element_size() for t in (w.q, w.scales, w.mins, w.d, w.dmin)
               if t is not None)


def qmm_phase(torch, timer, qmm, label, weights, n_rows, failures):
    """Hold the qmm kernel against its plain version at each (weight, N)
    and time it, the plain version and the library call; returns {N:
    numbers summed over the weights}."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    for n in n_rows:
        total = res[n] = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                          "max_abs_err": 0.0, "nmse": 0.0, "bytes_s": 0.0, "ops_s": 0.0}
        for wname, w in weights:
            K = w.in_features
            O = w.q.shape[1]
            x = torch.randn((n, K), generator=gen, device="cuda").to(torch.bfloat16)
            got = qmm.qmm(x, w)
            torch.cuda.synchronize()
            ref = qmm.qmm_plain(x, w)
            err = nmse(got, ref)
            mae = float((got - ref).abs().max())
            if not err < NMSE_LIMIT or not torch.isfinite(got).all():
                failures.append(f"{label} {wname} N={n}: NMSE {err}")
            ms = timer(lambda: qmm.qmm(x, w))
            wd = w.dequant(torch.bfloat16)
            plain_ms = timer(lambda: qmm.qmm_plain(x, w), reps=3)
            lib_ms = timer(lambda: torch.matmul(x, wd))
            del wd
            nbytes = n * K * 2 + plane_bytes(w) + n * O * 4
            flops = 2.0 * n * K * O
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
            bound = max(bytes_s, ops_s) * 1e3
            name = qmm.kernel_name(w, n)
            log(f"  {label:24s} {wname:12s} N={n:4d} K={K:5d} O={O:6d} [{name}] "
                f"nmse={err:.2e} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={bound:.4f} ({'bytes' if bytes_s > ops_s else 'operations'})")
            total["ms"] += ms
            total["plain_ms"] += plain_ms
            total["library_ms"] += lib_ms
            total["bound_ms"] += bound
            total["bytes_s"] += bytes_s
            total["ops_s"] += ops_s
            total["max_abs_err"] = max(total["max_abs_err"], mae)
            total["nmse"] = max(total["nmse"], err)
        total["bound_by"] = "bytes" if total["bytes_s"] > total["ops_s"] else "operations"
    return res


DECODE_ROWS = (1, 2, 4, 8, 16, 32, 63)


def decode_sweep(torch, timer, qmm, weights, failures):
    """The decode kernel one shape at a time at N = 1, 2, 4, 8, 16, 32, 63,
    each launch held against the plain version. Prints, per (shape, N), its
    time, the bound, the library call and the share of the bound; returns
    each shape's GB/s of plane bytes."""
    rates = {}
    for wname, w in weights:
        r = qmm_phase(torch, timer, qmm, "decode", [(wname, w)], DECODE_ROWS, failures)
        for n in DECODE_ROWS:
            log(f"  decode {wname:12s} N={n:2d}: {r[n]['ms']:.4f} ms, bound "
                f"{r[n]['bound_ms']:.4f}, library {r[n]['library_ms']:.4f} "
                f"({r[n]['ms'] / r[n]['library_ms']:.2f}x), share of bound "
                f"{r[n]['bound_ms'] / r[n]['ms']:.3f}")
        rates[wname] = {n: plane_bytes(w) / r[n]["ms"] / 1e6 for n in DECODE_ROWS}
    return rates


def held_phase(torch, qmm, label, weights, n_rows, failures):
    """The qmm kernel against its plain version at each (weight, N),
    untimed; returns the largest NMSE and absolute error."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"nmse": 0.0, "max_abs_err": 0.0}
    for wname, w in weights:
        errs = []
        for n in n_rows:
            x = torch.randn((n, w.in_features), generator=gen, device="cuda").to(torch.bfloat16)
            got = qmm.qmm(x, w)
            torch.cuda.synchronize()
            ref = qmm.qmm_plain(x, w)
            err = nmse(got, ref)
            errs.append(err)
            if not err < NMSE_LIMIT or not torch.isfinite(got).all():
                failures.append(f"{label} {wname} N={n}: NMSE {err}")
            worst["nmse"] = max(worst["nmse"], err)
            worst["max_abs_err"] = max(worst["max_abs_err"], float((got - ref).abs().max()))
        log(f"  {label:24s} {wname:18s} K={w.in_features:5d} O={w.q.shape[1]:6d} "
            f"[{qmm.kernel_name(w, n_rows[0])}] N={list(n_rows)}: NMSE "
            + " ".join(f"{e:.2e}" for e in errs))
    return worst


def attn_case(torch, B, G, T, depth, page=512, Hkv=8, D=128, seed=0, kv_dtype=None):
    """Random pool (int8 with row scales, or bf16 without) with each batch
    row's `depth` cached positions plus its T new rows at positions depth ..
    depth+T-1."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_tok = depth + T
    mp = -(-n_tok // page) + 1
    n_pages = B * mp + 1
    S_pool = n_pages * page
    if kv_dtype is torch.bfloat16:
        k = (torch.randn((Hkv, S_pool, D), generator=gen, device="cuda")).to(torch.bfloat16)
        v = (torch.randn((Hkv, S_pool, D), generator=gen, device="cuda")).to(torch.bfloat16)
        ks = vs = None
    else:
        k = torch.randint(-127, 128, (Hkv, S_pool, D), generator=gen, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (Hkv, S_pool, D), generator=gen, device="cuda",
                          dtype=torch.int8)
        ks = torch.rand((Hkv, S_pool), generator=gen, device="cuda") * 0.02 + 0.005
        vs = torch.rand((Hkv, S_pool), generator=gen, device="cuda") * 0.02 + 0.005
    pos = torch.full((S_pool,), -1, dtype=torch.int32, device="cuda")
    table = torch.full((B, mp), n_pages - 1, dtype=torch.int32, device="cuda")
    for b in range(B):
        for j in range(-(-n_tok // page)):
            pid = b * mp + j
            table[b, j] = pid
            cnt = min(page, n_tok - j * page)
            pos[pid * page: pid * page + cnt] = torch.arange(
                j * page, j * page + cnt, dtype=torch.int32, device="cuda")
    q = (torch.randn((B, Hkv, G * T, D), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    rp = (depth + torch.arange(T, device="cuda", dtype=torch.int32)).repeat(G)
    row_pos = rp[None, :].expand(B, G * T).contiguous()
    return dict(q=q, k=k, v=v, row_pos=row_pos, pos=pos, table_b=table, k_scale=ks,
                v_scale=vs, page=page)


def attn_measure(torch, timer, label, run, run_plain, q, kd, vd, cp, rp, kv_elem, quantized,
                 failures):
    """Hold an attention kernel (run) against its plain version (run_plain)
    and time both, beside SDPA on the gathered, dequantized K/V kd, vd
    [B, Hkv, S, D] with the same mask (library yardstick, timed only).
    cp [B, S] are the columns' position labels, rp [B, R] the rows'.
    Bound: q, the K/V rows (and scales) and position labels that some row of
    the batch row can see (pos >= 0 and <= the row's largest position), out;
    the operations of the unmasked (row, column) pairs."""
    import torch.nn.functional as F

    B, Hkv, R, D = q.shape
    sm = 1.0 / D ** 0.5
    got = run(sm)
    torch.cuda.synchronize()
    ref = run_plain(sm)
    valid = rp >= 0
    g, r = got.transpose(1, 2)[valid], ref.transpose(1, 2)[valid]
    err = nmse(g, r)
    mae = float((g - r).abs().max())
    if not err < NMSE_LIMIT or not torch.isfinite(g).all():
        failures.append(f"{label}: NMSE {err}")
    ms = timer(lambda: run(sm))
    plain_ms = timer(lambda: run_plain(sm), reps=3)
    mask = ((cp[:, None, :] >= 0) & (cp[:, None, :] <= rp[:, :, None]))[:, None]
    lib_ms = timer(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask, scale=sm))
    kv_rows = int(((cp >= 0) & (cp <= rp.max(dim=1).values[:, None])).sum())
    row_bytes = 2 * D * kv_elem + (8 if quantized else 0)
    nbytes = q.numel() * 2 + kv_rows * (Hkv * row_bytes + 4) + q.numel() * 4
    flops = 4.0 * D * Hkv * float(mask.sum())
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else "operations"
    log(f"  {label:38s} B={B} R={R} D={D} nmse={err:.2e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": bound_by, "max_abs_err": mae, "nmse": err}


def attn_phase(torch, timer, fa, label, case, failures):
    """The paged kernel at one case of attn_case."""
    args = {k: v for k, v in case.items() if k != "page"}
    q, page, table = case["q"], case["page"], case["table_b"]
    B = q.shape[0]
    rows = (table.long()[:, :, None] * page + torch.arange(page, device="cuda")).reshape(B, -1)
    quantized = case["k_scale"] is not None
    kd = case["k"][:, rows].float()
    vd = case["v"][:, rows].float()
    if quantized:
        kd = kd * case["k_scale"][:, rows][..., None]
        vd = vd * case["v_scale"][:, rows][..., None]
    kd = kd.permute(1, 0, 2, 3).to(torch.bfloat16).contiguous()
    vd = vd.permute(1, 0, 2, 3).to(torch.bfloat16).contiguous()
    return attn_measure(
        torch, timer, label,
        lambda sm: fa.flash_attention_paged(**args, sm_scale=sm, page=page),
        lambda sm: fa.flash_attention_paged_plain(**args, sm_scale=sm, page=page),
        q, kd, vd, case["pos"][rows], case["row_pos"], case["k"].element_size(), quantized,
        failures)


def slots_case(torch, B, G, T, depth, n_seqs=8, S=5120, Hkv=8, D=128, seed=0, kv_dtype=None):
    """Random slot-table cache (int8 with row scales, or bf16) of n_seqs
    sequences of S slots; batch row b reads sequence n_seqs - 1 - b, which
    holds `depth` cached positions plus the T new rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_tok = depth + T
    if kv_dtype is torch.bfloat16:
        k = torch.randn((n_seqs, Hkv, S, D), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((n_seqs, Hkv, S, D), generator=gen, device="cuda").to(torch.bfloat16)
        ks = vs = None
    else:
        k = torch.randint(-127, 128, (n_seqs, Hkv, S, D), generator=gen, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (n_seqs, Hkv, S, D), generator=gen, device="cuda",
                          dtype=torch.int8)
        ks = torch.rand((n_seqs, Hkv, S), generator=gen, device="cuda") * 0.02 + 0.005
        vs = torch.rand((n_seqs, Hkv, S), generator=gen, device="cuda") * 0.02 + 0.005
    seq_idx = (n_seqs - 1 - torch.arange(B, device="cuda")).to(torch.int32)
    pos = torch.full((n_seqs, S), -1, dtype=torch.int32, device="cuda")
    pos[seq_idx.long(), :n_tok] = torch.arange(n_tok, dtype=torch.int32, device="cuda")
    q = (torch.randn((B, Hkv, G * T, D), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    rp = (depth + torch.arange(T, device="cuda", dtype=torch.int32)).repeat(G)
    return dict(q=q, k=k, v=v, row_pos=rp[None, :].expand(B, G * T).contiguous(), col_pos=pos,
                seq_idx=seq_idx, k_scale=ks, v_scale=vs)


def slots_phase(torch, timer, fa, label, case, failures):
    """The slot-table kernel at one case of slots_case."""
    sel = case["seq_idx"].long()
    quantized = case["k_scale"] is not None
    kd, vd = case["k"][sel].float(), case["v"][sel].float()
    if quantized:
        kd = kd * case["k_scale"][sel][..., None]
        vd = vd * case["v_scale"][sel][..., None]
    return attn_measure(
        torch, timer, label,
        lambda sm: fa.flash_attention(**case, sm_scale=sm),
        lambda sm: fa.flash_attention_plain(**case, sm_scale=sm),
        case["q"], kd.to(torch.bfloat16), vd.to(torch.bfloat16), case["col_pos"][sel],
        case["row_pos"], case["k"].element_size(), quantized, failures)


def expert_stack(torch, tq, GGMLType, E, K, O, q4: bool, seed: int):
    """Random stacked expert planes on the card, as the loader lays them out:
    Q4_K-like (values 0..15, groups of 32, scales and mins) or Q6_K-like
    (values -32..31, groups of 16, scales only)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = 32 if q4 else 16
    lo, hi = (0, 16) if q4 else (-32, 32)
    q = torch.randint(lo, hi, (E, K, O), generator=gen, device="cuda", dtype=torch.int8)
    sc = torch.rand((E, K // g, O), generator=gen, device="cuda") * 0.02 + 0.001
    mn = -(torch.rand((E, K // g, O), generator=gen, device="cuda") * 0.1) if q4 else None
    return tq.QuantTensor(q=q, scales=sc, mins=mn, group=g,
                          ggml_type=int(GGMLType.Q4_K if q4 else GGMLType.Q6_K),
                          transposed=True)


def expert_phase(torch, timer, qe, label, w, R, failures, seed=0, pool=None):
    """Hold the indexed-expert kernel against its plain version at R rows
    with random expert ids (distinct for R <= E, as a token's top-k are; with
    `pool`, drawn from the first `pool` experts, so that rows share experts
    as the top-k of several tokens do).
    Library yardstick: torch.bmm on the pre-dequantized gathered experts.
    Bound: x, ids, each distinct expert's planes once, out."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    E, K, O = w.q.shape
    x = torch.randn((R, K), generator=gen, device="cuda").to(torch.bfloat16)
    if pool is not None:
        ids = torch.randint(0, pool, (R,), generator=gen, device="cuda", dtype=torch.int32)
    elif R <= E:
        ids = torch.randperm(E, generator=gen, device="cuda")[:R].to(torch.int32)
    else:
        ids = torch.randint(0, E, (R,), generator=gen, device="cuda", dtype=torch.int32)
    got = qe.qmm_expert(x, ids, w)
    torch.cuda.synchronize()
    ref = qe.qmm_expert_plain(x, ids, w)
    err = nmse(got, ref)
    mae = float((got - ref).abs().max())
    if not err < NMSE_LIMIT or not torch.isfinite(got).all():
        failures.append(f"{label} R={R}: NMSE {err}")
    ms = timer(lambda: qe.qmm_expert(x, ids, w))
    plain_ms = timer(lambda: qe.qmm_expert_plain(x, ids, w), reps=3)
    g = w.group
    wd = w.q[ids.long()].to(torch.bfloat16).reshape(R, K // g, g, O) * w.scales[ids.long()].to(
        torch.bfloat16)[:, :, None, :]
    if w.mins is not None:
        wd = wd + w.mins[ids.long()].to(torch.bfloat16)[:, :, None, :]
    wd = wd.reshape(R, K, O)
    x3 = x[:, None, :]
    lib_ms = timer(lambda: torch.bmm(x3, wd))
    del wd
    n_distinct = int(torch.unique(ids).numel())
    per_expert = K * O + (K // g) * O * 4 * (2 if w.mins is not None else 1)
    nbytes = R * K * 2 + R * 4 + n_distinct * per_expert + R * O * 4
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, 2.0 * R * K * O / BF16_FLOPS
    bound = max(bytes_s, ops_s) * 1e3
    log(f"  {label:30s} R={R:3d} E={E:3d} K={K:5d} O={O:5d} experts read {n_distinct:3d} "
        f"nmse={err:.2e} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
        f"bound_ms={bound:.4f} ({'bytes' if bytes_s > ops_s else 'operations'})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bytes_s": bytes_s, "ops_s": ops_s, "max_abs_err": mae, "nmse": err}


BENCH_TILES = ((128, 512), (256, 1024), (512, 2048))  # (to, tk); the last is the variant's
BENCH_TILES_4D = ((256, 1024), (512, 2048))


def bench_phase(torch, timer, qb, name, K, O, failures):
    """The microbenchmark's probe kernels at one shape (8 rows of x, groups
    of 32), each held against its plain version; returns {counter name:
    numbers}. Bound: the plane bytes (x and out too) over the memory rate,
    against the operations over the bf16 peak. Library yardsticks, timed
    only: a device-to-device copy of the three planes for the stream probe,
    torch.matmul on the pre-dequantized bf16 weight for the products."""
    gen = torch.Generator(device="cuda").manual_seed(K + O)
    N, G = 8, 32
    qp = torch.randint(0, 256, (K // 2, O), generator=gen, device="cuda",
                       dtype=torch.uint8).view(torch.int8)
    sc = torch.randn((K // G, O), generator=gen, device="cuda") * 0.05
    mn = torch.randn((K // G, O), generator=gen, device="cuda") * 0.1
    x = torch.randn((N, K), generator=gen, device="cuda").to(torch.bfloat16)
    planes = (qp, sc, mn)
    pbytes = sum(t.numel() * t.element_size() for t in planes)
    res = {}

    def line(label, r):
        log(f"  {label:34s} {name:7s} K={K:5d} O={O:5d} err={r['max_abs_err']:.2e} "
            f"nmse={r['nmse']:.2e} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"-> {pbytes / r['ms'] / 1e6:.0f} GB/s of plane bytes")

    # B1
    got = qb.stream_planes(x, *planes, group=G)
    torch.cuda.synchronize()
    ref = qb.stream_planes_plain(x, *planes, group=G)
    if not torch.allclose(got, ref, rtol=1e-5, atol=1e-4):
        failures.append(f"B1 stream_planes {name}: differs from plain by "
                        f"{float((got - ref).abs().max())}")
    copies = [torch.empty_like(t) for t in planes]
    ms = timer(lambda: qb.stream_planes(x, *planes, group=G))

    def copy_planes():
        for dst, src in zip(copies, planes):
            dst.copy_(src)

    r = res["stream_planes"] = {
        "ms": ms, "plain_ms": timer(lambda: qb.stream_planes_plain(x, *planes, group=G), reps=3),
        "library_ms": timer(copy_planes), "bound_by": "bytes",
        "bound_ms": (pbytes + got.numel() * 4) / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": float((got - ref).abs().max()), "nmse": nmse(got, ref)}
    line("B1 stream_planes", r)
    del copies
    if pbytes / (ms * 1e-3) > 1.05 * HBM_BYTES_PER_S:
        failures.append(f"B1 stream_planes {name}: {pbytes / ms / 1e6:.0f} GB/s is over the "
                        "card's memory rate: plane bytes were skipped")

    # B2-B4
    ref = qb.qmm4_variant_plain(x, *planes, group=G)
    plain_ms = timer(lambda: qb.qmm4_variant_plain(x, *planes, group=G), reps=3)
    u = qp.view(torch.uint8)
    wd = torch.stack((u & 0xF, u >> 4), dim=1).reshape(K // G, G, O).float()
    wd = (wd * sc[:, None, :] + mn[:, None, :]).reshape(K, O).to(torch.bfloat16)
    lib_ms = timer(lambda: torch.matmul(x, wd))
    del wd, u
    nbytes = N * K * 2 + pbytes + N * O * 4
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, 2.0 * N * K * O / BF16_FLOPS
    common = {"plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": max(bytes_s, ops_s) * 1e3,
              "bound_by": "bytes" if bytes_s > ops_s else "operations"}

    def held(label, fn):
        out = fn()
        torch.cuda.synchronize()
        err = nmse(out, ref)
        if not err < NMSE_LIMIT or not torch.isfinite(out).all():
            failures.append(f"{label} {name}: NMSE {err}")
        r = {"ms": timer(fn), "max_abs_err": float((out - ref).abs().max()), "nmse": err,
             **common}
        line(label, r)
        return out, r

    outs = {}
    for unpack in ("fp", "i16"):
        outs[unpack], res[f"qmm4_variant/{unpack}"] = held(
            f"B2 qmm4_variant {unpack}",
            lambda: qb.qmm4_variant(x, *planes, group=G, unpack=unpack))
    if not torch.equal(outs["fp"], outs["i16"]):
        failures.append(f"B2 {name}: the two unpacks differ by "
                        f"{float((outs['fp'] - outs['i16']).abs().max())}")
    b2 = outs["i16"]
    for key, label, tiles in (("qmm_tiled", "B3 qmm_tiled", BENCH_TILES),
                              ("qmm_tiled4d", "B4 qmm_tiled4d", BENCH_TILES_4D)):
        runs = []
        for to, tk in tiles:
            if key == "qmm_tiled":
                def fn():
                    return qb.qmm_tiled(x, *planes, group=G, tn=8, to=to, tk=tk)
            else:
                tiled = qb.tile_planes_4d(*planes, to, tk)

                def fn():
                    return qb.qmm_tiled4d(x, *tiled, group=G, to=to, tk=tk)
            out, r = held(f"{label} to={to} tk={tk}", fn)
            if not nmse(out, b2) < 1e-6:
                failures.append(f"{label} {name} to={to} tk={tk}: NMSE {nmse(out, b2)} from B2")
            r["tile"] = [8, to, tk]
            runs.append(r)
        # the fastest tile's times go to the JSON line, the largest error of any
        res[key] = {**min(runs, key=lambda r: r["ms"]),
                    "max_abs_err": max(r["max_abs_err"] for r in runs),
                    "nmse": max(r["nmse"] for r in runs)}
    return res


def bench_tiles_phase(torch, qb, tool, failures):
    """The tile sweep at every (shape, tile) the microbenchmark entry point
    launches it at: flat (its cases `tiles` and `shapes`) and tile by tile
    (its case `4d`), the four decode shapes and the 4096 x 128256 head. Each
    launch is held against the plain version (NMSE < 5e-3) and against the
    shape's first tile (NMSE < 1e-6: one function whatever the tile); nothing
    is timed. Returns {counter name: tiles held, largest errors}."""
    N, G = tool.ROWS, tool.GROUP
    sweep = [(to, tk) for _, to, tk in tool.REFERENCE_TILES + tool.CARD_TILES]
    res = {key: {"held": 0, "max_abs_err": 0.0, "nmse": 0.0}
           for key in ("qmm_tiled", "qmm_tiled4d")}
    for name, K, O in tool.DECODE_SHAPES + (tool.HEAD,):
        gen = torch.Generator(device="cuda").manual_seed(K + O + 1)
        qp = torch.randint(0, 256, (K // 2, O), generator=gen, device="cuda",
                           dtype=torch.uint8).view(torch.int8)
        sc = torch.randn((K // G, O), generator=gen, device="cuda") * 0.05
        mn = torch.randn((K // G, O), generator=gen, device="cuda") * 0.1
        x = torch.randn((N, K), generator=gen, device="cuda").to(torch.bfloat16)
        ref = qb.qmm4_variant_plain(x, qp, sc, mn, group=G)
        flat = [] if name == tool.HEAD[0] else tool.shape_tiles(O)
        if (K, O) == tool.GATEUP:
            flat = flat + sweep  # a tile of both lists is launched by both cases
        first = None
        worst = 0.0
        for key, tiles in (("qmm_tiled", flat), ("qmm_tiled4d", tool.tiles_4d(O))):
            r = res[key]
            for to, tk in tiles:
                if qb.tile_unsupported(N, to, tk, K, O):
                    continue
                if key == "qmm_tiled":
                    out = qb.qmm_tiled(x, qp, sc, mn, group=G, tn=N, to=to, tk=tk)
                else:
                    out = qb.qmm_tiled4d(x, *qb.tile_planes_4d(qp, sc, mn, to, tk), group=G,
                                         to=to, tk=tk)
                torch.cuda.synchronize()
                err = nmse(out, ref)
                first = out if first is None else first
                if (not err < NMSE_LIMIT or not torch.isfinite(out).all()
                        or not nmse(out, first) < 1e-6):
                    failures.append(f"{key} {name} K={K} O={O} to={to} tk={tk}: NMSE {err} from "
                                    f"plain, {nmse(out, first)} from the shape's first tile")
                r["held"] += 1
                r["nmse"] = max(r["nmse"], err)
                r["max_abs_err"] = max(r["max_abs_err"], float((out - ref).abs().max()))
                worst = max(worst, err)
        log(f"  tiles held at {name:7s} K={K:5d} O={O:6d}: worst NMSE {worst:.2e}; so far "
            f"{res['qmm_tiled']['held']} flat, {res['qmm_tiled4d']['held']} tile by tile")
        del qp, sc, mn, x, ref, first
        torch.cuda.empty_cache()
    return res


def profile_decode(torch, qmm, ctx, steps: int):
    """Where a B=1 decode step's time goes: `steps` decode_one calls of
    sequence 0 timed by the host clock, with the host time spent inside the
    qmm wrapper (planning, checks and the launch) summed beside it, then as
    many steps under torch.profiler for the device time by kernel (the
    profiler's own start-up cost makes its window's wall time meaningless,
    so the share uses the first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wrapper = qmm.qmm
    in_qmm = [0.0, 0]

    def timed_qmm(x, w):
        t = time.perf_counter()
        y = wrapper(x, w)
        in_qmm[0] += time.perf_counter() - t
        in_qmm[1] += 1
        return y

    tok = 1
    torch.cuda.synchronize()
    qmm.qmm = timed_qmm
    try:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = int(ctx.decode_one(tok, seq=0).argmax())
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        qmm.qmm = wrapper
    log(f"B=1 decode host time in the qmm wrapper: {in_qmm[0] * 1e3 / steps:.3f} ms a step over "
        f"{in_qmm[1] / steps:.0f} calls ({in_qmm[0] * 1e6 / max(in_qmm[1], 1):.1f} us a call) "
        f"of {wall_ms:.3f} ms wall")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok = int(ctx.decode_one(tok, seq=0).argmax())
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    if dev_ms <= 0:
        log(f"profile of B=1 decode: {wall_ms:.3f} ms wall per step; device time not "
            "measured (the profiler saw no kernels)")
        return
    log(f"profile of B=1 decode (depth {int(ctx.seq_len[0])}): {wall_ms:.3f} ms wall per step, "
        f"{dev_ms:.3f} ms device ({launches:.0f} kernel launches), device busy share "
        f"{dev_ms / wall_ms:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.4f} ms/step  x{e.count // steps:<4d} "
            f"{e.key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from llama_cpp_tpu_torch.gguf.constants import GGMLType
        from llama_cpp_tpu_torch.models.loader import load_model
        from llama_cpp_tpu_torch.ops import qtensor
        from llama_cpp_tpu_torch.ops.kernels import (build, flash_attn, qmm, qmm_bench,
                                                     qmm_expert)
        from llama_cpp_tpu_torch.ops.qtensor import load_weight, pad_out_features
        from llama_cpp_tpu_torch.runtime.context import Context
        from llama_cpp_tpu_torch.testing import (make_bench_llama_gguf, make_bench_moe_gguf,
                                                 synth_quant_bytes)
        from llama_cpp_tpu_torch.tools import bench_qmm as bench_qmm_tool
        from llama_cpp_tpu_torch.tools import cli as cli_tool
        from llama_cpp_tpu_torch.utils.timing import Timer
    except ImportError as e:
        print(f"chip_smoke: the port package is not next to this script ({e})",
              file=sys.stderr)
        return 2
    import numpy as np

    card = gpu_line()
    log(f"card: {card}")
    nvcc_v = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                            text=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc: {nvcc_v}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- phase 2: build --------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for src, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"  [{src}] {line.strip()}")

    # -- phase 3: kernels against their plain versions ---------------------
    failures: list[str] = []
    timer = Timer()
    rng = np.random.default_rng(0)
    E, FF, KVD, V = 4096, 14336, 1024, 128256

    def weight(t, O, K):
        return load_weight(np.frombuffer(synth_quant_bytes(rng, O * K, t), np.uint8), t, (O, K),
                           transpose=True, device="cuda")

    q4 = [("attn_qk", weight(GGMLType.Q4_K, E + KVD, E)),
          ("attn_output", weight(GGMLType.Q4_K, E, E)),
          ("ffn_gateup", weight(GGMLType.Q4_K, 2 * FF, E))]
    q6 = [("attn_v", weight(GGMLType.Q6_K, KVD, E)),
          ("ffn_down", weight(GGMLType.Q6_K, E, FF))]
    head = [("output", pad_out_features(weight(GGMLType.Q6_K, V, E)))]
    assert all(w.packed and w.hier for _, w in q4) and all(w.hier and not w.packed
                                                          for _, w in q6 + head)
    log("the decode kernel at every main-path decode shape and the head (each launch held "
        "against plain):")
    decode_rates = decode_sweep(torch, timer, qmm, q4 + q6 + head, failures)
    log("kernels vs plain at the main path's shapes (layer sums go to the JSON line):")
    q4r = qmm_phase(torch, timer, qmm, "K1 qmm4_planes", q4, (1, 8, 32), failures)
    q4p = qmm_phase(torch, timer, qmm, "K3 qmm4_planes_prefill", q4, (512,), failures)
    q6r = qmm_phase(torch, timer, qmm, "K2 qmm_planes", q6, (1, 8, 32), failures)
    hr = qmm_phase(torch, timer, qmm, "K2 qmm_planes (head)", head, (1, 8, 32), failures)
    q6p = qmm_phase(torch, timer, qmm, "K4 qmm_planes_prefill", q6, (512,), failures)
    for lay, r in (("K1", q4r), ("K2", q6r), ("K2 head", hr)):
        log(f"{lay} layer sums ({card}): " + "; ".join(
            f"N={n} {r[n]['ms']:.4f} ms, library {r[n]['library_ms']:.4f} "
            f"({r[n]['ms'] / r[n]['library_ms']:.2f}x), bound {r[n]['bound_ms']:.4f} (share "
            f"{r[n]['bound_ms'] / r[n]['ms']:.3f}, half the bound "
            f"{'met' if r[n]['ms'] <= 2 * r[n]['bound_ms'] else 'not met'})" for n in r))
    tiny = [("tinyllama attn_qk", weight(GGMLType.Q4_K, 2048 + 256, 2048)),
            ("tinyllama attn_output", weight(GGMLType.Q4_K, 2048, 2048)),
            ("tinyllama ffn_gateup", weight(GGMLType.Q4_K, 2 * 5632, 2048)),
            ("tinyllama attn_v", weight(GGMLType.Q6_K, 256, 2048)),
            ("tinyllama ffn_down", weight(GGMLType.Q6_K, 2048, 5632))]
    log("K1, K2 decode kernel at the TinyLlama layer's shapes (held, not timed):")
    for r, ws in ((q4r, tiny[:3]), (q6r, tiny[3:])):
        worst = held_phase(torch, qmm, "K1/K2 decode", ws, DECODE_ROWS, failures)
        r[32]["max_abs_err"] = max(r[32]["max_abs_err"], worst["max_abs_err"])
        r[32]["nmse"] = max(r[32]["nmse"], worst["nmse"])
    log("K3, K4 wgmma GEMM at every main-path shape and ragged ubatch (held, not timed):")
    held = held_phase(torch, qmm, "K3/K4 wgmma", q4 + q6 + tiny, (64, 65, 200, 512, 1023),
                      failures)
    for r in (q4p[512], q6p[512]):
        r["max_abs_err"] = max(r["max_abs_err"], held["max_abs_err"])
        r["nmse"] = max(r["nmse"], held["nmse"])
    regs = [ln.strip() for ln in build.BUILD_LOGS.get("qmm_prefill.cu", "").splitlines()
            if "Used" in ln or "spill" in ln]
    log("wgmma kernel (4 instantiations, then the split sum), ptxas: " + "; ".join(regs))
    del q4, q6, head, tiny
    # one JSON entry per (TPU kernel, CUDA kernel): the decode kernel at the
    # B=32 step with its N = 1, 8, 32 rows beside, the wgmma GEMM at the
    # ubatch
    def with_rows(r):
        return {**r[32], "rows": {n: {k: r[n][k] for k in ("ms", "bound_ms", "library_ms")}
                                  for n in r}}

    res = {"qmm4_planes/decode": with_rows(q4r), "qmm_planes/decode": with_rows(q6r),
           "qmm4_planes_prefill/wgmma": q4p[512], "qmm_planes_prefill/wgmma": q6p[512]}
    res["flash_attention_paged"] = attn_phase(
        torch, timer, flash_attn, "K5 decode B=1 d=2048",
        attn_case(torch, B=1, G=4, T=1, depth=2048), failures)
    attn_phase(torch, timer, flash_attn, "K5 decode B=8 d=512",
               attn_case(torch, B=8, G=4, T=1, depth=512), failures)
    attn_phase(torch, timer, flash_attn, "K5 decode B=32 d=512",
               attn_case(torch, B=32, G=4, T=1, depth=512), failures)
    attn_phase(torch, timer, flash_attn, "K5 prefill ubatch 4 of 2048",
               attn_case(torch, B=1, G=4, T=512, depth=1536), failures)
    attn_phase(torch, timer, flash_attn, "K5 bf16 pool decode B=1 d=2048",
               attn_case(torch, B=1, G=4, T=1, depth=2048, kv_dtype=torch.bfloat16), failures)
    attn_phase(torch, timer, flash_attn, "K5 bf16 pool prefill ubatch 4 of 2048",
               attn_case(torch, B=1, G=4, T=512, depth=1536, kv_dtype=torch.bfloat16),
               failures)
    attn_phase(torch, timer, flash_attn, "K5 heads of 64, decode B=8 d=512",
               attn_case(torch, B=8, G=16, T=1, depth=512, D=64), failures)
    for D in (32, 256):
        for dt, name in ((None, "int8"), (torch.bfloat16, "bf16")):
            attn_phase(torch, timer, flash_attn, f"K5 heads of {D}, {name}, decode B=8 d=512",
                       attn_case(torch, B=8, G=4, T=1, depth=512, D=D, kv_dtype=dt), failures)
            attn_phase(torch, timer, flash_attn, f"K5 heads of {D}, {name}, ubatch 4 of 2048",
                       attn_case(torch, B=1, G=4, T=512, depth=1536, D=D, kv_dtype=dt),
                       failures)
    torch.cuda.empty_cache()
    log("K6 slot-table attention (cache [8 seqs, 8 heads, 5120 slots, D]):")
    res["flash_attention"] = slots_phase(
        torch, timer, flash_attn, "K6 decode B=1 d=2048",
        slots_case(torch, B=1, G=4, T=1, depth=2048), failures)
    slots_phase(torch, timer, flash_attn, "K6 decode B=8 d=512",
                slots_case(torch, B=8, G=4, T=1, depth=512), failures)
    slots_phase(torch, timer, flash_attn, "K6 prefill ubatch 4 of 2048",
                slots_case(torch, B=1, G=4, T=512, depth=1536), failures)
    slots_phase(torch, timer, flash_attn, "K6 bf16 cache decode B=1 d=2048",
                slots_case(torch, B=1, G=4, T=1, depth=2048, kv_dtype=torch.bfloat16), failures)
    slots_phase(torch, timer, flash_attn, "K6 bf16 cache decode B=8 d=512",
                slots_case(torch, B=8, G=4, T=1, depth=512, kv_dtype=torch.bfloat16), failures)
    slots_phase(torch, timer, flash_attn, "K6 bf16 cache prefill ubatch 4 of 2048",
                slots_case(torch, B=1, G=4, T=512, depth=1536, kv_dtype=torch.bfloat16),
                failures)
    slots_phase(torch, timer, flash_attn, "K6 heads of 64, decode B=8 d=512",
                slots_case(torch, B=8, G=16, T=1, depth=512, D=64), failures)
    for D in (32, 256):
        for dt, name in ((None, "int8"), (torch.bfloat16, "bf16")):
            slots_phase(torch, timer, flash_attn, f"K6 heads of {D}, {name}, decode B=8 d=512",
                        slots_case(torch, B=8, G=4, T=1, depth=512, D=D, kv_dtype=dt), failures)
            slots_phase(torch, timer, flash_attn, f"K6 heads of {D}, {name}, ubatch 4 of 2048",
                        slots_case(torch, B=1, G=4, T=512, depth=1536, D=D, kv_dtype=dt),
                        failures)
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    log("K7 indexed-expert product (Mixtral-8x7B: 8 experts; Qwen3-30B-A3B: 128 experts):")
    mix = []
    for wname, K, O, q4 in (("ffn_gate_exps", E, FF, True), ("ffn_up_exps", E, FF, True),
                            ("ffn_down_exps", FF, E, False)):
        w = expert_stack(torch, qtensor, GGMLType, 8, K, O, q4, seed=len(mix))
        mix.append(expert_phase(torch, timer, qmm_expert, f"K7 mixtral {wname}", w, 2, failures))
        del w
    torch.cuda.empty_cache()
    # one JSON entry: a Mixtral layer's three expert products at B=1 (R=2)
    res["qmm_planes_expert"] = {
        **{k: sum(r[k] for r in mix) for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "max_abs_err": max(r["max_abs_err"] for r in mix), "nmse": max(r["nmse"] for r in mix),
        "bound_by": ("bytes" if sum(r["bytes_s"] for r in mix) > sum(r["ops_s"] for r in mix)
                     else "operations")}
    for wname, K, O, q4 in (("ffn_gate_exps", 2048, 768, True),
                            ("ffn_down_exps", 768, 2048, False)):
        w = expert_stack(torch, qtensor, GGMLType, 128, K, O, q4, seed=7)
        for R in (8, 64):
            expert_phase(torch, timer, qmm_expert, f"K7 qwen3-moe {wname}", w, R, failures)
        expert_phase(torch, timer, qmm_expert, f"K7 qwen3-moe {wname} shared", w, 64, failures,
                     pool=16)
        del w
    torch.cuda.empty_cache()
    log("B1-B4, the microbenchmark's probe kernels (8 rows of x, groups of 32; the JSON line "
        "takes the gate/up shape, B3 and B4 at their fastest tile):")
    bench_res = bench_phase(torch, timer, qmm_bench, "gateup", E, 2 * FF, failures)
    b1 = bench_res["stream_planes"]
    log(f"stream probe B1 at 4096 x 28672 (same call): {b1['bound_ms'] / b1['ms']:.3f} of "
        f"3.35 TB/s; the decode kernel in GB/s of plane bytes at N = 1, 8, 32: " + "; ".join(
            f"{wname} " + "/".join(f"{r[n]:.0f}" for n in (1, 8, 32))
            for wname, r in decode_rates.items()))
    down_res = bench_phase(torch, timer, qmm_bench, "down", FF, E, failures)
    for key, r in bench_res.items():
        r["max_abs_err"] = max(r["max_abs_err"], down_res[key]["max_abs_err"])
        r["nmse"] = max(r["nmse"], down_res[key]["nmse"])
    log("B3, B4 at every shape and tile of the microbenchmark's sweeps (held, not timed):")
    t0 = time.perf_counter()
    tiles_res = bench_tiles_phase(torch, qmm_bench, bench_qmm_tool, failures)
    log(f"  {sum(r['held'] for r in tiles_res.values())} tiles held in "
        f"{time.perf_counter() - t0:.1f} s")
    for key, r in tiles_res.items():
        bench_res[key]["max_abs_err"] = max(bench_res[key]["max_abs_err"], r["max_abs_err"])
        bench_res[key]["nmse"] = max(bench_res[key]["nmse"], r["nmse"])
    res.update(bench_res)
    torch.cuda.empty_cache()
    if failures:
        for f in failures:
            log(f"FAIL {f}")
        return 1

    # -- phase 4: the main paths ---------------------------------------------
    counters = (qmm.launches, flash_attn.launches, qmm_expert.launches, qmm_bench.launches)
    # the main paths' qmm kernels: the decode kernel below 64 rows, the
    # wgmma GEMM at the ubatches; a path that launches any other kernel fails
    decode_keys = ("qmm4_planes/decode", "qmm_planes/decode")
    prefill_keys = ("qmm4_planes_prefill/wgmma", "qmm_planes_prefill/wgmma")
    paged_key, slots_key, expert_key = (
        "flash_attention_paged", "flash_attention", "qmm_planes_expert")

    def reset_counts():
        for counter in counters:
            for key in counter:
                counter[key] = 0

    def read_counts(path, must_run):
        """The launch counts of the path just driven; every kernel of the
        path must have been launched, and no other kernel."""
        torch.cuda.synchronize()
        counts = {k: v for counter in counters for k, v in counter.items()}
        log(f"{path} launches: {counts}")
        for name in must_run:
            if counts[name] <= 0:
                failures.append(f"{path}: kernel {name} was not launched")
        for name, c in counts.items():
            if c and name not in must_run:
                failures.append(f"{path}: kernel {name} was launched {c} times")
        return counts

    def against_plain(path, model, logits, gen_ids, prompt, **ctx_kw):
        """The plain path (kernels=False) on the same model, prompt and
        memory, as the reference of the kernel path."""
        ref_ctx = Context(model, kernels=False, **ctx_kw)
        ref_logits = ref_ctx.prefill(prompt, seq=0)
        ref_ids = ref_ctx.generate(prompt, max_new_tokens=len(gen_ids), seq=1)
        err = float(np.mean((logits - ref_logits) ** 2) / (np.mean(ref_logits ** 2) + 1e-30))
        agree = sum(int(a == b) for a, b in zip(gen_ids, ref_ids))
        log(f"{path}: kernel vs plain path: prefill last-token logits NMSE {err:.3e} "
            f"(limit {NMSE_LIMIT}); greedy ids agree {agree}/{len(ref_ids)} "
            f"(argmax {int(np.argmax(logits))} vs {int(np.argmax(ref_logits))})")
        if not err < NMSE_LIMIT:
            failures.append(f"{path}: logits NMSE {err}")
        if agree != len(ref_ids) or len(gen_ids) != len(ref_ids):
            failures.append(f"{path}: greedy ids agree {agree} of {len(ref_ids)}")
        return ref_logits

    def check_logits(path, logits, vocab):
        if logits.shape != (vocab,) or not np.isfinite(logits).all():
            failures.append(f"{path}: prefill logits shape {logits.shape}, finite "
                            f"{bool(np.isfinite(logits).all())}")

    def drive(ctx, prompt, prompts512, vocab, batches, label):
        """One untimed ubatch (the caching allocator's first allocations and
        first launches belong to start-up), a timed prefill, 32 greedy tokens
        at B=1 with their own prefill, then decode_steps_greedy over
        512-token prefills at each batch size."""
        rates = {}
        ctx.prefill(prompt[:512], seq=2)
        ctx.seq_rm(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = ctx.prefill(prompt, seq=0)
        rates[f"prefill_{len(prompt)}_tok_per_s"] = len(prompt) / (time.perf_counter() - t0)
        n0, t_dec0 = ctx.perf.n_decode, ctx.perf.t_decode_ms
        gen_ids = ctx.generate(prompt, max_new_tokens=32, seq=1)
        rates[f"decode_b1_d{len(prompt)}_tok_per_s"] = (ctx.perf.n_decode - n0) / (
            (ctx.perf.t_decode_ms - t_dec0) / 1e3)
        ctx.reset()
        for s, p in enumerate(prompts512):
            ctx.prefill(p, seq=s)
        firsts = np.asarray([1 + s for s in range(len(prompts512))], np.int32)
        for B in batches:
            seqs = np.arange(B)
            ctx.decode_steps_greedy(firsts[:B], seqs, 2)  # warm step shapes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ctx.decode_steps_greedy(firsts[:B], seqs, 16)
            rates[f"decode_steps_greedy_b{B}_d512_tok_per_s"] = B * 16 / (
                time.perf_counter() - t0)
            if out.shape != (B, 16) or out.min() < 0 or out.max() >= vocab:
                failures.append(f"{label}: decode_steps_greedy B={B}: bad ids {out.shape}")
        check_logits(label, logits, vocab)
        return logits, gen_ids, rates

    smoke_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(smoke_dir, exist_ok=True)
    path = os.path.join(smoke_dir, f"llama8b-q4km-{SMOKE_LAYERS}l.gguf")
    t0 = time.perf_counter()
    make_bench_llama_gguf(path, n_layers=SMOKE_LAYERS, seed=0)
    log(f"main path: Llama-3-8B shape (n_embd 4096, 32/8 heads, n_ff 14336, vocab 128256), "
        f"Q4_K_M mix, random weights (seed 0); depth cut 32 -> {SMOKE_LAYERS} layers "
        f"(fixture {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    model = load_model(path)
    torch.cuda.synchronize()
    log(f"load_model: {time.perf_counter() - t0:.1f} s")
    llama_path = path  # path D reads the file again
    lw0 = model.params["layers"][0]
    log("layer 0 weights: " + ", ".join(
        f"{k}:{'packed' if getattr(w, 'packed', False) else ''}{tuple(w.q.shape) if hasattr(w, 'q') else tuple(w.shape)}"
        for k, w in lw0.items()))
    paged_kw = dict(n_ctx=4096, n_seqs=32, n_ubatch=512, quantized_kv=True, kv_total=40960)
    ctx = Context(model, **paged_kw)
    log(f"context: page {ctx.page}, pool pages {ctx.alloc.n_pages}, slots/seq {ctx.n_slots}")
    prng = np.random.default_rng(7)
    prompt = [int(t) for t in prng.integers(3, 128256, 2048)]
    prompts512 = [[int(t) for t in prng.integers(3, 128256, 512)] for _ in range(32)]

    reset_counts()
    logits, gen_ids, rates = drive(ctx, prompt, prompts512, V, (8, 32), "llama paged")
    all_counts = {"llama paged": read_counts(
        "llama paged", decode_keys + prefill_keys + (paged_key,))}
    profile_decode(torch, qmm, ctx, steps=8)
    del ctx
    against_plain("llama paged", model, logits, gen_ids, prompt,
                  **{**paged_kw, "n_seqs": 2, "kv_total": 8192})
    log("llama paged rates (4-layer smoke run, not a benchmark; "
        f"{card}): " + json.dumps(rates))

    # path B: the same model on the slot-table cache
    slots_kw = dict(n_ctx=4096, n_seqs=8, n_ubatch=512, quantized_kv=True, paged=False)
    ctx = Context(model, **slots_kw)
    log(f"path B: the same model under Context(paged=False): cache of {ctx.n_seqs} sequences x "
        f"{ctx.n_slots} slots")
    reset_counts()
    s_logits, s_ids, rates = drive(ctx, prompt, prompts512[:8], V, (8,), "llama slots")
    all_counts["llama slots"] = read_counts(
        "llama slots", decode_keys + prefill_keys + (slots_key,))
    del ctx
    err = float(np.mean((s_logits - logits) ** 2) / (np.mean(logits ** 2) + 1e-30))
    log(f"llama slots vs llama paged: prefill last-token logits NMSE {err:.3e}; greedy ids "
        f"agree {sum(int(a == b) for a, b in zip(s_ids, gen_ids))}/{len(gen_ids)}")
    if not err < NMSE_LIMIT:
        failures.append(f"llama slots vs paged: logits NMSE {err}")
    against_plain("llama slots", model, s_logits, s_ids, prompt, **{**slots_kw, "n_seqs": 2})
    log(f"llama slots rates (4-layer smoke run, not a benchmark; {card}): " + json.dumps(rates))

    # path D: text in, text out through the command-line tool on the same file
    def run_cli(*flags):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_tool.main(["-m", llama_path, "-p", CLI_PROMPT, "-n", "32", "--kv-quant",
                                *flags])
        if rc != 0:
            failures.append(f"path D: llama-cli {flags} exited with {rc}: {err.getvalue()[-300:]}")
        return out.getvalue(), err.getvalue()

    tok = model.tokenizer
    cli_ids = tok.encode(CLI_PROMPT, add_special=True, parse_special=True)
    ref_gen = Context(model, n_ctx=2048, quantized_kv=True).generate(cli_ids, 32)
    ref_text = "".join(tok.piece(t) for t in ref_gen if not tok.is_eog(t)) + "\n"
    reset_counts()
    t0 = time.perf_counter()
    text, err_text = run_cli("--temp", "0")
    all_counts["llama-cli"] = read_counts("path D (llama-cli)", decode_keys + (paged_key,))
    perf_lines = [ln for ln in err_text.splitlines() if ln.startswith("perf:")]
    log(f"path D: llama-cli -p {CLI_PROMPT!r} ({len(cli_ids)} tokens) -n 32 --temp 0 --kv-quant: "
        f"{time.perf_counter() - t0:.1f} s with its own load_model; {len(ref_gen)} ids from "
        f"Context.generate, text equal: {text == ref_text} ({text[:48]!r}...); {perf_lines}")
    if text != ref_text:
        failures.append(f"path D: llama-cli printed {text!r}, Context.generate gives {ref_text!r}")
    if len(perf_lines) != 1 or "tok/s" not in perf_lines[0]:
        failures.append(f"path D: no perf line on stderr: {err_text[-300:]!r}")
    sampled = [run_cli("--temp", "0.8", "--seed", "1")[0] for _ in range(2)]
    log(f"path D: --temp 0.8 --seed 1 twice: same text {sampled[0] == sampled[1]}, "
        f"{len(sampled[0].split())} pieces, equal to the greedy text {sampled[0] == text}")
    if sampled[0] != sampled[1] or not sampled[0].strip():
        failures.append(f"path D: sampled text differs between two runs with one seed: "
                        f"{sampled[0]!r} / {sampled[1]!r}")
    os.remove(llama_path)
    del model, lw0, tok
    torch.cuda.empty_cache()

    # path A: Mixtral-8x7B shape through the indexed-expert kernel
    VM = 32000
    path = os.path.join(smoke_dir, f"mixtral8x7b-q4k-{MOE_LAYERS}l.gguf")
    t0 = time.perf_counter()
    make_bench_moe_gguf(path, n_layers=MOE_LAYERS, seed=0)
    log(f"path A: Mixtral-8x7B shape (n_embd 4096, 32/8 heads of 128, n_ff 14336, 8 experts, "
        f"top-2, vocab 32000), Q4_K experts gate/up, Q6_K down, random weights (seed 0); "
        f"depth cut 32 -> {MOE_LAYERS} layers (fixture {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    model = load_model(path)
    torch.cuda.synchronize()
    log(f"load_model: {time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    os.remove(path)
    moe_kw = dict(n_ctx=4096, n_seqs=8, n_ubatch=512, quantized_kv=True)
    ctx = Context(model, **moe_kw)
    prompt = [int(t) for t in prng.integers(3, VM, 2048)]
    prompts512 = [[int(t) for t in prng.integers(3, VM, 512)] for _ in range(8)]
    reset_counts()
    m_logits, m_ids, rates = drive(ctx, prompt, prompts512, VM, (8,), "mixtral")
    all_counts["mixtral"] = read_counts(
        "mixtral", decode_keys + prefill_keys + (paged_key, expert_key))
    profile_decode(torch, qmm, ctx, steps=8)
    del ctx
    against_plain("mixtral", model, m_logits, m_ids, prompt, **{**moe_kw, "n_seqs": 2})
    log(f"mixtral rates ({MOE_LAYERS}-layer smoke run, not a benchmark; {card}): "
        + json.dumps(rates))
    del model
    torch.cuda.empty_cache()

    # heads of 64: a TinyLlama-1.1B-shaped model (depth cut 22 -> 2) on both memories
    path = os.path.join(smoke_dir, "tinyllama-q4km-2l.gguf")
    make_bench_llama_gguf(path, n_layers=2, n_embd=2048, n_heads=32, n_kv_heads=4, n_ff=5632,
                          vocab_size=VM, n_ctx=2048, seed=0)
    model = load_model(path)
    os.remove(path)
    prompt = [int(t) for t in prng.integers(3, VM, 700)]
    for label, kw, key in (("heads of 64, paged", dict(paged=True), paged_key),
                           ("heads of 64, slots", dict(paged=False), slots_key)):
        kw = dict(n_ctx=2048, n_seqs=2, n_ubatch=512, quantized_kv=True, **kw)
        ctx = Context(model, **kw)
        reset_counts()
        d_logits = ctx.prefill(prompt, seq=0)
        d_ids = ctx.generate(prompt, max_new_tokens=32, seq=1)
        all_counts[label] = read_counts(label, (key,) + decode_keys + prefill_keys)
        check_logits(label, d_logits, VM)
        del ctx
        against_plain(label, model, d_logits, d_ids, prompt, **kw)
    log("heads of 64: the prefill ubatches go through the attention kernels; a decode step "
        "has 8 rows a KV head, which the dispatch rule (heads under 128, fewer than 16 rows) "
        "sends to the plain einsum, as the JAX package does")
    del model
    torch.cuda.empty_cache()

    # path C: the qmm microbenchmark entry point, every case at full width
    log("path C: llama_cpp_tpu_torch.tools.bench_qmm with every case (its own lines follow)")
    reset_counts()
    t0 = time.perf_counter()
    rc = bench_qmm_tool.main(list(bench_qmm_tool.CASES))
    if rc != 0:
        failures.append(f"path C: bench_qmm exited with {rc}")
    all_counts["bench_qmm"] = read_counts("path C (bench_qmm)",
                                          (*qmm_bench.launches, *decode_keys))
    # each line of the tool launches its kernel as often as the one stream line
    per_line = all_counts["bench_qmm"]["stream_planes"]
    for key, r in tiles_res.items():
        if all_counts["bench_qmm"][key] != per_line * r["held"]:
            failures.append(f"path C launched {key} {all_counts['bench_qmm'][key]} times, "
                            f"{per_line} a line, where phase 3 held {r['held']} tiles against "
                            "the plain version: the two sweeps differ")
    log(f"path C: {time.perf_counter() - t0:.1f} s; {per_line} launches a line, "
        + ", ".join(f"{r['held']} lines of {key}" for key, r in tiles_res.items())
        + ", each held in phase 3")
    torch.cuda.empty_cache()
    if failures:
        for f in failures:
            log(f"FAIL {f}")
        return 1

    tpu_of = {
        "qmm4_planes": "llama_cpp_tpu/ops/pallas/qmm.py:403",
        "qmm4_planes_prefill": "llama_cpp_tpu/ops/pallas/qmm.py:739",
        "qmm_planes": "llama_cpp_tpu/ops/pallas/qmm.py:170",
        "qmm_planes_prefill": "llama_cpp_tpu/ops/pallas/qmm.py:675",
        "flash_attention_paged": "llama_cpp_tpu/ops/pallas/flash_attn.py:459",
        "flash_attention": "llama_cpp_tpu/ops/pallas/flash_attn.py:172",
        "qmm_planes_expert": "llama_cpp_tpu/ops/pallas/qmm.py:828",
        "stream_planes": "scripts/bench_qmm.py:97",
        "qmm4_variant": "scripts/bench_qmm.py:177",
        "qmm_tiled": "scripts/bench_qmm.py:285",
        "qmm_tiled4d": "scripts/bench_qmm.py:337",
    }
    source_of = {"flash_attention_paged": "flash_attn_paged.cu", "flash_attention": "flash_attn.cu",
                 "qmm_planes_expert": "qmm_expert.cu", **{k: "qmm_prefill.cu" for k in prefill_keys},
                 **{k: "qmm_decode.cu" for k in decode_keys},
                 **{name: "qmm_bench.cu" for name in qmm_bench.launches}}
    # launches: from the path that is the kernel's own (the llama path on the
    # pool, the slot-table path, the Mixtral path, the microbenchmark)
    path_of = {"flash_attention": "llama slots", "qmm_planes_expert": "mixtral",
               **{name: "bench_qmm" for name in qmm_bench.launches}}
    kernels = []
    for name, r in res.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "llama_cpp_tpu_torch/csrc/" + source_of[name],
                        "replaces": tpu_of[name.split("/")[0]],
                        "launches": all_counts[path_of.get(name, "llama paged")][name],
                        "launches_by_path": {p: c[name] for p, c in all_counts.items()},
                        "max_abs_err": r["max_abs_err"],
                        "nmse": r["nmse"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **({k: r[k] for k in ("tile", "rows") if k in r})})
    log(f"card: {gpu_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
