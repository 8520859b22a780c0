#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (llama_cpp_tpu_torch) on one NVIDIA
H100.

    python3 chip_smoke.py        # several minutes

Phases, each of which fails the run:
  1. the card's name and power limit, torch / CUDA / nvcc versions;
  2. build the CUDA kernels from the package's csrc/ (ptxas register and
     shared-memory lines printed);
  3. every kernel at the main path's shapes on the card, held against its
     plain PyTorch version (NMSE < 5e-3), timed by CUDA events (the L2
     flushed by a 128 MB read before each launch) beside its bound, the plain version and one
     PyTorch library call: the qmm decode kernel (csrc/qmm_decode.cu) at
     every main-path decode shape of an 8B layer and the vocab head and
     N = 1, 2, 4, 8, 16, 32, 63 (and held, untimed, at the TinyLlama
     layer's), then K1 and K2 at N = 1, 8, 32 beside the stream probe's
     rate; the wgmma prefill GEMM (K3, K4) held, untimed, at every
     main-path shape (the 8B and TinyLlama layers) and 64, 65, 200, 512 and
     1023 rows, timed at 64-1023 rows, beside its registers and spills;
     the attention kernels (a prefill kernel from PREFILL_MIN_ROWS rows a
     KV head, a decode kernel below it; each held call must launch its
     route's kernel once) at decode B = 1, 8, 32 and at a prefill ubatch, on
     an int8 and a bf16 pool, with heads of 32, 64 and 256, then both
     kernels forced at 16-512 rows and depths 2048 and 128 to read the
     route threshold; the
     indexed-expert kernel at Mixtral-8x7B and Qwen3-30B-A3B expert shapes
     (R = 8, 64 and 64 rows drawn from 16 experts),
     the slot-table attention kernels at the same depths as the paged ones,
     and with 64-wide heads; the microbenchmark's
     four probe kernels (stream probe, the two nibble unpacks, the tile sweep
     flat and tile by tile) at the gate/up and down shapes of an 8B llama,
     the tile sweep once, untimed, at every shape and tile the
     microbenchmark entry point launches it at, the vocab head included,
     and the even/odd GEMV B2 (csrc/qmm_bench.cu qmm4_variant_kernel)
     timed at 4096 x 4096 too, held, untimed, at the four decode shapes and
     N = 8, 16, 32 with both unpacks (equal bits), and seen by the profiler
     to run one kernel a call;
     then the conformance sweep (llama_cpp_tpu_torch.tools.conformance):
     every row of the JAX package's scripts/conformance.py through the
     port's kernel against its f64 oracle (NMSE < 5e-3), written to
     build/conformance_h100.csv; a FAIL row fails the run unless
     KNOWN_FAULTS names it;
  4. the main paths through the port's entry points, each with the launch
     counters set to 0 before it and read after it, and each held against
     the plain path (Context(kernels=False)) on the prefill's last-token
     logits and greedy ids:
     - a Llama-3-8B-shaped Q4_K_M model (random weights from a seed, full
       width, depth cut to 4 layers), load_model, a Context with a paged
       int8 KV pool, a 2048-token prefill, 32 greedy tokens at B=1 and
       decode_steps_greedy at B=8 and B=32 over 512-token prefills;
     - the same model and prompt with one ubatch of 2048 rows, whose
       products of 1024 rows and more take the library route (bf16
       operands, f32 sums), held against the 512-row ubatches (logits NMSE
       and 32 of 32 greedy ids);
     - the same model on the slot-table cache (Context(paged=False)): every
       attention goes through the slot-table kernels;
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
       Context.generate on the encoded prompt, and sampled under a seed twice;
     - path E, the measurement tools on the same file: llama-bench
       (tools/bench_tool.py, pp512 and tg32 through generate_ondevice, then
       the batched grid at B = 1 and 8), llama-perplexity
       (tools/perplexity.py, 2 chunks of 512 of a seeded text, the vocab
       head through K4 at 512 rows), its ln PPL within 1e-3 of the same run
       under Context(kernels=False), and llama-results (tools/results.py),
       recorded and checked with no drift;
     after the pool, slot-table, Mixtral and heads-of-64 paths, the graph
     phase of that path: the decode loop on CUDA graphs
     (runtime/decode_graph.py) against the same step launched eagerly
     (Context(graphs=False)): decode_steps_greedy at each batch size the
     path drives (16 of 16 ids a row equal), 100 consecutive replays at
     B=1, the kernel set a replay launches (torch.profiler) equal to the
     eager step's, wall and device ms a step and the device's busy share at
     B = 1 and the path's batch sizes, and generate_ondevice (greedy, 32
     tokens, chunk 32) against Context.generate's ids; on the pool path
     also generate_ondevice sampled (temp 0.8, top_k 40, seed 1) twice:
     equal ids, each inside the top 40 of the plain path's teacher-forced
     logits, and top_k 1 equal to greedy. Launch counts include every graph
     replay (a graph adds its step's launches at each replay).
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
# conformance rows that fail for a fault open in ROADMAP.md queue 3:
# (kernel, config); printed as "known fault" with their NMSE
KNOWN_FAULTS: tuple[tuple[str, str], ...] = ()
# conformance rows whose shapes the port's kernels do not take (K and V heads
# that differ, ROADMAP.md queue 1, item 12): they must raise
UNTAKEN_ROWS = (("flash_attn_paged", "mla-576"), ("flash_attn_paged", "mla-576-int8"))
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


def attn_measure(torch, timer, fa, name, label, run, run_plain, q, kd, vd, cp, rp, kv_elem,
                 quantized, failures):
    """Hold an attention kernel (run) against its plain version (run_plain)
    and time both, beside SDPA on the gathered, dequantized K/V kd, vd
    [B, Hkv, S, D] with the same mask (library yardstick, timed only).
    The held call must launch the CUDA kernel of its route (name/prefill or
    name/decode) once and nothing else.
    cp [B, S] are the columns' position labels, rp [B, R] the rows'.
    Bound: q, the K/V rows (and scales) and position labels that some row of
    the batch row can see (pos >= 0 and <= the row's largest position), out;
    the operations of the unmasked (row, column) pairs."""
    import torch.nn.functional as F

    B, Hkv, R, D = q.shape
    sm = 1.0 / D ** 0.5
    key = f"{name}/{fa.route(R)}"
    before = dict(fa.launches)
    got = run(sm)
    torch.cuda.synchronize()
    if fa.launches != {**before, key: before[key] + 1}:
        failures.append(f"{label}: expected one launch of {key}, counts went from {before} "
                        f"to {fa.launches}")
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
    log(f"  {label:38s} [{key.split('/')[1]}] B={B} R={R} D={D} nmse={err:.2e} ms={ms:.4f} "
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
        torch, timer, fa, "flash_attention_paged", label,
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
        torch, timer, fa, "flash_attention", label,
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
        f"bound_ms={bound:.4f} ({'bytes' if bytes_s > ops_s else 'operations'}), share of "
        f"bound {bound / ms:.3f}")
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


def variant_rows(torch, timer, qb, name, K, O, failures):
    """B2 at one more shape, 8 rows of x: both unpacks held against the plain
    version and against each other, timed beside the bound (plane bytes, x
    and out over the memory rate) and torch.matmul on the pre-dequantized
    bf16 weight. Returns {unpack: numbers}."""
    gen = torch.Generator(device="cuda").manual_seed(K + O + 2)
    N, G = 8, 32
    qp = torch.randint(0, 256, (K // 2, O), generator=gen, device="cuda",
                       dtype=torch.uint8).view(torch.int8)
    sc = torch.randn((K // G, O), generator=gen, device="cuda") * 0.05
    mn = torch.randn((K // G, O), generator=gen, device="cuda") * 0.1
    x = torch.randn((N, K), generator=gen, device="cuda").to(torch.bfloat16)
    ref = qb.qmm4_variant_plain(x, qp, sc, mn, group=G)
    u = qp.view(torch.uint8)
    wd = torch.stack((u & 0xF, u >> 4), dim=1).reshape(K // G, G, O).float()
    wd = (wd * sc[:, None, :] + mn[:, None, :]).reshape(K, O).to(torch.bfloat16)
    lib_ms = timer(lambda: torch.matmul(x, wd))
    plain_ms = timer(lambda: qb.qmm4_variant_plain(x, qp, sc, mn, group=G), reps=3)
    nbytes = N * K * 2 + qp.numel() + 2 * sc.numel() * 4 + N * O * 4
    bound = max(nbytes / HBM_BYTES_PER_S, 2.0 * N * K * O / BF16_FLOPS) * 1e3
    res, outs = {}, {}
    for unpack in ("fp", "i16"):
        def fn():
            return qb.qmm4_variant(x, qp, sc, mn, group=G, unpack=unpack)
        out = outs[unpack] = fn()
        torch.cuda.synchronize()
        err = nmse(out, ref)
        if not err < NMSE_LIMIT or not torch.isfinite(out).all():
            failures.append(f"B2 {unpack} {name}: NMSE {err}")
        res[unpack] = {"ms": timer(fn), "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound, "max_abs_err": float((out - ref).abs().max()),
                       "nmse": err}
        log(f"  B2 qmm4_variant {unpack:3s} {name:7s} K={K:5d} O={O:5d} nmse={err:.2e} "
            f"ms={res[unpack]['ms']:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound:.4f} (bytes), share of bound {bound / res[unpack]['ms']:.3f}; "
            f"plan {qb.variant_plan(N, K, O)}")
    if not torch.equal(outs["fp"], outs["i16"]):
        failures.append(f"B2 {name}: the two unpacks differ")
    return res


def variant_held(torch, qb, tool, failures):
    """B2 at the four decode shapes and N = 8, 16, 32, untimed: both unpacks
    against the plain version (NMSE < 5e-3) and equal to the bit; then one
    call of each unpack under the profiler, which must see one kernel, the
    B2 kernel. Returns the largest errors."""
    from torch.profiler import ProfilerActivity, profile

    worst = {"nmse": 0.0, "max_abs_err": 0.0}
    G = tool.GROUP
    for name, K, O in tool.DECODE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(K + O + 3)
        qp = torch.randint(0, 256, (K // 2, O), generator=gen, device="cuda",
                           dtype=torch.uint8).view(torch.int8)
        sc = torch.randn((K // G, O), generator=gen, device="cuda") * 0.05
        mn = torch.randn((K // G, O), generator=gen, device="cuda") * 0.1
        errs = []
        for n in (8, 16, 32):
            x = torch.randn((n, K), generator=gen, device="cuda").to(torch.bfloat16)
            fp = qb.qmm4_variant(x, qp, sc, mn, group=G, unpack="fp")
            i16 = qb.qmm4_variant(x, qp, sc, mn, group=G, unpack="i16")
            torch.cuda.synchronize()
            ref = qb.qmm4_variant_plain(x, qp, sc, mn, group=G)
            err = nmse(fp, ref)
            errs.append(err)
            if not err < NMSE_LIMIT or not torch.isfinite(fp).all():
                failures.append(f"B2 {name} K={K} O={O} N={n}: NMSE {err}")
            if not torch.equal(fp, i16):
                failures.append(f"B2 {name} K={K} O={O} N={n}: the two unpacks differ")
            worst["nmse"] = max(worst["nmse"], err)
            worst["max_abs_err"] = max(worst["max_abs_err"], float((fp - ref).abs().max()))
        log(f"  B2 held at {name:6s} K={K:5d} O={O:5d} N=[8, 16, 32]: NMSE "
            + " ".join(f"{e:.2e}" for e in errs) + ", fp and i16 equal")
    # one profiler session for both calls (a second session right after a
    # first one has come back empty on the card)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for unpack in ("fp", "i16"):
            qb.qmm4_variant(x, qp, sc, mn, group=G, unpack=unpack)
        torch.cuda.synchronize()
    kernels = sorted((e.key, e.count) for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"  B2: one call of each unpack runs {kernels}")
    want = [f"qmm4_variant_kernel<4, {fp}>" for fp in ("false", "true")]
    if len(kernels) != 2 or any(c != 1 or w not in k for (k, c), w in zip(kernels, want)):
        failures.append(f"B2: one call of each unpack ran {kernels}, not one qmm4_variant_kernel "
                        "each")
    return worst


def conformance_phase(torch, tool, failures):
    """Every row of the reference's conformance sweep through the port's
    kernel on the card, written to build/conformance_h100.csv."""
    rows = tool.run("cuda")
    path = os.path.join(ROOT, "build", "conformance_h100.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(tool.to_csv(rows, torch.device("cuda")))
    for r in rows:
        key = (r.kernel, r.config)
        if r.status == "PASS":
            continue
        if r.status == "FAIL" and key in KNOWN_FAULTS:
            log(f"  known fault {r.kernel} {r.config}: NMSE {r.nmse} ({r.route})")
        elif r.status == "raises" and key in UNTAKEN_ROWS:
            log(f"  {r.kernel} {r.config}: {r.route}")
        else:
            failures.append(f"conformance {r.kernel} {r.config}: {r.status}, NMSE {r.nmse} "
                            f"({r.route})")
    counts = {s: sum(r.status == s for r in rows) for s in ("PASS", "FAIL", "raises")}
    worst = max((r for r in rows if r.nmse is not None), key=lambda r: r.nmse)
    log(f"conformance sweep: {len(rows)} rows, {counts['PASS']} PASS, {counts['FAIL']} FAIL, "
        f"{counts['raises']} raises (known faults: {list(KNOWN_FAULTS)}); largest NMSE "
        f"{worst.nmse:.3e} ({worst.kernel} {worst.config}); written to {path}")


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


def timed_wrapper(module, name, acc, before=None):
    """module.name wrapped so that the host time of each call adds to acc
    [seconds, calls]; `before` runs ahead of each call, outside the timing."""
    fn = getattr(module, name)

    def call(*args):
        if before is not None:
            before()
        t = time.perf_counter()
        y = fn(*args)
        acc[0] += time.perf_counter() - t
        acc[1] += 1
        return y
    return fn, call


def profile_decode(torch, qmm, ctx, steps: int, qe=None):
    """Where a B=1 decode step's time goes: `steps` decode_one calls of
    sequence 0 timed by the host clock, with the host time spent inside the
    qmm wrapper (planning, checks and the launch) summed beside it, and with
    `qe` inside the qmm_expert wrapper, once as it runs (tensor maps and
    scratch cached) and once more with both cleared before every call (made
    anew each call); then as many steps under
    torch.profiler for the device time by kernel (the profiler's own
    start-up cost makes its window's wall time meaningless, so the share
    uses the first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def uncache():
        qe._MAPS.clear()
        qe._SCRATCH.clear()

    tok = 1
    runs = [("cached", None)] + ([("made anew", uncache)] if qe is not None else [])
    wall_ms = None  # the cached run's
    for label, before in runs:
        in_qmm, in_qe = [0.0, 0], [0.0, 0]
        qmm_fn, qmm_timed = timed_wrapper(qmm, "qmm", in_qmm)
        torch.cuda.synchronize()
        qmm.qmm = qmm_timed
        if qe is not None:
            qe_fn, qe_timed = timed_wrapper(qe, "qmm_expert", in_qe, before)
            qe.qmm_expert = qe_timed
        try:
            t0 = time.perf_counter()
            for _ in range(steps):
                tok = int(ctx.decode_one(tok, seq=0).argmax())
            run_ms = (time.perf_counter() - t0) * 1e3 / steps
        finally:
            qmm.qmm = qmm_fn
            if qe is not None:
                qe.qmm_expert = qe_fn
        if wall_ms is None:
            wall_ms = run_ms
            log(f"B=1 decode host time in the qmm wrapper: {in_qmm[0] * 1e3 / steps:.3f} ms a "
                f"step over {in_qmm[1] / steps:.0f} calls "
                f"({in_qmm[0] * 1e6 / max(in_qmm[1], 1):.1f} us a call) of {run_ms:.3f} ms wall")
        if qe is not None:
            log(f"B=1 decode host time in the qmm_expert wrapper, tensor maps and scratch "
                f"{label}: {in_qe[0] * 1e6 / max(in_qe[1], 1):.1f} us a call over "
                f"{in_qe[1] / steps:.0f} calls a step ({run_ms:.3f} ms wall a step)")
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
        from llama_cpp_tpu_torch.tools import bench_tool
        from llama_cpp_tpu_torch.tools import cli as cli_tool
        from llama_cpp_tpu_torch.tools import conformance as conformance_tool
        from llama_cpp_tpu_torch.tools import decode_wall, perplexity, results
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
    # the perplexity tool's all-rows logits: the vocab head over a 512-row ubatch
    hp = qmm_phase(torch, timer, qmm, "K4 qmm_planes_prefill (head)", head, (512,), failures)
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
           "qmm4_planes_prefill/wgmma": q4p[512],
           "qmm_planes_prefill/wgmma": {**q6p[512], "max_abs_err": max(
               q6p[512]["max_abs_err"], hp[512]["max_abs_err"]), "head_512": {
               k: hp[512][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "nmse")}}}
    res["flash_attention_paged/decode"] = attn_phase(
        torch, timer, flash_attn, "K5 decode B=1 d=2048",
        attn_case(torch, B=1, G=4, T=1, depth=2048), failures)
    attn_phase(torch, timer, flash_attn, "K5 decode B=8 d=512",
               attn_case(torch, B=8, G=4, T=1, depth=512), failures)
    attn_phase(torch, timer, flash_attn, "K5 decode B=32 d=512",
               attn_case(torch, B=32, G=4, T=1, depth=512), failures)
    res["flash_attention_paged/prefill"] = attn_phase(
        torch, timer, flash_attn, "K5 prefill ubatch 4 of 2048",
        attn_case(torch, B=1, G=4, T=512, depth=1536), failures)
    attn_phase(torch, timer, flash_attn, "K5 bf16 pool decode B=1 d=2048",
               attn_case(torch, B=1, G=4, T=1, depth=2048, kv_dtype=torch.bfloat16), failures)
    attn_phase(torch, timer, flash_attn, "K5 bf16 pool prefill ubatch 4 of 2048",
               attn_case(torch, B=1, G=4, T=512, depth=1536, kv_dtype=torch.bfloat16),
               failures)
    attn_phase(torch, timer, flash_attn, "K5 heads of 64, decode B=8 d=512",
               attn_case(torch, B=8, G=16, T=1, depth=512, D=64), failures)
    attn_phase(torch, timer, flash_attn, "K5 heads of 64, ubatch 188 rows x 8",
               attn_case(torch, B=1, G=8, T=188, depth=512, D=64, Hkv=4), failures)
    log("route threshold: each kernel forced at R rows (G=4; int8 pool, heads of 128, B=1, "
        f"8 KV heads; PREFILL_MIN_ROWS = {flash_attn.PREFILL_MIN_ROWS}):")
    keep = flash_attn.PREFILL_MIN_ROWS
    try:
        for depth in (2048, 128):
            for R in (16, 32, 64, 128, 256, 512):
                case = attn_case(torch, B=1, G=4, T=R // 4, depth=depth)
                t = {}
                for kind, threshold in (("decode", 1 << 30), ("prefill", 1)):
                    flash_attn.PREFILL_MIN_ROWS = threshold
                    t[kind] = attn_phase(torch, timer, flash_attn,
                                         f"K5 d={depth} R={R}, {kind} kernel", case,
                                         failures)["ms"]
                log(f"  depth {depth} R={R}: decode kernel {t['decode']:.4f} ms, prefill kernel "
                    f"{t['prefill']:.4f} ms; the {min(t, key=t.get)} kernel is faster")
                del case
    finally:
        flash_attn.PREFILL_MIN_ROWS = keep
    for D in (32, 256):
        for dt, name in ((None, "int8"), (torch.bfloat16, "bf16")):
            attn_phase(torch, timer, flash_attn, f"K5 heads of {D}, {name}, decode B=8 d=512",
                       attn_case(torch, B=8, G=4, T=1, depth=512, D=D, kv_dtype=dt), failures)
            attn_phase(torch, timer, flash_attn, f"K5 heads of {D}, {name}, ubatch 4 of 2048",
                       attn_case(torch, B=1, G=4, T=512, depth=1536, D=D, kv_dtype=dt),
                       failures)
    torch.cuda.empty_cache()
    log("K6 slot-table attention (cache [8 seqs, 8 heads, 5120 slots, D]):")
    res["flash_attention/decode"] = slots_phase(
        torch, timer, flash_attn, "K6 decode B=1 d=2048",
        slots_case(torch, B=1, G=4, T=1, depth=2048), failures)
    slots_phase(torch, timer, flash_attn, "K6 decode B=8 d=512",
                slots_case(torch, B=8, G=4, T=1, depth=512), failures)
    slots_phase(torch, timer, flash_attn, "K6 decode B=32 d=512",
                slots_case(torch, B=32, G=4, T=1, depth=512, n_seqs=32), failures)
    res["flash_attention/prefill"] = slots_phase(
        torch, timer, flash_attn, "K6 prefill ubatch 4 of 2048",
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
    # one JSON entry: a Mixtral layer's three expert products at B=1 (R=2),
    # with the Qwen3-30B-A3B rows beside
    res["qmm_planes_expert"] = {
        **{k: sum(r[k] for r in mix) for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "max_abs_err": max(r["max_abs_err"] for r in mix), "nmse": max(r["nmse"] for r in mix),
        "bound_by": ("bytes" if sum(r["bytes_s"] for r in mix) > sum(r["ops_s"] for r in mix)
                     else "operations"), "rows": {}}
    qwen = res["qmm_planes_expert"]
    for wname, K, O, q4 in (("ffn_gate_exps", 2048, 768, True),
                            ("ffn_down_exps", 768, 2048, False)):
        w = expert_stack(torch, qtensor, GGMLType, 128, K, O, q4, seed=7)
        for R, pool in ((8, None), (64, None), (64, 16)):
            r = expert_phase(torch, timer, qmm_expert, f"K7 qwen3-moe {wname}"
                             + (" shared" if pool else ""), w, R, failures, pool=pool)
            qwen["rows"][f"qwen3 {wname} R={R}" + (" shared" if pool else "")] = {
                k: r[k] for k in ("ms", "bound_ms", "library_ms")}
            qwen["max_abs_err"] = max(qwen["max_abs_err"], r["max_abs_err"])
            qwen["nmse"] = max(qwen["nmse"], r["nmse"])
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
    log("B2 at 4096 x 4096 (timed), at the decode shapes and N = 8, 16, 32 (held), one "
        "kernel a call (profiler):")
    attno = variant_rows(torch, timer, qmm_bench, "attno", E, E, failures)
    held = variant_held(torch, qmm_bench, bench_qmm_tool, failures)
    for unpack in ("fp", "i16"):
        r = bench_res[f"qmm4_variant/{unpack}"]
        r["kernel"] = "qmm4_variant_kernel"
        r["rows"] = {"gateup 4096x28672": {k: r[k] for k in ("ms", "bound_ms", "library_ms")},
                     "down 14336x4096": {k: down_res[f"qmm4_variant/{unpack}"][k]
                                         for k in ("ms", "bound_ms", "library_ms")},
                     "attno 4096x4096": {k: attno[unpack][k]
                                         for k in ("ms", "bound_ms", "library_ms")}}
        r["max_abs_err"] = max(r["max_abs_err"], attno[unpack]["max_abs_err"],
                               held["max_abs_err"])
        r["nmse"] = max(r["nmse"], attno[unpack]["nmse"], held["nmse"])
    res.update(bench_res)
    torch.cuda.empty_cache()
    log("conformance sweep of every kernel (the reference's rows, f64 oracles):")
    conformance_phase(torch, conformance_tool, failures)
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
    paged_keys = ("flash_attention_paged/prefill", "flash_attention_paged/decode")
    slots_keys = ("flash_attention/prefill", "flash_attention/decode")
    expert_key = "qmm_planes_expert"

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

    def graph_phase(label, model, ctx_kw, prompt, gen_ids, prompts, batches, must_run):
        """The decode loop on CUDA graphs against the same step launched
        eagerly (Context(graphs=False)) on one path: decode_steps_greedy at
        each batch size (16 of 16 ids a row), 100 consecutive replays at B=1,
        wall and device ms a step with the kernel set a step launches, read
        by the profiler, which must be the eager step's; then
        generate_ondevice, greedy, 32 tokens over the path's prompt with
        chunk 32, against Context.generate's ids. Returns the graphed
        context, reset."""
        reset_counts()
        ctxs = {}
        for graphs in (True, False):
            c = ctxs[graphs] = Context(model, graphs=graphs, **ctx_kw)
            for s, p in enumerate(prompts[: max(batches)]):
                c.prefill(p, seq=s)
        firsts = np.asarray([1 + s for s in range(max(batches))], np.int32)
        for B in batches:
            out = {g: c.decode_steps_greedy(firsts[:B], np.arange(B), 16)
                   for g, c in ctxs.items()}
            rows_equal = int((out[True] == out[False]).all(axis=1).sum())
            log(f"{label} graphs: decode_steps_greedy B={B}, 16 steps: {rows_equal} of {B} rows "
                f"equal to the eager loop's")
            if rows_equal != B:
                failures.append(f"{label}: graphed decode_steps_greedy B={B}: {rows_equal} of "
                                f"{B} rows equal the eager loop's")
        out = {g: c.decode_steps_greedy(firsts[:1], np.arange(1), 100) for g, c in ctxs.items()}
        agree = int((out[True] == out[False]).sum())
        log(f"{label} graphs: 100 consecutive replays at B=1: {agree} of 100 ids equal the "
            f"eager loop's ({ctxs[True].decode_loop(1).replays} replays of the B=1 graph)")
        if agree != 100:
            failures.append(f"{label}: 100 replays: {agree} of 100 ids equal the eager loop's")
        rows = {g: decode_wall.measure(torch, c, (1, *[b for b in batches if b > 1]), 16, 2)
                for g, c in ctxs.items()}
        for g_row, e_row in zip(rows[True], rows[False]):
            B = g_row["B"]
            log(f"{label} B={B} ({card}): graphed wall {min(g_row['wall_ms_per_step']):.3f} "
                f"ms/step, device {g_row['device_ms_per_step']:.3f} ms, busy "
                f"{g_row['busy_share']:.3f}, {g_row['launches_per_step']:.0f} launches; eager "
                f"wall {min(e_row['wall_ms_per_step']):.3f} ms/step, device "
                f"{e_row['device_ms_per_step']:.3f} ms, busy {e_row['busy_share']:.3f}, "
                f"{e_row['launches_per_step']:.0f} launches")
            graph_rows.append({"path": label, "B": B, "graphed": {
                k: g_row[k] for k in ("wall_ms_per_step", "device_ms_per_step", "busy_share")},
                "eager": {k: e_row[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                                "busy_share")}})
            if not g_row["kernels"] or g_row["kernels"] != e_row["kernels"]:
                only_g = sorted(set(g_row["kernels"]) - set(e_row["kernels"]))
                only_e = sorted(set(e_row["kernels"]) - set(g_row["kernels"]))
                failures.append(f"{label} B={B}: a replay's kernels differ from the eager "
                                f"step's: only replayed {only_g[:5]}, only eager {only_e[:5]}")
        del ctxs[False]
        ctx = ctxs.pop(True)
        ctx.reset()
        ids = ctx.generate_ondevice(prompt, max_new_tokens=len(gen_ids), chunk=32)
        agree = sum(int(a == b) for a, b in zip(ids, gen_ids))
        log(f"{label} graphs: generate_ondevice greedy at depth {len(prompt)}, chunk 32: "
            f"{agree} of {len(gen_ids)} ids equal Context.generate's")
        if agree != len(gen_ids) or len(ids) != len(gen_ids):
            failures.append(f"{label}: generate_ondevice ids agree {agree} of {len(gen_ids)} "
                            "with Context.generate")
        all_counts[f"{label} graphs"] = read_counts(f"{label} graphs", must_run)
        ctx.reset()
        return ctx

    def sampled_phase(ctx, model, ref_kw, prompt, greedy_ids):
        """generate_ondevice with temp 0.8, top_k 40, seed 1, twice: equal
        ids, each inside the top 40 of the plain path's teacher-forced
        logits (up to that step's largest difference between the kernel
        path's logits and the plain path's, where the 40th and 41st lie
        closer than that); top_k=1 gives the greedy ids."""
        runs = []
        for k in (40, 40, 1):
            runs.append(ctx.generate_ondevice(prompt, max_new_tokens=32, temp=0.8, top_k=k,
                                              seed=1, chunk=32))
            ctx.reset()
        plain = Context(model, kernels=False, **ref_kw)
        kern = Context(model, **ref_kw)
        lp, lk = plain.prefill(prompt), kern.prefill(prompt)
        ranks, outside = [], 0
        for t in runs[0]:
            kth = np.sort(lp)[-40]
            ranks.append(int((lp > lp[t]).sum()))
            if ranks[-1] >= 40 and lp[t] < kth - float(np.abs(lk - lp).max()):
                outside += 1
            lp, lk = plain.decode_one(t), kern.decode_one(t)
        log(f"sampled generate_ondevice (temp 0.8, top_k 40, seed 1): repeat "
            f"{runs[0] == runs[1]}, ranks in the plain path's teacher-forced logits {ranks}, "
            f"{outside} outside the top 40; top_k 1 equal to greedy {runs[2] == greedy_ids}")
        if runs[0] != runs[1] or outside or runs[2] != greedy_ids or len(runs[0]) != 32:
            failures.append(f"sampled generate_ondevice: repeat {runs[0] == runs[1]}, "
                            f"{outside} ids outside the top 40, top_k=1 greedy "
                            f"{runs[2] == greedy_ids}")

    def run_tool(name, main_fn, argv):
        """A tool's main(argv) -> its stdout; a non-zero exit fails the run."""
        out, err = io.StringIO(), io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main_fn(argv)
        log(f"path E: {name} {' '.join(argv[2:])}: exit {rc}, {time.perf_counter() - t:.1f} s "
            "with its own load_model")
        if rc != 0:
            failures.append(f"path E: {name} {argv} exited with {rc}: {err.getvalue()[-300:]}")
        return out.getvalue()

    def path_e(model, path, out_dir):
        """The measurement tools on the 4-layer llama file: llama-bench
        (pp512 and tg32 through generate_ondevice, then the batched grid at
        B = 1 and 8), llama-perplexity on a seeded text of the fixture's
        vocabulary (2 chunks of 512; the head through K4 at 512 rows), its
        ln PPL held against the same run under Context(kernels=False) to
        1e-3 relative, and llama-results, recorded and then checked with no
        drift."""
        reset_counts()
        doc = json.loads(run_tool("llama-bench", bench_tool.main,
                                  ["-m", path, "-p", "512", "-n", "32", "-o", "json"]))
        rows = doc["results"]
        log(f"path E: llama-bench rows ({card}): {rows}")
        if [r["test"] for r in rows] != ["pp512", "tg32"] or not all(r["t/s"] > 0 for r in rows):
            failures.append(f"path E: llama-bench rows {rows}")
        grid = json.loads(run_tool("llama-bench --batched", bench_tool.main,
                                   ["-m", path, "--batched", "-b", "1,8", "-p", "512", "-n",
                                    "32", "-o", "json"]))["results"]
        log(f"path E: llama-bench --batched rows ({card}): {grid}")
        if [r["B"] for r in grid] != [1, 8] or not all(r["S_TG t/s"] > 0 for r in grid):
            failures.append(f"path E: llama-bench --batched rows {grid}")
        all_counts["llama-bench"] = read_counts("path E (llama-bench)",
                                                decode_keys + prefill_keys + paged_keys)

        # the pieces of seeded token ids, as many as make 1100 tokens again
        # (the fixture's vocabulary splits its words into several tokens)
        tok = model.tokenizer
        pieces = [tok.piece(int(t))
                  for t in np.random.default_rng(11).integers(300, model.cfg.vocab_size, 1100)]

        def n_tokens(n):
            return len(tok.encode("".join(pieces[:n]), add_special=True, parse_special=False))

        lo, hi = 1, len(pieces)
        while lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if n_tokens(mid) >= 1100 else (mid + 1, hi)
        text = "".join(pieces[:lo])
        n_tok = n_tokens(lo)
        corpus = os.path.join(out_dir, "perplexity.txt")
        with open(corpus, "w", encoding="utf-8") as fh:
            fh.write(text)
        if not 1024 <= n_tok < 1536:
            failures.append(f"path E: the corpus is {n_tok} tokens, not 2 chunks of 512")
        reset_counts()
        lines = run_tool("llama-perplexity", perplexity.main,
                         ["-m", path, "-f", corpus, "-c", "512"]).strip().splitlines()
        all_counts["llama-perplexity"] = read_counts(
            "path E (llama-perplexity)", prefill_keys + ("flash_attention_paged/prefill",))
        # held on ln PPL, the mean NLL: the random weights' logits run to
        # hundreds, so PPL is near e^700 and a 1e-3 bound on it would ask for
        # the mean NLL to 1e-3 nats
        ref = perplexity.perplexity(Context(model, n_ctx=512, n_seqs=1, kernels=False),
                                    text=text, n_ctx=512)
        got = float(lines[-1].split()[2]) if lines and lines[-1].startswith("PPL = ") else None
        err = (abs(np.log(got) - np.log(ref.ppl)) / abs(np.log(ref.ppl))
               if got is not None and got > 0 else None)
        log(f"path E: llama-perplexity over {n_tok} tokens (2 chunks of 512): {lines[-1:]}; "
            f"the plain path {ref}; ln PPL {np.log(got) if got else None} against "
            f"{np.log(ref.ppl)}, relative difference {err}")
        if err is None or not err < 1e-3 or not np.isfinite(np.log(ref.ppl)):
            failures.append(f"path E: perplexity {got} against the plain path's {ref.ppl}")

        reset_counts()
        base = os.path.join(out_dir, "results.json")
        run_tool("llama-results", results.main, ["-m", path, "-o", base])
        report = run_tool("llama-results --check", results.main, ["-m", path, "--check", base])
        # prompts of 4-8 tokens: every product and attention below the prefill kernels' rows
        all_counts["llama-results"] = read_counts("path E (llama-results)",
                                                  decode_keys + ("flash_attention_paged/decode",))
        report = json.loads(report.strip().splitlines()[-1])
        log(f"path E: llama-results record, then check: {report}")
        if report.get("token_mismatches") != 0 or report.get("max_logit_drift") != 0.0:
            failures.append(f"path E: llama-results drift {report}")

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

    graph_rows: list[dict] = []  # wall and device ms a step, graphed and eager
    reset_counts()
    logits, gen_ids, rates = drive(ctx, prompt, prompts512, V, (8, 32), "llama paged")
    all_counts = {"llama paged": read_counts(
        "llama paged", decode_keys + prefill_keys + paged_keys)}
    profile_decode(torch, qmm, ctx, steps=8)
    del ctx
    against_plain("llama paged", model, logits, gen_ids, prompt,
                  **{**paged_kw, "n_seqs": 2, "kv_total": 8192})
    log("llama paged rates (4-layer smoke run, not a benchmark; "
        f"{card}): " + json.dumps(rates))
    gctx = graph_phase("llama paged", model, paged_kw, prompt, gen_ids, prompts512, (8, 32),
                       decode_keys + prefill_keys + paged_keys)
    sampled_phase(gctx, model, {**paged_kw, "n_seqs": 2, "kv_total": 8192}, prompt, gen_ids)
    del gctx

    # the same prompt in one ubatch of 2048 rows: every quantized product of
    # 1024 rows or more takes the library route (bf16 operands, f32 sums),
    # so no qmm prefill kernel may launch; held against the 512-row ubatches
    ub_kw = dict(n_ctx=4096, n_seqs=2, n_ubatch=2048, quantized_kv=True, kv_total=8192)
    ctx = Context(model, **ub_kw)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_logits = ctx.prefill(prompt, seq=0)
    u_s = time.perf_counter() - t0
    u_ids = ctx.generate(prompt, max_new_tokens=32, seq=1)
    all_counts["llama ubatch 2048"] = read_counts("llama ubatch 2048", decode_keys + paged_keys)
    del ctx
    check_logits("llama ubatch 2048", u_logits, V)
    err = float(np.mean((u_logits - logits) ** 2) / (np.mean(logits ** 2) + 1e-30))
    agree = sum(int(a == b) for a, b in zip(u_ids, gen_ids))
    log(f"llama ubatch 2048 (library route) vs ubatches of 512 (kernels): prefill last-token "
        f"logits NMSE {err:.3e} (limit {NMSE_LIMIT}); greedy ids agree {agree}/{len(gen_ids)}; "
        f"first prefill {len(prompt) / u_s:.0f} tok/s (cuBLAS start-up included)")
    if not err < NMSE_LIMIT:
        failures.append(f"llama ubatch 2048: logits NMSE {err} against the 512-row ubatches")
    if agree != len(gen_ids) or len(u_ids) != len(gen_ids):
        failures.append(f"llama ubatch 2048: greedy ids agree {agree} of {len(gen_ids)}")

    # path B: the same model on the slot-table cache
    slots_kw = dict(n_ctx=4096, n_seqs=8, n_ubatch=512, quantized_kv=True, paged=False)
    ctx = Context(model, **slots_kw)
    log(f"path B: the same model under Context(paged=False): cache of {ctx.n_seqs} sequences x "
        f"{ctx.n_slots} slots")
    reset_counts()
    s_logits, s_ids, rates = drive(ctx, prompt, prompts512[:8], V, (8,), "llama slots")
    all_counts["llama slots"] = read_counts(
        "llama slots", decode_keys + prefill_keys + slots_keys)
    del ctx
    err = float(np.mean((s_logits - logits) ** 2) / (np.mean(logits ** 2) + 1e-30))
    log(f"llama slots vs llama paged: prefill last-token logits NMSE {err:.3e}; greedy ids "
        f"agree {sum(int(a == b) for a, b in zip(s_ids, gen_ids))}/{len(gen_ids)}")
    if not err < NMSE_LIMIT:
        failures.append(f"llama slots vs paged: logits NMSE {err}")
    against_plain("llama slots", model, s_logits, s_ids, prompt, **{**slots_kw, "n_seqs": 2})
    log(f"llama slots rates (4-layer smoke run, not a benchmark; {card}): " + json.dumps(rates))
    graph_phase("llama slots", model, slots_kw, prompt, s_ids, prompts512[:8], (8,),
                decode_keys + prefill_keys + slots_keys)

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
    all_counts["llama-cli"] = read_counts("path D (llama-cli)", decode_keys + paged_keys)
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
    path_e(model, llama_path, smoke_dir)
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
        "mixtral", decode_keys + prefill_keys + paged_keys + (expert_key,))
    profile_decode(torch, qmm, ctx, steps=8, qe=qmm_expert)
    del ctx
    against_plain("mixtral", model, m_logits, m_ids, prompt, **{**moe_kw, "n_seqs": 2})
    log(f"mixtral rates ({MOE_LAYERS}-layer smoke run, not a benchmark; {card}): "
        + json.dumps(rates))
    graph_phase("mixtral", model, moe_kw, prompt, m_ids, prompts512, (8,),
                decode_keys + prefill_keys + paged_keys + (expert_key,))
    del model
    torch.cuda.empty_cache()

    # heads of 64: a TinyLlama-1.1B-shaped model (depth cut 22 -> 2) on both memories
    path = os.path.join(smoke_dir, "tinyllama-q4km-2l.gguf")
    make_bench_llama_gguf(path, n_layers=2, n_embd=2048, n_heads=32, n_kv_heads=4, n_ff=5632,
                          vocab_size=VM, n_ctx=2048, seed=0)
    model = load_model(path)
    os.remove(path)
    prompt = [int(t) for t in prng.integers(3, VM, 700)]
    for label, kw, key in (("heads of 64, paged", dict(paged=True), paged_keys[0]),
                           ("heads of 64, slots", dict(paged=False), slots_keys[0])):
        kw = dict(n_ctx=2048, n_seqs=2, n_ubatch=512, quantized_kv=True, **kw)
        ctx = Context(model, **kw)
        reset_counts()
        d_logits = ctx.prefill(prompt, seq=0)
        d_ids = ctx.generate(prompt, max_new_tokens=32, seq=1)
        all_counts[label] = read_counts(label, (key,) + decode_keys + prefill_keys)
        check_logits(label, d_logits, VM)
        del ctx
        against_plain(label, model, d_logits, d_ids, prompt, **kw)
        graph_phase(label, model, kw, prompt, d_ids, [prompt[:512]], (1,),
                    (key,) + decode_keys + prefill_keys)
    log("heads of 64: the prefill ubatches go through the attention prefill kernel; a decode "
        "step has 8 rows a KV head, which the dispatch rule (heads under 128, fewer than 16 "
        "rows) sends to the plain einsum, as the JAX package does")
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
    source_of = {**{k: "flash_attn_paged.cu" for k in paged_keys},
                 **{k: "flash_attn.cu" for k in slots_keys},
                 "qmm_planes_expert": "qmm_expert.cu", **{k: "qmm_prefill.cu" for k in prefill_keys},
                 **{k: "qmm_decode.cu" for k in decode_keys},
                 **{name: "qmm_bench.cu" for name in qmm_bench.launches}}
    # launches: from the path that is the kernel's own (the llama path on the
    # pool, the slot-table path, the Mixtral path, the microbenchmark)
    path_of = {**{k: "llama slots" for k in slots_keys}, "qmm_planes_expert": "mixtral",
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
                        **({k: r[k] for k in ("kernel", "tile", "rows") if k in r})})
    log("decode loop, graphed and eager, ms a step by path and B (4-layer smoke run, not a "
        f"benchmark; {card}): " + json.dumps(graph_rows))
    log(f"card: {gpu_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
