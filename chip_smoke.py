#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (llama_cpp_tpu_torch) on one NVIDIA
H100.

    python3 chip_smoke.py        # about three minutes

Phases, each of which fails the run:
  1. the card's name and power limit, torch / CUDA / nvcc versions;
  2. build the CUDA kernels from the package's csrc/ (ptxas register and
     shared-memory lines printed);
  3. every kernel at the main path's shapes on the card, held against its
     plain PyTorch version (NMSE < 5e-3), timed by CUDA events (L2 flushed
     before each launch) beside its bound, the plain version and one
     PyTorch library call; the qmm GEMV and tensor-core GEMM are also timed
     against each other at 1-8 rows (the crossover the wrapper's
     GEMV_MAX_N is set from), and the attention kernel on a bf16 pool;
  4. the main path through the port's entry points: a Llama-3-8B-shaped
     Q4_K_M model (random weights from a seed, full width, depth cut to 4
     layers), load_model, a Context with a paged int8 KV pool, a 2048-token
     prefill, 32 greedy tokens at B=1 and decode_steps_greedy at B=8 and
     B=32 over 512-token prefills, with every kernel's launch counter read;
     the kernel path is held against the plain path (Context(kernels=False))
     on the prefill's last-token logits.
The last two lines are the kernels JSON object and
{"ok": true, "device": {...}}. Without a card, or without the port next to
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
NMSE_LIMIT = 5e-3  # the reference's conformance threshold
SMOKE_LAYERS = 4
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


class Timer:
    """Mean device time of fn over reps launches, by CUDA events around each
    launch, with the 50 MB L2 flushed before every launch (the main path
    reads each weight and KV page once per step). A spin kernel before the
    start event lets the host enqueue fn's launches ahead of the device, so
    the interval holds device time, not Python launch overhead."""

    SPIN_CYCLES = 2_000_000  # about 1 ms on an H100

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def plane_bytes(w) -> int:
    return sum(t.numel() * t.element_size() for t in (w.q, w.scales, w.mins, w.d, w.dmin)
               if t is not None)


def qmm_phase(torch, timer, qmm, label, weights, n_rows, failures, gemv_max_n=None):
    """Hold the qmm kernel against its plain version at each (weight, N);
    returns {N: numbers summed over the weights}. gemv_max_n forces the
    GEMV (8) or the GEMM (0); None keeps the wrapper's crossover."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    kw = {} if gemv_max_n is None else {"gemv_max_n": gemv_max_n}
    res = {}
    for n in n_rows:
        total = res[n] = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                          "max_abs_err": 0.0, "nmse": 0.0, "bytes_s": 0.0, "ops_s": 0.0}
        for wname, w in weights:
            K = w.in_features
            O = w.q.shape[1]
            x = torch.randn((n, K), generator=gen, device="cuda").to(torch.bfloat16)
            got = qmm.qmm(x, w, **kw)
            torch.cuda.synchronize()
            ref = qmm.qmm_plain(x, w)
            err = nmse(got, ref)
            mae = float((got - ref).abs().max())
            if not err < NMSE_LIMIT or not torch.isfinite(got).all():
                failures.append(f"{label} {wname} N={n}: NMSE {err}")
            ms = timer(lambda: qmm.qmm(x, w, **kw))
            plain_ms = lib_ms = float("nan")
            if gemv_max_n is None:
                wd = w.dequant(torch.bfloat16)
                plain_ms = timer(lambda: qmm.qmm_plain(x, w), reps=3)
                lib_ms = timer(lambda: torch.matmul(x, wd))
                del wd
            nbytes = n * K * 2 + plane_bytes(w) + n * O * 4
            flops = 2.0 * n * K * O
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
            bound = max(bytes_s, ops_s) * 1e3
            log(f"  {label:24s} {wname:12s} N={n:4d} K={K:5d} O={O:6d} "
                f"[{qmm.kernel_name(w, n, kw.get('gemv_max_n', qmm.GEMV_MAX_N))}] "
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


def attn_phase(torch, timer, fa, label, case, failures):
    import torch.nn.functional as F

    sm = 1.0 / 128 ** 0.5
    got = fa.flash_attention_paged(**{k: v for k, v in case.items() if k != "page"},
                                   sm_scale=sm, page=case["page"])
    torch.cuda.synchronize()
    ref = fa.flash_attention_paged_plain(**{k: v for k, v in case.items() if k != "page"},
                                         sm_scale=sm, page=case["page"])
    err = nmse(got, ref)
    mae = float((got - ref).abs().max())
    if not err < NMSE_LIMIT or not torch.isfinite(got).all():
        failures.append(f"{label}: NMSE {err}")
    args = {k: v for k, v in case.items() if k != "page"}
    ms = timer(lambda: fa.flash_attention_paged(**args, sm_scale=sm, page=case["page"]))
    plain_ms = timer(lambda: fa.flash_attention_paged_plain(**args, sm_scale=sm,
                                                            page=case["page"]), reps=3)
    # library yardstick: SDPA on the gathered, dequantized K/V (timed only)
    q, page, table = case["q"], case["page"], case["table_b"]
    B, Hkv, R, D = q.shape
    MP = table.shape[1]
    rows = (table.long()[:, :, None] * page + torch.arange(page, device="cuda")).reshape(B, -1)
    quantized = case["k_scale"] is not None
    kd = case["k"][:, rows].float()
    vd = case["v"][:, rows].float()
    if quantized:
        kd = kd * case["k_scale"][:, rows][..., None]
        vd = vd * case["v_scale"][:, rows][..., None]
    kd, vd = kd.permute(1, 0, 2, 3), vd.permute(1, 0, 2, 3)
    kd, vd = kd.to(torch.bfloat16).contiguous(), vd.to(torch.bfloat16).contiguous()
    cp = case["pos"][rows]
    rp = case["row_pos"]
    mask = ((cp[:, None, :] >= 0) & (cp[:, None, :] <= rp[:, :, None]))[:, None]
    lib_ms = timer(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask, scale=sm))
    # bound: q, the K/V rows (and scales) and position labels that some row
    # of the batch row can see (pos >= 0 and <= the row's largest position),
    # out; the operations of the unmasked (row, column) pairs
    kv_rows = int(((cp >= 0) & (cp <= rp.max(dim=1).values[:, None])).sum())
    row_bytes = 2 * D * case["k"].element_size() + (8 if quantized else 0)
    nbytes = q.numel() * 2 + kv_rows * (Hkv * row_bytes + 4) + q.numel() * 4
    flops = 4.0 * D * Hkv * float(mask.sum())
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else "operations"
    log(f"  {label:34s} B={B} R={R} MP={MP}  nmse={err:.2e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": bound_by, "max_abs_err": mae, "nmse": err}


def profile_decode(torch, ctx, steps: int):
    """Where a B=1 decode step's time goes: `steps` decode_one calls of
    sequence 0 timed by the host clock, then as many under torch.profiler
    for the device time by kernel (the profiler's own start-up cost makes
    its window's wall time meaningless, so the share uses the first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tok = 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok = int(ctx.decode_one(tok, seq=0).argmax())
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
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
        from llama_cpp_tpu_torch.ops.kernels import build, flash_attn, qmm
        from llama_cpp_tpu_torch.ops.qtensor import load_weight, pad_out_features
        from llama_cpp_tpu_torch.runtime.context import Context
        from llama_cpp_tpu_torch.testing import make_bench_llama_gguf, synth_quant_bytes
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
    timer = Timer(torch)
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
    log("qmm GEMV against the tensor-core GEMM at 1-8 rows (each held against plain):")
    for lay, ws in (("Q4_K", q4), ("Q6_K", q6)):
        gv = qmm_phase(torch, timer, qmm, f"{lay} forced gemv", ws, (1, 2, 4, 8), failures,
                       gemv_max_n=8)
        mm = qmm_phase(torch, timer, qmm, f"{lay} forced mma", ws, (1, 2, 4, 8), failures,
                       gemv_max_n=0)
        log(f"crossover {lay} (layer sums, ms; GEMV_MAX_N = {qmm.GEMV_MAX_N}): " + ", ".join(
            f"N={n} gemv {gv[n]['ms']:.4f} mma {mm[n]['ms']:.4f}" for n in gv))
    log("kernels vs plain at the main path's shapes (layer sums go to the JSON line):")
    q4r = qmm_phase(torch, timer, qmm, "K1 qmm4_planes", q4, (1, 8, 32), failures)
    q4p = qmm_phase(torch, timer, qmm, "K3 qmm4_planes_prefill", q4, (512,), failures)
    q6r = qmm_phase(torch, timer, qmm, "K2 qmm_planes", q6, (1, 8, 32), failures)
    qmm_phase(torch, timer, qmm, "K2 qmm_planes (head)", head, (1, 8, 32), failures)
    q6p = qmm_phase(torch, timer, qmm, "K4 qmm_planes_prefill", q6, (512,), failures)
    del q4, q6, head
    # one JSON entry per (TPU kernel, CUDA kernel): the GEMV at N=1, the GEMM
    # at the B=32 decode step and at the prefill ubatch
    res = {"qmm4_planes/gemv": q4r[1], "qmm4_planes/mma": q4r[32],
           "qmm4_planes_prefill/mma": q4p[512], "qmm_planes/gemv": q6r[1],
           "qmm_planes/mma": q6r[32], "qmm_planes_prefill/mma": q6p[512]}
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
    torch.cuda.empty_cache()
    if failures:
        for f in failures:
            log(f"FAIL {f}")
        return 1

    # -- phase 4: the main path ----------------------------------------------
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
    t_load = time.perf_counter() - t0
    log(f"load_model: {t_load:.1f} s")
    lw0 = model.params["layers"][0]
    log("layer 0 weights: " + ", ".join(
        f"{k}:{'packed' if getattr(w, 'packed', False) else ''}{tuple(w.q.shape) if hasattr(w, 'q') else tuple(w.shape)}"
        for k, w in lw0.items()))
    ctx = Context(model, n_ctx=4096, n_seqs=32, n_ubatch=512, quantized_kv=True,
                  kv_total=40960)
    log(f"context: page {ctx.page}, pool pages {ctx.alloc.n_pages}, slots/seq {ctx.n_slots}")
    prng = np.random.default_rng(7)
    prompt = [int(t) for t in prng.integers(3, 128256, 2048)]
    prompts512 = [[int(t) for t in prng.integers(3, 128256, 512)] for _ in range(32)]

    for counter in (qmm.launches, flash_attn.launches):
        for key in counter:
            counter[key] = 0
    rates = {}
    # one untimed ubatch first: the caching allocator's first device
    # allocations and first launches belong to start-up, not to the rate
    ctx.prefill(prompt[:512], seq=2)
    ctx.seq_rm(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = ctx.prefill(prompt, seq=0)
    rates["prefill_2048_tok_per_s"] = 2048 / (time.perf_counter() - t0)
    n0, t_dec0 = ctx.perf.n_decode, ctx.perf.t_decode_ms
    gen_ids = ctx.generate(prompt, max_new_tokens=32, seq=1)
    rates["decode_b1_d2048_tok_per_s"] = (ctx.perf.n_decode - n0) / (
        (ctx.perf.t_decode_ms - t_dec0) / 1e3)
    ctx.reset()
    for s, p in enumerate(prompts512):
        ctx.prefill(p, seq=s)
    firsts = np.asarray([1 + s for s in range(32)], np.int32)
    for B in (8, 32):
        seqs = np.arange(B)
        ctx.decode_steps_greedy(firsts[:B], seqs, 2)  # warm step shapes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ctx.decode_steps_greedy(firsts[:B], seqs, 16)
        rates[f"decode_steps_greedy_b{B}_d512_tok_per_s"] = B * 16 / (time.perf_counter() - t0)
        if out.shape != (B, 16) or out.min() < 0 or out.max() >= V:
            failures.append(f"decode_steps_greedy B={B}: bad ids {out.shape}")
    torch.cuda.synchronize()
    counts = {**qmm.launches, **flash_attn.launches}
    log(f"main path launches: {counts}")
    for name, n in counts.items():
        if n <= 0:
            failures.append(f"kernel {name} was not launched on the main path")
    if logits.shape != (V,) or not np.isfinite(logits).all():
        failures.append(f"prefill logits: shape {logits.shape}, finite "
                        f"{bool(np.isfinite(logits).all())}")
    profile_decode(torch, ctx, steps=8)

    # the plain path on the same model, as the reference of the kernel path
    ref_ctx = Context(model, n_ctx=4096, n_seqs=2, n_ubatch=512, quantized_kv=True,
                      kv_total=8192, kernels=False)
    ref_logits = ref_ctx.prefill(prompt, seq=0)
    ref_ids = ref_ctx.generate(prompt, max_new_tokens=32, seq=1)
    err = float(np.mean((logits - ref_logits) ** 2) / (np.mean(ref_logits ** 2) + 1e-30))
    agree = sum(int(a == b) for a, b in zip(gen_ids, ref_ids))
    log(f"kernel vs plain path: prefill last-token logits NMSE {err:.3e} "
        f"(limit {NMSE_LIMIT}); greedy ids agree {agree}/{len(ref_ids)} "
        f"(argmax {int(np.argmax(logits))} vs {int(np.argmax(ref_logits))})")
    if not err < NMSE_LIMIT:
        failures.append(f"main path logits NMSE {err}")
    log("main path rates (4-layer smoke run, not a benchmark; "
        f"{card}): " + json.dumps(rates))
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
    }
    kernels = []
    for name, r in res.items():
        src = ("llama_cpp_tpu_torch/csrc/flash_attn_paged.cu" if name.startswith("flash")
               else "llama_cpp_tpu_torch/csrc/qmm.cu")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu_of[name.split("/")[0]],
                        "launches": counts[name], "max_abs_err": r["max_abs_err"],
                        "nmse": r["nmse"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(f"card: {gpu_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
