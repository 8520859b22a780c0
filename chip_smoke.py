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
     K1-K4 at the hybrid families' widths (Nemotron-H-8B's ssm_in of 18560
     columns, 145 tiles of 128, its ssm_out and relu^2 FFN; Qwen3-Next's
     ssm_in, attn_qk, attn_gate, ssm_out and shared-expert down) and at
     BGE-M3's layer (1024 wide, FFN 4096), held at 1-1023 rows and timed at
     N = 1, 8, 512;
     the attention kernels (a prefill kernel from PREFILL_MIN_ROWS rows a
     KV head, a decode kernel below it; each held call must launch its
     route's kernel once) at decode B = 1, 8, 32 and at a prefill ubatch, on
     an int8 and a bf16 pool, with heads of 32, 64 and 256 (and
     Qwen3-Next's 2 KV heads of 256 at G = 8), then both
     kernels forced at 16-512 rows and depths 2048 and 128 to read the
     route threshold; the
     indexed-expert kernel at Mixtral-8x7B, Qwen3-30B-A3B and DeepSeek-V3
     expert shapes (R = 8, 64 and 64 rows drawn from 16 experts; V3's 256
     experts of 7168 x 2048 at R = 8 and 64; gpt-oss-20B's MXFP4 stacks of
     32 x 2880 x 2880 at R = 4 and 32, 2880 being 45 stages of 64 rows and
     22 column tiles of 128 and a half; Llama-4-Scout's 16 x 5120 x 8192
     gate and 16 x 8192 x 5120 down stacks at R = 1 and 8; Qwen3-Next's
     512 x 2048 x 512 gate and 512 x 512 x 2048 down stacks at R = 10 and
     80),
     the slot-table attention kernels at the same depths as the paged ones,
     and with 64-wide heads, and in ring mode at a Gemma-3-4B window layer
     (1792 slots, 4 KV heads of 256, window 1024, positions past the wrap:
     decode B=8 and a 512-row ubatch, each held call one ring launch; the
     ring decode beside the slot-table decode at that shape and a live depth
     of 1024); the MLA instantiation of both (csrc/flash_attn_mla.cuh: one
     KV head of K 640 and V 512) at G = 16 (DeepSeek-V2-Lite) and G = 128
     (DeepSeek-V3) query heads, decode B = 1 and 8 at depth 2048 and the
     ubatch 4 of 2048, int8 and bf16, and at K 576 (the conformance rows'
     width), and its (384, 256) pair at MiniCPM3-4B's G = 40 (decode B = 1
     at depth 2048 and the ubatch, int8 and bf16), with its ptxas lines and
     shared memory;
     the microbenchmark's
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
     build/conformance_h100.csv (120 of 120 rows, the two MLA rows through
     the MLA instantiation); a FAIL row fails the run unless
     KNOWN_FAULTS names it; then the storage-type sweep: every plane type
     of quant/repack.py at Qwen3-8B's ffn_down and fused ffn_gateup shapes
     from synthetic bytes through load_weight, qmm at N = 1, 8, 512 against
     qmm_plain with each launch read by name, seven types timed at N = 1, 8
     (SWEEP_TIMED), and K7 on Q8_0 expert stacks at Qwen3-30B-A3B's shapes;
  4. the main paths through the port's entry points, each with the launch
     counters set to 0 before it and read after it, and each held against
     the plain path (Context(kernels=False)) on the prefill's last-token
     logits and greedy ids:
     - a Llama-3-8B-shaped Q4_K_M model (random weights from a seed, full
       width, depth cut to 1 layer), load_model, a Context with a paged
       int8 KV pool, a 2048-token prefill, 32 greedy tokens at B=1 and
       decode_steps_greedy at B=8 and B=32 over 512-token prefills;
     - the same model and prompt with one ubatch of 2048 rows, whose
       products of 1024 rows and more take the library route (bf16
       operands, f32 sums), held against the 512-row ubatches (logits NMSE
       and 32 of 32 greedy ids);
     - the same model on the slot-table cache (Context(paged=False)): every
       attention goes through the slot-table kernels;
     - a Mixtral-8x7B-shaped MoE model (full width, depth cut to 1 layer):
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
       1-layer llama file, text in and text out: greedy, held against
       Context.generate on the encoded prompt, sampled under a seed twice,
       and constrained by a GBNF grammar (--grammar), held against
       Context.generate with the same chain behind the same grammar;
     - path E, the measurement tools on the same file: llama-bench
       (tools/bench_tool.py, pp512 and tg32 through generate_ondevice, then
       the batched grid at B = 1 and 8), llama-perplexity
       (tools/perplexity.py, 2 chunks of 512 of a seeded text, the vocab
       head through K4 at 512 rows), its ln PPL within 1e-3 of the same run
       under Context(kernels=False), and llama-results (tools/results.py),
       recorded and checked with no drift;
     - path F, llama-server (llama_cpp_tpu_torch.server.app run_server, the
       standard library's HTTP server over the continuous-batching
       scheduler) on the same loaded model, -np 4 --kv-quant, n_ctx 4096,
       graphed and under Context(graphs=False): three rounds of four
       concurrent greedy /completion requests of 32 tokens (the first
       captures; the second's ids equal Context.generate's, 32 of 32; the
       third streamed, timed to the first token), every scheduler decode
       step after the first round a graph replay, a streamed chat equal to
       the non-streamed one, a request at temperature 0.8 and seed 1 twice
       (equal text), /metrics' tokens_predicted_total equal to the
       replies' tokens; the served tok/s and times to first token, the
       buckets captured and their memory, and the host sampler chain's and
       the JSON grammar's time on 128256 logits;
     after the pool, slot-table, Mixtral and heads-of-64 paths, the graph
     phase of that path: the decode loop on CUDA graphs
     (runtime/decode_graph.py) against the same step launched eagerly
     (Context(graphs=False)): decode_steps_greedy at each batch size the
     path drives (16 of 16 ids a row equal), 100 consecutive replays at
     B=1, the kernel set a replay launches (torch.profiler) equal to the
     eager step's, wall and device ms a step and the device's busy share at
     B = 1 and the path's batch sizes, and generate_ondevice (greedy, 32
     tokens, chunk 32) against Context.generate's ids; on the pool path
     also the server's one-step calls at B = 1, 4, 8 (decode_step_multi's
     logits within NMSE 5e-3 of eager with equal argmax, decode_step_greedy's
     ids equal, wall and device ms a call, busy share and kernel set, by
     tools/decode_wall.measure_steps) and generate_ondevice sampled (temp
     0.8, top_k 40, seed 1) twice: equal ids, each inside the top 40 of the
     plain path's teacher-forced logits, and top_k 1 equal to greedy;
     - the Qwen and Gemma families on the shared decoder, each at full width
       with random weights from a seed, Context(n_ctx=4096, n_seqs=8,
       n_ubatch=512, quantized_kv=True): a 2048-token prefill, 32 greedy
       tokens at B=1, decode_steps_greedy at B=8, the B=1 profile, the plain
       path on the prefill logits (NMSE 5e-3), on 8 teacher-forced decode
       steps' logits and on the greedy ids, then the graph phase at B=8:
       Qwen3-8B (depth 36 -> 1; K1-K5; then one round of four concurrent
       16-token greedy /completion requests through run_server, graphed,
       ids against Context.generate), Qwen3-30B-A3B (48 -> 1, all 128
       experts; K1-K5 and K7 at R = 8 and 64) and Gemma-3-4B (34 -> 6, one
       period of its pattern: five window layers on ISWA rings of 1792
       slots through K6 in ring mode, one full layer on the pool through
       K5; the tied 262208-row head on the library route, timed);
     - the 2-D planes cut on the card (quant/device_planes.py): every
       quantized 2-D tensor of a 2-layer Gemma-3n-E4B file and 4096 x 4096
       matrices of Q8_0, Q4_0, Q5_0 and MXFP4, as matmul weights and as
       tables, bit for bit the host's extraction, with both routes'
       seconds; Gemma-3n-E4B (35 -> 6 layers, the last a window layer
       sharing the KV of the last owned one; AltUp, LAUREL, per-layer
       inputs, activation sparsity; the types llama-quantize gives under
       Q4_K_M; scales / 256) through the full treatment above (K1-K6, ring
       launches included), then a check that its shared layers own and
       write no line; narrow gemma4 (window heads of 128, full heads of
       256, a shared tail layer, V from K, the dual-branch MoE on K7) and
       minimax-m3 (a dense-lead layer on K6 over the DSAMemory's slot
       table, an MSA layer with K7 experts), each as the narrow families;
       and a gemma4-assistant speculation round over a Gemma 4 target,
       its ids the target's greedy ids;
     - embeddings and rerank: Qwen3-Embedding-8B (Qwen3-8B's stack, the
       qwen3-8b path's 1-layer model) through Context.embed(pooling="last")
       at 512 tokens (a 512-row forward over a 520-slot table: the prefill
       GEMM, the einsum attention, as the JAX package's flash_supported
       wants slots in 128s); BGE-M3 (BAAI/bge-m3 in GGUF as bert, full
       width and depth, 24 layers) through Context.embed at 7, 512 and 1000
       tokens (K3/K4 at the 512-row buckets, no kernel at 1024 rows), each
       pooling and the unpooled rows against the plain path, the ms of an
       embed, a profile of the 512-token one, and a served round
       (/v1/embeddings of 4 inputs, /v1/rerank of 8 documents) against
       Context.embed computed directly; then the 10
       other embedding entries at 2 layers of n_embd 1024 on the Q4_K_M
       mix, each held against the plain path with its launches read
       (t5encoder through Context.encode at 7 tokens, the decode kernel,
       and 200, the prefill GEMM);
     - DeepSeek's Multi-head Latent Attention, Context as the families':
       DeepSeek-V2-Lite (27 -> 2 layers: one dense, one MoE of 64
       experts; the paged MLA decode kernel at B=1, its prefill kernel at
       the ubatches; the graph phase at B=8, the B=1 profile, a served
       round), then on that model the attn_k_b/attn_v_b file against the
       attn_kv_b file (bit for bit), context_shift on the pool and the slot
       table (K6's MLA instantiation) against the plain path shifted alike
       and a sequence's state round trip (bit for bit); DeepSeek-V3 (61 ->
       1 layer: one MoE of 256 experts; every attention on the
       MLA prefill kernel, 128 rows at B=1); each with every matrix's route
       on its path line and the plain path on the prefill logits, 8
       teacher-forced steps and the ids (near_ties);
     - the dense-decoder families that differ from llama only in block
       variants, Context as the families': StarCoder2-7B (depth 32 -> 1:
       LayerNorm with biases, biased q/k/v and output, a non-gated GELU FFN
       of 18432 with biases, 36 query heads on 4 KV heads, so K5 at G = 9;
       the Qwen3-8B path's whole treatment with near_ties, a served round
       included) and Command-R v01 (40 -> 1: one LayerNorm feeding a
       parallel residual, 64 KV heads of 128, the tied 256000-row head on
       the library route; 16 greedy tokens, the graph phase); then every
       other entry of testing.FAMILY_LAYOUTS at 2 layers of n_embd 1024 with
       heads of 128: a 160-token prefill and 16 greedy tokens, every kernel
       its matrices and memory route to read from the counters and no other
       (an ALiBi entry launches no K5/K6), the plain path on the logits and
       each id held teacher-forced; the MoE families of
       testing.MOE_FAMILY_LAYOUTS (the clamped oai GLU, sparsemixer, the gate
       on the expert input, dense FFNs beside experts, arctic's branch,
       GroveMoE's chunk experts, shared experts, selection biases, per-layer
       window patterns) among them, K7 launched at their decode steps;
     - the MoE families at full width, Context as the families': gpt-oss-20B
       (depth 24 -> 2: a window layer of 128 on an ISWA ring through K6 in
       ring mode and a full layer on the pool through K5, both with sinks
       at the prefill ubatches; 32 MXFP4 experts of 2880 with biases and the
       clamped GLU, top 4, on K7; every dense product and the head on the
       library route, where the JAX package leaves them to XLA, timed at N =
       1; YaRN factor 32) and Llama-4-Scout-17B-16E (48 -> 1: K1-K5, K5 at G
       = 5, 16 experts of 8192 top 1 with the gate on the
       expert input on K7 at B = 1 and 8, a shared expert), each with the
       Qwen3-8B path's whole treatment with near_ties and a served round;
       a narrow gpt-oss at the default synthetic scale (logged);
     - the recurrent and hybrid memories at full width, Context as the
       families' (a HybridMemory: the recurrent state beside the pool;
       ubatches and decode batches at their exact shapes, a graph a batch
       size): Qwen3-Next-80B-A3B (depth 48 -> 4: three gated-DeltaNet
       layers and a gated attention layer, K5 at 2 KV heads of 256 and G =
       8; 512 experts of 512, top 10, on K7 at B = 1 and 8) and
       Nemotron-H-8B (the first 8 of its 52 blocks: four Mamba-2, three
       relu^2 FFN blocks, NoPE attention at 7; K1-K5), each with the
       Qwen3-8B path's whole treatment with near_ties and a served round;
       then the 12 other recurrent and hybrid entries as the dense
       families' narrow paths, on the Q4_K_M mix (K5 where their heads take
       it), lfm2 and lfm2moe on F32 values beside a reading of their Q4_K_M
       files against an f32 path;
     - RWKV on the recurrent memory (models/rwkv.py, the RecurrentState
       alone): RWKV-7 World 2.9B (depth 32 -> 2, so the value residual
       crosses layers; K1-K4 on its projections, the wkv7 step loop plain)
       with the Qwen3-8B path's whole treatment with near_ties, a served
       round and a state round trip (whole file and sequence blob, bit for
       bit); rwkv6, rwkv6qwen2 and arwkv7 narrow (heads of 64);
     - MLA at MHA width: MiniCPM3-4B (depth 62 -> 1: every attention on K5's
       MLA instantiation at (384, 256), the tied 73448-row head on the
       library route) with the same treatment, then on the slot table int8
       and the pool and the slot table bf16 (K6's or K5's MLA launches at
       prefill and decode read from the counters, each held to the plain
       path); plm, mistral4 and the other last decoder families (hy_v3,
       apertus, bitnet, talkie, chameleon, jais2, maincoder, pangu-embedded,
       deci) narrow;
     - the diffusion LMs (runtime/diffusion.py): LLaDA-8B (depth 32 ->
       2, bidirectional) through llama-diffusion-cli (max_length 128, 16
       steps, confidence), timed, K3/K4 alone launched in every step, then
       the same loop and the block schedule with each step held
       teacher-forced against the plain path (the logits at the masked
       positions within the limit, the commits the plain ranking's wherever
       its gap at the cut exceeds DIFFUSION_MARGIN times the two paths'
       largest confidence difference, each id the plain argmax or a
       near-tie); dream, llada-moe and rnd1 narrow, 4 steps each;
     - T5's encoder-decoder: flan-t5-large (24 + 24 -> 4 + 4 layers)
       through Context.generate from a 96-token prompt (the encoder and the
       cross K/V projections on K3/K4, the decoder steps eager on K1/K2),
       encode and step times, the plain path on the logits, 8 teacher-forced
       steps and each id, a batch of 3 with encoder outputs of 96, 40 and 200
       rows against their B=1 runs, a served round;
     - the last shared-decoder entries narrow: afmoe (sigmoid output gate,
       periodic NoPE, post-norms, a window layer on K6's ring), laguna (the
       softplus gate per head and, a second path, per element; its window
       layer roping 64 dims), openelm (per-layer heads: its first layer at
       fewer KV heads on the einsum path) and nanbeige (the stack looped
       twice), K7 at the MoE entries' decode steps;
     - the storage types users download beside Q4_K_M: Qwen3-8B at Q8_0
       (depth 36 -> 1, every matrix Q8_0: K2 and K4 over int8 flat-g32
       planes, no other qmm kernel; the families' whole treatment), at
       Q5_K_M and at Q4_0 (depth 1: prefill 2048, 16 greedy tokens, B=8,
       the plain path on the logits and the ids); then path Q, the port's
       llama-quantize on this machine: an F16 Qwen3-0.6B-shaped file through
       tools/quantize_tool.main to q8_0 and q4_0, each loaded and held
       against the plain path, and on the Q8_0 file generate_ondevice and a
       served round of four 32-token requests against Context.generate,
       with at least 4 distinct ids each. Paths whose greedy ids vary hold
       each id teacher-forced against the plain path (against_plain's
       near_ties rule; on a model with experts the plain path's routers
       are held to the kernel path's choice where the two part and the
       router inputs agree within the limit, testing.RouteHold, and every
       teacher-forced step's logits stay within the limit);
     - path S, what llama-cli and llama-server had refused, on that Q8_0
       model and path Q's files: speculative_generate with the n-gram
       lookup and with a self-draft at n_draft 4 and 8 (each verify step's
       attention kernel read from the counters: the decode kernel at 8
       rows, the prefill kernel at 16), the 0.6B q4_0 drafting for its
       q8_0 (acceptance strictly between 0 and 1) and the 0.6B for Qwen3-8B;
       save_state/load_state and save_seq_state/load_seq_state bit for bit
       on the pool and the slot table; context_shift on both, graphed
       against eager, against the plain path and (one layer) a fresh
       context; a seeded LoRA and control vector against the plain path,
       the base products on K2/K4 only, scale 0 and removal bit for bit;
       and, on the llama paths, llama-cli's --spec-ngram, --prompt-cache
       (twice), -cnv, --lora/--control-vector and --no-quant (the file
       loaded dense, against the quantized model's plain path), and
       llama-server's --spec ngram round, slot save/erase/restore, /tools
       over --mcp and a 600-token request through context shifts at -c 512;
     Launch counts include every graph replay (a graph adds its step's
     launches at each replay).
Before the last two lines: the card's name and power limit, and the
seconds of each section (the build, phase 3, the fixture writes and the
loads summed, each path). The last two lines are the kernels JSON object
and {"ok": true, "device": {...}}. Without a card, or without the port next to
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
NMSE_LIMIT = 5e-3  # the reference's conformance threshold
SMOKE_LAYERS = 1  # Llama-3-8B: 32 layers; one keeps the call's time
CLI_PROMPT = "the cat is on the mat and that was the end of it"
CLI_GRAMMAR = 'root ::= (" w" [0-9]+)+'  # the fixture's word pieces, " w0" ... " w127999"
GRAMMAR_TOKENS = 6
SERVER_PROMPTS = (CLI_PROMPT, "a long story: " + CLI_PROMPT * 4, "the mat was on the cat",
                  "and that was the end")  # the second takes the prefill kernels (>= 64 rows)
MOE_LAYERS = 1  # experts are 97% of a Mixtral layer's bytes
QWEN3_LAYERS = 1  # Qwen3-8B: 36 layers
QWEN3MOE_LAYERS = 1  # Qwen3-30B-A3B: 48 layers, all 128 experts each
GEMMA3_LAYERS = 6  # Gemma-3-4B: 34 layers; one period of its pattern (five window, one full)
# Gemma-3n-E4B: 35 layers, the last 15 sharing KV; cut to one period of its
# pattern (four window, one full) and one shared window layer, for the
# call's time; the full class's sharing is held on the CPU
# (tests/test_torch_gemma3n.py)
GEMMA3N_LAYERS, GEMMA3N_SHARED = 6, 1
QWEN3_MIX_LAYERS = 1  # Qwen3-8B at Q5_K_M and Q4_0
QUANT_LAYERS = 2  # the F16 Qwen3-0.6B file llama-quantize turns into q8_0 and q4_0: 28 layers
DS_LITE_LAYERS = 2  # DeepSeek-V2-Lite: 27 layers; one dense, one MoE
DS_V3_LAYERS = 1  # DeepSeek-V3: 61 layers; one MoE layer of 256 experts (~14 GB; 2 until PR 20)
STARCODER2_LAYERS = 1  # StarCoder2-7B: 32 layers (2 until PR 20)
COMMAND_R_LAYERS = 1  # Command-R v01: 40 layers
GPT_OSS_LAYERS = 2  # gpt-oss-20B: 24 layers; a window layer and a full one
SCOUT_LAYERS = 1  # Llama-4-Scout-17B-16E: 48 (2 until PR 20); its NoPE layers: llama4's narrow path
QWEN3NEXT_LAYERS = 4  # Qwen3-Next-80B-A3B: 48 layers; three DeltaNet layers, one attention
NEMOTRON_H_LAYERS = 8  # Nemotron-H-8B: 52 blocks; M-M-M-M*: four Mamba-2, three FFN, one attention
BGE_M3_LAYERS = 24  # BAAI/bge-m3: 24 layers, run at full depth
RWKV7_LAYERS = 2  # RWKV-7 World 2.9B: 32 layers; 2 carry v_first across a layer
MINICPM3_LAYERS = 1  # MiniCPM3-4B: 62 layers
LLADA_LAYERS = 2  # LLaDA-8B: 32 layers
T5_LAYERS = 4  # flan-t5-large: 24 encoder and 24 decoder layers, each stack cut alike
# a diffusion step's commits must be the plain path's wherever the plain
# confidence ranking's gap at the cut exceeds this many times the step's
# largest confidence difference between the kernel and the plain path
DIFFUSION_MARGIN = 2.0
# the narrow RWKV entries: FAMILY_SHAPE's widths with heads of 64 and LoRA
# ranks of 32 (64 for RWKV-7's gate)
RWKV_SHAPE = dict(n_layers=2, n_embd=1024, head_size=64, n_ff=2048, vocab_size=2048,
                  lora=(32, 32, 32, 64))
# the embedding entries other than bert: narrow, heads of 128, 2 layers
EMBED_SHAPE = dict(n_layers=2, n_embd=1024, n_heads=8, n_ff=2048, vocab_size=2048)
EMBED_POOLINGS = ("mean", "cls", "last", "none")
# the other dense-decoder families: narrow, heads of 128, 2 layers
FAMILY_SHAPE = dict(n_layers=2, n_embd=1024, n_heads=8, n_kv_heads=4, head_dim=128, n_ff=2048,
                    vocab_size=2048, n_ctx=4096)
FAMILY_PROMPT = 160  # tokens: 320 rows a KV head, the prefill kernels' route
# the narrow hybrids whose synthetic Q4_K_M blocks are ill-conditioned: the
# kernel and the plain path part by more than the limit, each about as far
# from an f32 path as the other (logged by f32_reading); their narrow paths
# run on F32 values
F32_FAMILIES = ("lfm2", "lfm2moe")
# synthetic block scales of the StarCoder2-7B and family files, divided by
# 256 (Q4_K weights of about 1/sqrt(4608) at most, logits of unit spread):
# at the default scale (weights up to about 19) a biased model's attention is
# near one-hot, and there the kernels' bf16 rounding of q and P (the JAX
# package's kernels' too) and the plain path's f32 (the residual that a bias
# promotes to f32) pick other keys; the default is logged below
FAMILY_SYNTH_SCALE = 1.0 / 256
# conformance rows that fail for a fault open in ROADMAP.md queue 3:
# (kernel, config); printed as "known fault" with their NMSE
KNOWN_FAULTS: tuple[tuple[str, str], ...] = ()
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


def captured(loops) -> str:
    """A context's decode loops: (batch bucket, sampler; MiB of device
    memory its capture reserved)."""
    def name(smp):
        return "logits" if smp is None else "greedy" if smp.greedy else str(smp)

    return ", ".join(f"({b}, {name(smp)}; {loop.graph_bytes / 2 ** 20:.1f})"
                     for (b, smp), loop in sorted(loops.items(),
                                                  key=lambda kv: (kv[0][0], str(kv[0][1]))))


def ptxas_of(text: str, marker: str) -> list[str]:
    """ptxas's register and spill lines of the entry functions whose mangled
    name holds `marker`, each after its template arguments."""
    out, entry = [], ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            entry = (name.split("ILi", 1)[1].split("EEEv")[0].replace("ELi", ",")
                     .replace("ELb", ",") if marker in name else "")
        elif entry and ("Used" in ln or "spill" in ln):
            out.append(f"<{entry}> {ln.split(':', 1)[-1].strip()}")
    return out


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


def attn_case(torch, B, G, T, depth, page=512, Hkv=8, D=128, seed=0, kv_dtype=None, Dv=None):
    """Random pool (int8 with row scales, or bf16 without) with each batch
    row's `depth` cached positions plus its T new rows at positions depth ..
    depth+T-1; V rows of Dv (default D)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    Dv = Dv or D
    n_tok = depth + T
    mp = -(-n_tok // page) + 1
    n_pages = B * mp + 1
    S_pool = n_pages * page
    if kv_dtype is torch.bfloat16:
        k = (torch.randn((Hkv, S_pool, D), generator=gen, device="cuda")).to(torch.bfloat16)
        v = (torch.randn((Hkv, S_pool, Dv), generator=gen, device="cuda")).to(torch.bfloat16)
        ks = vs = None
    else:
        k = torch.randint(-127, 128, (Hkv, S_pool, D), generator=gen, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (Hkv, S_pool, Dv), generator=gen, device="cuda",
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
                 quantized, failures, window=0, ring=False):
    """Hold an attention kernel (run) against its plain version (run_plain)
    and time both, beside SDPA on the gathered, dequantized K/V kd, vd
    [B, Hkv, S, D] with the same mask (library yardstick, timed only).
    The held call must launch the CUDA kernel of its route (name/prefill or
    name/decode) once and nothing else (and, for a ring, count one ring
    launch of it).
    cp [B, S] are the columns' position labels, rp [B, R] the rows'; a
    window > 0 masks columns at or below a row's position less the window.
    Bound: q, the K/V rows (and scales) and position labels that some row of
    the batch row can see (pos >= 0, <= the row's largest position and
    inside the window of its smallest), out; the operations of the unmasked
    (row, column) pairs."""
    import torch.nn.functional as F

    B, Hkv, R, D = q.shape
    Dv = vd.shape[-1]
    sm = 1.0 / D ** 0.5
    key = f"{name}/{'mla ' if fa.is_mla(D, Dv) else ''}{fa.route(R)}"
    before, ring_before = dict(fa.launches), dict(fa.ring_launches)
    got = run(sm)
    torch.cuda.synchronize()
    if fa.launches != {**before, key: before[key] + 1}:
        failures.append(f"{label}: expected one launch of {key}, counts went from {before} "
                        f"to {fa.launches}")
    ring_want = {**ring_before, f"{key} ring": ring_before[f"{key} ring"] + 1} if ring \
        else ring_before
    if fa.ring_launches != ring_want:
        failures.append(f"{label}: ring launches went from {ring_before} to "
                        f"{fa.ring_launches}, expected {ring_want}")
    ref = run_plain(sm)
    valid = rp >= 0
    g, r = got.transpose(1, 2)[valid], ref.transpose(1, 2)[valid]
    err = nmse(g, r)
    mae = float((g - r).abs().max())
    if not err < NMSE_LIMIT or not torch.isfinite(g).all():
        failures.append(f"{label}: NMSE {err}")
    ms = timer(lambda: run(sm))
    plain_ms = timer(lambda: run_plain(sm), reps=3)
    mask = (cp[:, None, :] >= 0) & (cp[:, None, :] <= rp[:, :, None])
    if window:
        mask = mask & (cp[:, None, :] > rp[:, :, None] - window)
    mask = mask[:, None]
    lib_ms = timer(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask, scale=sm))
    seen = (cp >= 0) & (cp <= rp.max(dim=1).values[:, None])
    if window:
        seen = seen & (cp > rp.min(dim=1).values[:, None] - window)
    kv_rows = int(seen.sum())
    row_bytes = (D + Dv) * kv_elem + (8 if quantized else 0)
    nbytes = q.numel() * 2 + kv_rows * (Hkv * row_bytes + 4) + B * Hkv * R * Dv * 4
    flops = 2.0 * (D + Dv) * Hkv * float(mask.sum())
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else "operations"
    log(f"  {label:38s} [{key.split('/')[1]}] B={B} R={R} D={D}"
        f"{f'/{Dv}' if Dv != D else ''} nmse={err:.2e} ms={ms:.4f} "
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


def slots_case(torch, B, G, T, depth, n_seqs=8, S=5120, Hkv=8, D=128, seed=0, kv_dtype=None,
               Dv=None):
    """Random slot-table cache (int8 with row scales, or bf16) of n_seqs
    sequences of S slots; batch row b reads sequence n_seqs - 1 - b, which
    holds `depth` cached positions plus the T new rows; V rows of Dv
    (default D)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    Dv = Dv or D
    n_tok = depth + T
    if kv_dtype is torch.bfloat16:
        k = torch.randn((n_seqs, Hkv, S, D), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((n_seqs, Hkv, S, Dv), generator=gen, device="cuda").to(torch.bfloat16)
        ks = vs = None
    else:
        k = torch.randint(-127, 128, (n_seqs, Hkv, S, D), generator=gen, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (n_seqs, Hkv, S, Dv), generator=gen, device="cuda",
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


def ring_case(torch, B, G, T, n_pos, S=1792, window=1024, Hkv=4, D=256, seed=0):
    """Random int8 window ring (row scales) of B sequences of S slots, the
    last the trash slot, at a Gemma-3-4B window layer's shape by default:
    sequence b holds positions n_pos - (S - 1) .. n_pos - 1 at slot
    position % (S - 1) (n_pos past S - 1: the ring has wrapped), its T new
    rows the last T of them; each row sees the `window` positions up to its
    own."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cap = S - 1
    k = torch.randint(-127, 128, (B, Hkv, S, D), generator=gen, device="cuda", dtype=torch.int8)
    v = torch.randint(-127, 128, (B, Hkv, S, D), generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand((B, Hkv, S), generator=gen, device="cuda") * 0.02 + 0.005
    vs = torch.rand((B, Hkv, S), generator=gen, device="cuda") * 0.02 + 0.005
    pos = torch.full((B, S), -1, dtype=torch.int32, device="cuda")
    held = torch.arange(max(0, n_pos - cap), n_pos, dtype=torch.int32, device="cuda")
    pos[:, held.long() % cap] = held
    q = (torch.randn((B, Hkv, G * T, D), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    rp = (n_pos - T + torch.arange(T, device="cuda", dtype=torch.int32)).repeat(G)
    return dict(q=q, k=k, v=v, row_pos=rp[None, :].expand(B, G * T).contiguous(), col_pos=pos,
                seq_idx=(B - 1 - torch.arange(B, device="cuda")).to(torch.int32), k_scale=ks,
                v_scale=vs, window=window, ring=True)


def slots_phase(torch, timer, fa, label, case, failures):
    """The slot-table kernel at one case of slots_case or ring_case."""
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
        case["row_pos"], case["k"].element_size(), quantized, failures,
        window=case.get("window", 0), ring=case.get("ring", False))


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


# the storage-type sweep: Qwen3-8B's ffn_down and fused ffn_gateup, (name,
# O, K); every plane type at N = 1, 8, 512, the types users download beside
# Q4_K_M timed at N = 1 and 8
SWEEP_SHAPES = (("ffn_down", 4096, 12288), ("ffn_gateup", 24576, 4096))
SWEEP_ROWS = (1, 8, 512)
SWEEP_TIMED = ("Q8_0", "Q5_0", "Q5_1", "Q5_K", "Q4_0", "Q4_1", "IQ4_XS")


def layout_of(w) -> str:
    return (f"{'packed' if w.packed else 'int8'} {'hier' if w.hier else 'flat'} g{w.group}"
            f"{' mins' if w.mins is not None else ''}")


def type_sweep(torch, timer, qmm, weight, types, failures):
    """Each plane type at SWEEP_SHAPES from synthetic bytes through
    load_weight: qmm at SWEEP_ROWS against qmm_plain (NMSE < 5e-3), each
    call's launch read on the counter of its kernel's name (one more); the
    SWEEP_TIMED types then timed at N = 1 and 8 by qmm_phase. Returns
    {type: {"layout", "kernel", shape: {N: numbers}}} of the timed ones."""
    from llama_cpp_tpu_torch.gguf.constants import GGML_BLOCK_LAYOUT

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for t in types:
        for sname, O, K in SWEEP_SHAPES:
            w = weight(t, O, K)
            errs = []
            for n in SWEEP_ROWS:
                x = torch.randn((n, K), generator=gen, device="cuda").to(torch.bfloat16)
                name = qmm.kernel_name(w, n)
                before = qmm.launches[name]
                got = qmm.qmm(x, w)
                torch.cuda.synchronize()
                launched = qmm.launches[name] - before
                err = nmse(got, qmm.qmm_plain(x, w))
                errs.append(err)
                if not err < NMSE_LIMIT or not torch.isfinite(got).all() or launched != 1:
                    failures.append(f"sweep {t.name} {sname} N={n} [{name}]: NMSE {err}, "
                                    f"launches {launched}")
            lay = GGML_BLOCK_LAYOUT[t]
            log(f"  sweep {t.name:8s} {sname:10s} K={K:5d} O={O:5d} {layout_of(w):22s} "
                f"[{qmm.kernel_name(w, 1)}, {qmm.kernel_name(w, 512)}] N={list(SWEEP_ROWS)}: "
                "NMSE " + " ".join(f"{e:.2e}" for e in errs) + f"; bytes a weight: planes "
                f"{plane_bytes(w) / (K * O):.4f}, file {lay.type_size / lay.block_size:.4f}")
            if t.name in SWEEP_TIMED:
                r = qmm_phase(torch, timer, qmm, f"sweep {t.name}", [(sname, w)], (1, 8),
                              failures)
                rows.setdefault(t.name, {"layout": layout_of(w),
                                         "kernel": qmm.kernel_name(w, 1)})[sname] = {
                    n: {k: r[n][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                             "nmse", "max_abs_err")} for n in r}
            del w
        torch.cuda.empty_cache()
    return rows


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
        else:
            failures.append(f"conformance {r.kernel} {r.config}: {r.status}, NMSE {r.nmse} "
                            f"({r.route})")
    counts = {s: sum(r.status == s for r in rows) for s in ("PASS", "FAIL", "raises")}
    worst = max((r for r in rows if r.nmse is not None), key=lambda r: r.nmse)
    mla = [f"{r.config} {r.nmse:.3e} ({r.route})" for r in rows if r.config.startswith("mla-")]
    log(f"  the MLA rows through the MLA instantiation: {mla}")
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
    # the seconds of each section, printed on a line before the last: the
    # build, phase 3, the fixture writes and the loads summed over the run
    # (each outermost call, the card's work in it synchronized), and each
    # path (a path function's outermost calls, under its label)
    sections: dict[str, float] = {}
    active: set[str] = set()

    def timed(fn, cat: str):
        def run(*a, **k):
            if cat in active:  # a call inside another of its category
                return fn(*a, **k)
            active.add(cat)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                active.discard(cat)
                key = cat
                if cat == "path":
                    key = "path " + (a[0] if a and isinstance(a[0], str) else fn.__name__)
                sections[key] = sections.get(key, 0.0) + time.perf_counter() - t0
        return run

    try:
        import llama_cpp_tpu_torch.testing as fixture_mod
        from llama_cpp_tpu_torch.models import loader as loader_mod

        for name in dir(fixture_mod):
            if name.startswith("make_"):
                setattr(fixture_mod, name, timed(getattr(fixture_mod, name), "fixture writes"))
        loader_mod.load_model = timed(loader_mod.load_model, "loads")
        from llama_cpp_tpu_torch.gguf.constants import GGMLType
        from llama_cpp_tpu_torch.models import adapters, mamba
        from llama_cpp_tpu_torch.models.transformer import first_attention_layer
        from llama_cpp_tpu_torch.models.loader import Model, load_model
        from llama_cpp_tpu_torch.ops import qtensor
        from llama_cpp_tpu_torch.ops.kernels import (build, flash_attn, qmm, qmm_bench,
                                                     qmm_expert)
        from llama_cpp_tpu_torch.ops.qtensor import load_weight, pad_out_features
        from llama_cpp_tpu_torch.quant.repack import PLANE_TYPES
        from llama_cpp_tpu_torch.runtime.context import Context
        from llama_cpp_tpu_torch.runtime import state as state_io
        from llama_cpp_tpu_torch.runtime.kv_cache import ISWACache
        from llama_cpp_tpu_torch.runtime.memory import RecurrentState
        from llama_cpp_tpu_torch.runtime.speculative import (DraftModelSpeculator,
                                                             NgramSpeculator,
                                                             speculative_generate)
        from llama_cpp_tpu_torch.sampling.grammar import GBNFParser, GrammarSampler
        from llama_cpp_tpu_torch.sampling.samplers import SamplerChain, SamplingParams
        from llama_cpp_tpu_torch.runtime import diffusion as diffusion_rt
        from llama_cpp_tpu_torch.tools import diffusion_cli
        from llama_cpp_tpu_torch.models.gemma3n import Gemma4AssistantSpeculator
        from llama_cpp_tpu_torch.quant import device_planes
        from llama_cpp_tpu_torch.testing import (MINIMAX_M3_LAYOUT, make_bench_gemma3n_gguf,
                                                 make_bench_gemma4_assistant_gguf,
                                                 make_bench_gemma4_gguf)
        from llama_cpp_tpu_torch.testing import (DIFFUSION_LAYOUTS, LAGUNA_ELEMENT_GATE,
                                                 LAST_TEXT_LAYOUTS, make_bench_diffusion_gguf,
                                                 make_bench_t5_gguf)
        from llama_cpp_tpu_torch.testing import (EMBEDDING_ARCHS, FAMILY_LAYOUTS,
                                                 HYBRID_LAYOUTS, LATE_FAMILY_LAYOUTS,
                                                 MLA_FAMILY_LAYOUTS, RWKV_ARCHS,
                                                 make_bench_rwkv_gguf, make_bench_bge_m3_gguf,
                                                 make_bench_embedding_gguf,
                                                 MOE_FAMILY_LAYOUTS, make_bench_arch_gguf,
                                                 make_bench_command_r_gguf,
                                                 make_bench_gemma3_gguf,
                                                 make_bench_gpt_oss_gguf,
                                                 make_bench_hybrid_gguf,
                                                 make_bench_llama4_gguf,
                                                 make_bench_starcoder2_gguf,
                                                 make_bench_deepseek2_gguf,
                                                 make_bench_deepseek_v3_gguf,
                                                 make_bench_llama_gguf, make_bench_moe_gguf,
                                                 make_bench_nemotron_h_gguf,
                                                 make_bench_qwen3_gguf, make_bench_qwen3moe_gguf,
                                                 make_bench_qwen3next_gguf,
                                                 make_control_vector_gguf, make_lora_gguf,
                                                 RouteHold, synth_quant_bytes)
        from llama_cpp_tpu_torch.tools import bench_qmm as bench_qmm_tool
        from llama_cpp_tpu_torch.tools import bench_tool
        from llama_cpp_tpu_torch.tools import cli as cli_tool
        from llama_cpp_tpu_torch.tools import conformance as conformance_tool
        from llama_cpp_tpu_torch.tools import decode_wall, perplexity, quantize_tool, results
        from llama_cpp_tpu_torch.utils.timing import Timer
    except ImportError as e:
        print(f"chip_smoke: the port package is not next to this script ({e})",
              file=sys.stderr)
        return 2
    import numpy as np

    t_all = time.perf_counter()
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
    sections["build"] = time.perf_counter() - t0
    log(f"build: {sections['build']:.1f} s")
    t_phase3 = time.perf_counter()
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
    res_rows: dict[str, dict] = {}  # rows of the hybrid families' widths, by JSON entry
    log("K3, K4 wgmma GEMM at every main-path shape and ragged ubatch (held, not timed):")
    held = held_phase(torch, qmm, "K3/K4 wgmma", q4 + q6 + tiny, (64, 65, 200, 512, 1023),
                      failures)
    for r in (q4p[512], q6p[512]):
        r["max_abs_err"] = max(r["max_abs_err"], held["max_abs_err"])
        r["nmse"] = max(r["nmse"], held["nmse"])
    log("K1-K4 at the hybrid families' widths (Nemotron-H-8B: ssm_in 4096 -> 18560, 145 "
        "column tiles of 128; ssm_out 8192 -> 4096; ffn_up 4096 -> 21504; ffn_down 21504 -> 4096 "
        "Q6_K. Qwen3-Next-80B-A3B: ssm_in 2048 -> 12288; attn_qk 2048 -> 4608; attn_gate 2048 -> "
        "4096; ssm_out 4096 -> 2048; the shared expert's down 512 -> 2048 Q6_K) and BGE-M3's "
        "(attn_qk 1024 -> 2048, attn_output 1024 -> 1024, ffn_up 1024 -> 4096; attn_v 1024 -> "
        "1024 and ffn_down 4096 -> 1024 Q6_K), each launch held, the layer sums timed at N = 1, "
        "8, 512:")
    hybrid_w = {
        "nemotron-h": ([("ssm_in", weight(GGMLType.Q4_K, 18560, 4096)),
                        ("ssm_out", weight(GGMLType.Q4_K, 4096, 8192)),
                        ("ffn_up", weight(GGMLType.Q4_K, 21504, 4096))],
                       [("ffn_down", weight(GGMLType.Q6_K, 4096, 21504))]),
        "qwen3-next": ([("ssm_in", weight(GGMLType.Q4_K, 12288, 2048)),
                        ("attn_qk", weight(GGMLType.Q4_K, 4608, 2048)),
                        ("attn_gate", weight(GGMLType.Q4_K, 4096, 2048)),
                        ("ssm_out", weight(GGMLType.Q4_K, 2048, 4096))],
                       [("shexp down", weight(GGMLType.Q6_K, 2048, 512))]),
        "bge-m3": ([("attn_qk", weight(GGMLType.Q4_K, 2048, 1024)),
                    ("attn_output", weight(GGMLType.Q4_K, 1024, 1024)),
                    ("ffn_up", weight(GGMLType.Q4_K, 4096, 1024))],
                   [("attn_v", weight(GGMLType.Q6_K, 1024, 1024)),
                    ("ffn_down", weight(GGMLType.Q6_K, 1024, 4096))])}
    for fam, (w4, w6) in hybrid_w.items():
        for keys, ws in (("qmm4_planes", w4), ("qmm_planes", w6)):
            held_phase(torch, qmm, f"{fam} {keys}", ws, DECODE_ROWS + (64, 65, 200, 512, 1023),
                       failures)
            for kind, rows in (("decode", (1, 8)), ("prefill/wgmma", (512,))):
                key = keys + ("/decode" if kind == "decode" else "_prefill/wgmma")
                r = qmm_phase(torch, timer, qmm, f"{fam} {key}", ws, rows, failures)
                for n in rows:
                    res_rows.setdefault(key, {})[f"{fam} layer N={n}"] = {
                        f: r[n][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "nmse")}
                    log(f"  {fam} {key} layer sum N={n} ({card}): {r[n]['ms']:.4f} ms, bound "
                        f"{r[n]['bound_ms']:.4f} ({r[n]['bound_by']}), library "
                        f"{r[n]['library_ms']:.4f}, plain {r[n]['plain_ms']:.4f}")
    del hybrid_w
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
    for key, rows in res_rows.items():
        res[key].setdefault("rows", {}).update(rows)
        res[key]["nmse"] = max(res[key]["nmse"], max(r["nmse"] for r in rows.values()))
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
    log("K5 at Qwen3-Next-80B-A3B's attention (2 KV heads of 256, G = 8, int8 pool):")
    for kind, shape, case in (
            ("decode", "decode B=1 d=2048", dict(B=1, T=1, depth=2048)),
            ("decode", "decode B=8 d=512", dict(B=8, T=1, depth=512)),
            ("prefill", "prefill ubatch 4 of 2048", dict(B=1, T=512, depth=1536))):
        r = attn_phase(torch, timer, flash_attn, f"K5 qwen3-next G=8 D=256 {shape}",
                       attn_case(torch, G=8, Hkv=2, D=256, **case), failures)
        entry = res[f"flash_attention_paged/{kind}"]
        entry.setdefault("rows", {})[f"qwen3-next G=8 D=256 {shape}"] = {
            k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "nmse")}
        entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
        entry["nmse"] = max(entry["nmse"], r["nmse"])
    torch.cuda.empty_cache()
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
    log("K6 in ring mode at a Gemma-3-4B window layer (int8 ring of 1792 slots, 4 KV heads of "
        "256, G=2, window 1024, positions past the wrap):")
    for kind, label, case in (
            ("decode", "K6 ring decode B=8 pos 2304",
             ring_case(torch, B=8, G=2, T=1, n_pos=2304)),
            ("prefill", "K6 ring prefill ubatch 4 of 2048",
             ring_case(torch, B=1, G=2, T=512, n_pos=2048))):
        r = slots_phase(torch, timer, flash_attn, label, case, failures)
        entry = res[f"flash_attention/{kind}"]
        entry.setdefault("rows", {})[f"gemma3 ring {label[len('K6 ring '):]}"] = {
            k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "nmse")}
        entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
        entry["nmse"] = max(entry["nmse"], r["nmse"])
        if kind == "decode":
            ring_decode_ms = r["ms"]
        del case
    # the yardstick of the ring: the same kernel's slot-table decode at the
    # same shape over a live depth of 1024 (a ring visits every tile)
    case = slots_case(torch, B=8, G=2, T=1, depth=1024, S=1792, Hkv=4, D=256)
    r = slots_phase(torch, timer, flash_attn, "K6 slot-table decode B=8 d=1024, Gemma-3-4B shape",
                    case, failures)
    log(f"  ring decode against the slot-table decode at depth 1024 ({card}): "
        f"{ring_decode_ms:.4f} / {r['ms']:.4f} ms = {ring_decode_ms / r['ms']:.3f}x")
    del case
    torch.cuda.empty_cache()
    log("K5/K6 MLA instantiation (csrc/flash_attn_mla.cuh; one KV head of K 640 and V 512, "
        "DeepSeek's absorbed latent; G = 16 query heads: DeepSeek-V2-Lite, G = 128: "
        "DeepSeek-V3; K 576 (no pad) at the conformance rows' width; K 384 and V 256, "
        "MiniCPM3-4B's latent of 256 + 32 rope dims padded, at its G = 40, whose 40 decode rows "
        "fill 40 of a 64-row block); NMSE limit "
        f"{NMSE_LIMIT}; the library call is SDPA on the same bf16 K/V, timed only:")
    mla_rows: dict[str, dict] = {}
    for lay, name, phase, make in (("K5", "flash_attention_paged", attn_phase, attn_case),
                                   ("K6", "flash_attention", slots_phase, slots_case)):
        extra = {} if lay == "K5" else {"S": 4608}
        cases = [(G, fam, dt, dname, B, T, depth, shape, 640, 512)
                 for G, fam in ((16, "v2-lite"), (128, "v3"))
                 for dt, dname in ((None, "int8"), (torch.bfloat16, "bf16"))
                 for B, T, depth, shape in ((1, 1, 2048, "decode B=1 d=2048"),
                                            (8, 1, 2048, "decode B=8 d=2048"),
                                            (1, 512, 1536, "prefill ubatch 4 of 2048"))]
        cases += [(16, "v2-lite", None, "int8", B, T, depth, shape, 576, 512)
                  for B, T, depth, shape in ((1, 1, 2048, "decode B=1 d=2048"),
                                             (1, 512, 1536, "prefill ubatch 4 of 2048"))]
        cases += [(40, "minicpm3", dt, dname, B, T, depth, shape, 384, 256)
                  for dt, dname in ((None, "int8"), (torch.bfloat16, "bf16"))
                  for B, T, depth, shape in ((1, 1, 2048, "decode B=1 d=2048"),
                                             (1, 512, 1536, "prefill ubatch 4 of 2048"))]
        for G, fam, dt, dname, B, T, depth, shape, Dk, Dv in cases:
            row = f"{fam} G={G} Dk={Dk} {dname} {shape}"
            r = phase(torch, timer, flash_attn, f"{lay} mla {row}",
                      make(torch, B=B, G=G, T=T, depth=depth, Hkv=1, D=Dk, Dv=Dv, kv_dtype=dt,
                           **extra), failures)
            mla_rows.setdefault(f"{name}/mla {flash_attn.route(G * T)}", {})[row] = r
            torch.cuda.empty_cache()
    for key, main_row in (("flash_attention_paged/mla decode",
                           "v2-lite G=16 Dk=640 int8 decode B=1 d=2048"),
                          ("flash_attention_paged/mla prefill",
                           "v3 G=128 Dk=640 int8 prefill ubatch 4 of 2048"),
                          ("flash_attention/mla decode",
                           "v2-lite G=16 Dk=640 int8 decode B=1 d=2048"),
                          ("flash_attention/mla prefill",
                           "v3 G=128 Dk=640 int8 prefill ubatch 4 of 2048")):
        rows = mla_rows[key]
        res[key] = {**rows[main_row], "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
                    "nmse": max(r["nmse"] for r in rows.values()),
                    "rows": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "nmse")}
                             for k, r in rows.items()}}
    for src in ("flash_attn_paged.cu", "flash_attn.cu"):
        log(f"MLA instantiations of {src}, ptxas (template <Dk, 16-row groups, bf16, paged>: "
            "registers, spills): " + "; ".join(ptxas_of(build.BUILD_LOGS.get(src, ""), "fa_mla")))
    log("MLA block shared memory (bytes; 64 rows / 16 rows, bf16 / int8): " + "; ".join(
        f"Dk={dk} Dv={dv} {'wide' if w else 'narrow'} {'bf16' if b else 'int8'} "
        f"{flash_attn.mla_smem_bytes(dk, w, b, dv)}" for dk, dv in flash_attn.MLA_DIMS
        for w in (True, False) for b in (True, False)))
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
    log("K7 at DeepSeek-V3's expert stacks (256 experts; gate 7168 -> 2048 Q4_K-like, down "
        "2048 -> 7168 Q6_K-like; R = 8: one token's top 8, R = 64: eight tokens'):")
    for wname, K, O, q4 in (("ffn_gate_exps", 7168, 2048, True),
                            ("ffn_down_exps", 2048, 7168, False)):
        w = expert_stack(torch, qtensor, GGMLType, 256, K, O, q4, seed=11)
        for R in (8, 64):
            r = expert_phase(torch, timer, qmm_expert, f"K7 deepseek-v3 {wname}", w, R, failures)
            qwen["rows"][f"deepseek-v3 {wname} E=256 R={R}"] = {
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "nmse")}
            qwen["max_abs_err"] = max(qwen["max_abs_err"], r["max_abs_err"])
            qwen["nmse"] = max(qwen["nmse"], r["nmse"])
        del w
        torch.cuda.empty_cache()
    log("K7 on Q8_0 expert stacks (load_weight of synthetic Q8_0 bytes: int8, flat f32 scales, "
        "groups of 32, no mins) at Qwen3-30B-A3B's gate and down shapes:")
    for wname, K, O in (("ffn_gate_exps", 2048, 768), ("ffn_down_exps", 768, 2048)):
        raw = np.frombuffer(synth_quant_bytes(rng, 128 * O * K, GGMLType.Q8_0), np.uint8)
        w = load_weight(raw, GGMLType.Q8_0, (128, O, K), transpose=True, device="cuda")
        del raw
        if not (qmm_expert.supported(w) and w.group == 32 and w.mins is None and not w.hier):
            failures.append(f"K7 q8_0 {wname}: the stack's layout is {layout_of(w)}")
        for R in (8, 64):
            r = expert_phase(torch, timer, qmm_expert, f"K7 qwen3-moe q8_0 {wname}", w, R,
                             failures, seed=9)
            qwen["rows"][f"qwen3 {wname} q8_0 R={R}"] = {
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "nmse")}
            qwen["max_abs_err"] = max(qwen["max_abs_err"], r["max_abs_err"])
            qwen["nmse"] = max(qwen["nmse"], r["nmse"])
        del w
    torch.cuda.empty_cache()
    log("K7 at the MoE families' widths: gpt-oss-20B's MXFP4 stacks (32 experts of 2880 x "
        "2880: 45 stages of 64 rows, 22 column tiles of 128 and one of 64; load_weight of "
        "synthetic MXFP4 bytes: int8 flat-g32 planes, no mins) at R = 4 (a decode token's top "
        "4) and 32; Llama-4-Scout's gate (5120 -> 8192, Q4_K-like) and down (8192 -> 5120, "
        "Q6_K-like) stacks of 16 experts at R = 1 (top 1) and 8:")
    for wname in ("ffn_gate_exps", "ffn_down_exps"):
        raw = np.frombuffer(synth_quant_bytes(rng, 32 * 2880 * 2880, GGMLType.MXFP4), np.uint8)
        w = load_weight(raw, GGMLType.MXFP4, (32, 2880, 2880), transpose=True, device="cuda")
        del raw
        if not (qmm_expert.supported(w) and w.group == 32 and w.mins is None and not w.hier):
            failures.append(f"K7 gpt-oss {wname}: the stack's layout is {layout_of(w)}")
        for R in (4, 32):
            r = expert_phase(torch, timer, qmm_expert, f"K7 gpt-oss {wname}", w, R, failures,
                             seed=13)
            qwen["rows"][f"gpt-oss {wname} mxfp4 R={R}"] = {
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "nmse")}
            qwen["max_abs_err"] = max(qwen["max_abs_err"], r["max_abs_err"])
            qwen["nmse"] = max(qwen["nmse"], r["nmse"])
        del w
    torch.cuda.empty_cache()
    for wname, K, O, q4 in (("ffn_gate_exps", 5120, 8192, True),
                            ("ffn_down_exps", 8192, 5120, False)):
        w = expert_stack(torch, qtensor, GGMLType, 16, K, O, q4, seed=17)
        for R in (1, 8):
            r = expert_phase(torch, timer, qmm_expert, f"K7 llama4-scout {wname}", w, R,
                             failures)
            qwen["rows"][f"llama4-scout {wname} R={R}"] = {
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "nmse")}
            qwen["max_abs_err"] = max(qwen["max_abs_err"], r["max_abs_err"])
            qwen["nmse"] = max(qwen["nmse"], r["nmse"])
        del w
        torch.cuda.empty_cache()
    log("K7 at Qwen3-Next-80B-A3B's expert stacks (512 experts of 512: gate 2048 -> 512 "
        "Q4_K-like, down 512 -> 2048 Q6_K-like) at R = 10 (a decode token's top 10) and 80 "
        "(eight tokens'), both on the gather route (pairs below 512):")
    for wname, K, O, q4 in (("ffn_gate_exps", 2048, 512, True),
                            ("ffn_down_exps", 512, 2048, False)):
        w = expert_stack(torch, qtensor, GGMLType, 512, K, O, q4, seed=19)
        for R in (10, 80):
            r = expert_phase(torch, timer, qmm_expert, f"K7 qwen3-next {wname}", w, R, failures)
            qwen["rows"][f"qwen3-next {wname} E=512 R={R}"] = {
                k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "nmse")}
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
    log("storage-type sweep: every plane type at Qwen3-8B's ffn_down (12288 -> 4096) and fused "
        "ffn_gateup (4096 -> 24576), synthetic bytes through load_weight, qmm at N = "
        f"{list(SWEEP_ROWS)} against qmm_plain, each launch read by its kernel's name; "
        f"{', '.join(SWEEP_TIMED)} timed at N = 1, 8:")
    t0 = time.perf_counter()
    sweep = type_sweep(torch, timer, qmm, weight, sorted(PLANE_TYPES, key=int), failures)
    log(f"storage-type sweep: {len(PLANE_TYPES)} types in {time.perf_counter() - t0:.1f} s")
    for tname, r in sweep.items():  # the timed types under their decode kernel's entry
        res[r["kernel"]].setdefault("types", {})[tname] = r
    if failures:
        for f in failures:
            log(f"FAIL {f}")
        return 1

    sections["phase 3"] = time.perf_counter() - t_phase3
    log(f"phase 3 ends at {time.perf_counter() - t_all:.1f} s")

    # -- phase 4: the main paths ---------------------------------------------
    counters = (qmm.launches, flash_attn.launches, flash_attn.ring_launches, qmm_expert.launches,
                qmm_bench.launches)
    # the main paths' qmm kernels: the decode kernel below 64 rows, the
    # wgmma GEMM at the ubatches; a path that launches any other kernel fails
    decode_keys = ("qmm4_planes/decode", "qmm_planes/decode")
    prefill_keys = ("qmm4_planes_prefill/wgmma", "qmm_planes_prefill/wgmma")
    paged_keys = ("flash_attention_paged/prefill", "flash_attention_paged/decode")
    slots_keys = ("flash_attention/prefill", "flash_attention/decode")
    ring_keys = tuple(flash_attn.ring_launches)
    expert_key = "qmm_planes_expert"
    full_keys = decode_keys + prefill_keys + paged_keys
    int8_keys = ("qmm_planes/decode", "qmm_planes_prefill/wgmma") + paged_keys

    def reset_counts():
        for counter in counters:
            for key in counter:
                counter[key] = 0

    def read_counts(path, must_run):
        """The launch counts of the path just driven; every kernel of the
        path must have been launched, and no other kernel."""
        torch.cuda.synchronize()
        counts = {k: v for counter in counters for k, v in counter.items()}
        log(f"{path} launches (at {time.perf_counter() - t_all:.1f} s): {counts}")
        for name in must_run:
            if counts[name] <= 0:
                failures.append(f"{path}: kernel {name} was not launched")
        for name, c in counts.items():
            if c and name not in must_run:
                failures.append(f"{path}: kernel {name} was launched {c} times")
        return counts

    def against_plain(path, model, logits, gen_ids, prompt, decode_logits=0, near_ties=False,
                      ref_model=None, **ctx_kw):
        """The plain path (kernels=False) on the same model, prompt and
        memory, as the reference of the kernel path; with decode_logits = n
        also the logits of n teacher-forced decode steps (the greedy ids fed
        to a kernel context and to the plain one), each within the limit.

        The greedy ids: by default the plain path's own greedy run must equal
        the kernel path's. near_ties=True is for models whose ids vary from
        step to step, where the two runs may part at a near-tie (the kernel
        keeps q exact and scales in f32 up to 8 rows, the plain version
        rounds W to bf16): every id of the kernel path's run is then held
        teacher-forced, both contexts fed the same ids, and must be the plain
        path's argmax at its step, or the parting of a near-tie: the plain
        logit of the kernel's id within that step's largest difference
        between the two paths' logits of the plain argmax. With near_ties on a
        model with experts the plain path's routers are held to the kernel
        path's choice where the two part at a router's near-tie whose input
        agrees within the limit (testing.RouteHold), as the ids are, at the
        prefill (a fresh kernel context's, whose logits are then the ones
        held) and at each step; every step's logits stay within the limit.
        ref_model: the model whose plain path is the reference (default: the
        same model)."""
        ref_ctx = Context(ref_model or model, kernels=False, graphs=False, **ctx_kw)
        steps = len(gen_ids) if near_ties else decode_logits
        held = None
        hold = RouteHold(NMSE_LIMIT) if near_ties and model.cfg.n_expert else None
        if not steps:
            ref_logits = ref_ctx.prefill(prompt, seq=0)
        else:
            kern = Context(model, graphs=False, **ctx_kw)
            with hold.record() if hold else contextlib.nullcontext():
                lk = kern.prefill(prompt, seq=0)
            with hold.hold() if hold else contextlib.nullcontext():
                ref_logits = ref_ctx.prefill(prompt, seq=0)
            if hold:
                own = nmse(torch.from_numpy(lk), torch.from_numpy(logits))
                log(f"{path}: a fresh kernel prefill against the path's own, logits NMSE "
                    f"{own:.3e} (limit {NMSE_LIMIT}); plain routers "
                    f"held to it at the prefill (router call, row, experts, plain gap, largest "
                    f"score difference, input NMSE): "
                    f"{[h[:3] + tuple(round(v, 6) for v in h[3:]) for h in hold.held]}"
                    + (f"; parted {hold.parted[:4]}" if hold.parted else ""))
                # the path's own prefill stays held: the same kernels on the
                # same prompt, through the fresh context, to the plain path
                if not own < NMSE_LIMIT:
                    failures.append(f"{path}: the path's own prefill logits NMSE {own} against "
                                    f"a fresh kernel context's")
                logits = lk  # the kernel prefill whose routes the plain path took
            lr = ref_logits
            errs, ties, wrong, holds, parted = [], [], [], [], []
            for i, t in enumerate(gen_ids[:steps]):
                if near_ties:
                    diff = float(np.abs(lk - lr).max())
                    gap = float(lr.max() - lr[t])
                    if int(np.argmax(lk)) != t or gap > diff:
                        wrong.append((i, t, int(np.argmax(lk)), int(np.argmax(lr)), gap, diff))
                    elif int(np.argmax(lr)) != t:
                        ties.append((i, round(gap, 5), round(diff, 5)))
                with hold.record() if hold else contextlib.nullcontext():
                    lk = kern.decode_one(t, seq=0)
                with hold.hold() if hold else contextlib.nullcontext():
                    lr = ref_ctx.decode_one(t, seq=0)
                errs.append(float(np.mean((lk - lr) ** 2) / (np.mean(lr ** 2) + 1e-30)))
                if hold and hold.held:
                    holds.append((i, [h[:3] + tuple(round(v, 6) for v in h[3:])
                                      for h in hold.held]))
                if not errs[-1] < NMSE_LIMIT:
                    parted.append((i, errs[-1], hold.parted if hold else None))
            del kern
            log(f"{path}: kernel vs plain path: logits of {len(errs)} teacher-forced decode "
                f"steps, NMSE largest {max(errs):.3e} (limit {NMSE_LIMIT})"
                + (f"; plain routers held to the kernel path's choice at near-ties (step, "
                   f"[(router call, row, experts, plain gap, largest score difference, input "
                   f"NMSE)]): {holds}" if hold else ""))
            if parted:
                failures.append(f"{path}: decode logits NMSE past the limit (step, NMSE, routers "
                                f"parted beyond a near-tie): {parted[:4]}; every step: {errs}")
            if near_ties:
                held = len(gen_ids) - len(wrong)
                log(f"{path}: the kernel path's {len(gen_ids)} greedy ids held teacher-forced: "
                    f"{held - len(ties)} the plain path's argmax, {len(ties)} near-ties (step, "
                    f"plain top gap, largest logit difference) {ties}")
                if wrong:
                    failures.append(f"{path}: teacher-forced ids off the plain path's argmax "
                                    f"beyond a near-tie (step, id, kernel argmax, plain argmax, "
                                    f"gap, difference): {wrong[:4]}")
        ref_ids = ref_ctx.generate(prompt, max_new_tokens=len(gen_ids), seq=1)
        err = float(np.mean((logits - ref_logits) ** 2) / (np.mean(ref_logits ** 2) + 1e-30))
        agree = sum(int(a == b) for a, b in zip(gen_ids, ref_ids))
        log(f"{path}: kernel vs plain path: prefill last-token logits NMSE {err:.3e} "
            f"(limit {NMSE_LIMIT}); greedy ids agree {agree}/{len(ref_ids)} "
            f"(argmax {int(np.argmax(logits))} vs {int(np.argmax(ref_logits))})"
            + (", each held teacher-forced" if near_ties else ""))
        if not err < NMSE_LIMIT:
            failures.append(f"{path}: logits NMSE {err}")
        if not near_ties and (agree != len(ref_ids) or len(gen_ids) != len(ref_ids)):
            failures.append(f"{path}: greedy ids agree {agree} of {len(ref_ids)}")
        return ref_logits

    def check_logits(path, logits, vocab):
        if logits.shape != (vocab,) or not np.isfinite(logits).all():
            failures.append(f"{path}: prefill logits shape {logits.shape}, finite "
                            f"{bool(np.isfinite(logits).all())}")

    def hold_ids(path, model, prompt, ids, ref_model=None, **ctx_kw):
        """Greedy ids of a path whose choices may part from Context.generate's
        at a near-tie (speculative verify steps run the kernels at N = 8 or
        16 rows, the prompt cache prefills one row): each id held
        teacher-forced against the plain path (kernels=False, on ref_model
        when given), both fed the same ids: the plain argmax, or the parting
        of a near-tie, the plain logit of the id within that step's largest
        difference between the kernel path's logits (N = 1) and the plain
        path's (against_plain's rule)."""
        kern = Context(model, graphs=False, **ctx_kw)
        plain = Context(ref_model or model, kernels=False, graphs=False, **ctx_kw)
        lk, lp = kern.prefill(prompt), plain.prefill(prompt)
        ties, wrong, n_held = [], [], 0
        hold = RouteHold(NMSE_LIMIT) if model.cfg.n_expert else None
        for i, t in enumerate(ids):
            diff, gap = float(np.abs(lk - lp).max()), float(lp.max() - lp[t])
            if gap > diff:
                wrong.append((i, t, int(np.argmax(lp)), round(gap, 5), round(diff, 5)))
            elif int(np.argmax(lp)) != t:
                ties.append((i, round(gap, 5), round(diff, 5)))
            with hold.record() if hold else contextlib.nullcontext():
                lk = kern.decode_one(t)
            with hold.hold() if hold else contextlib.nullcontext():
                lp = plain.decode_one(t)
            n_held += len(hold.held) if hold else 0
        log(f"{path}: {len(ids)} ids held teacher-forced against the plain path: "
            f"{len(ids) - len(ties) - len(wrong)} its argmax, {len(ties)} near-ties (step, plain "
            f"top gap, largest logit difference) {ties}"
            + (f"; plain routers held at {n_held} near-ties (RouteHold)" if hold else ""))
        if wrong:
            failures.append(f"{path}: ids off the plain path's argmax beyond a near-tie (step, "
                            f"id, plain argmax, gap, difference): {wrong[:4]}")

    def lora_shapes(cfg):
        """(out, in) of attn_q, attn_k, attn_v, ffn_gate and ffn_up."""
        E, H, KV = cfg.n_embd, cfg.n_heads * cfg.head_dim_k, cfg.n_kv_heads * cfg.head_dim_k
        return {"attn_q": (H, E), "attn_k": (KV, E), "attn_v": (KV, E), "ffn_gate": (cfg.n_ff, E),
                "ffn_up": (cfg.n_ff, E)}

    def cli_loop(ctx, logits, n, tok):
        """llama-cli's sampling loop, greedy, from a prefill's logits -> the
        ids it prints (an end-of-generation token ends it unprinted)."""
        out = []
        for _ in range(n):
            t = int(np.argmax(logits))
            if tok.is_eog(t):
                break
            out.append(t)
            if ctx.seq_len[0] >= ctx.n_ctx - 1:
                break
            logits = ctx.decode_one(t)
        return out

    def drive(ctx, prompt, prompts512, vocab, batches, label, n_gen=32):
        """One untimed ubatch (the caching allocator's first allocations and
        first launches belong to start-up), a timed prefill, the B=1 graph
        captured untimed, n_gen greedy tokens at B=1 with their own prefill,
        then decode_steps_greedy over 512-token prefills at each batch
        size."""
        rates = {}
        ctx.prefill(prompt[:512], seq=2)
        ctx.seq_rm(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = ctx.prefill(prompt, seq=0)
        rates[f"prefill_{len(prompt)}_tok_per_s"] = len(prompt) / (time.perf_counter() - t0)
        ctx.decode_loop(1).ready()  # the B=1 graph's capture is start-up, not decode
        n0, t_dec0 = ctx.perf.n_decode, ctx.perf.t_decode_ms
        gen_ids = ctx.generate(prompt, max_new_tokens=n_gen, seq=1)
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

    def server_steps_phase(label, ctxs, batches):
        """The server's one-step calls on the graphed and the eager context:
        decode_step_multi's [B, vocab] logits (NMSE under the plain path's
        limit, equal argmax) and then decode_step_greedy's ids at each B;
        then tools/decode_wall.measure_steps: wall and device ms a call, the
        busy share and the kernel set of a replay, which must be the eager
        call's; the buckets captured and the device memory their graphs
        reserved."""
        for B in batches:
            seqs = np.arange(B)
            toks = np.asarray([7 + 3 * b for b in range(B)], np.int32)
            lg = {g: c.decode_step_multi(toks, seqs) for g, c in ctxs.items()}
            err = nmse(torch.from_numpy(lg[True]), torch.from_numpy(lg[False]))
            same = int((np.argmax(lg[True], -1) == np.argmax(lg[False], -1)).sum())
            nxt = np.argmax(lg[False], -1).astype(np.int32)
            ids = {g: c.decode_step_greedy(nxt, seqs) for g, c in ctxs.items()}
            log(f"{label} graphs: decode_step_multi B={B}: logits {lg[True].shape} "
                f"{lg[True].dtype}, NMSE {err:.3e} against eager (limit {NMSE_LIMIT}), argmax "
                f"{same} of {B} equal; decode_step_greedy: {int((ids[True] == ids[False]).sum())} "
                f"of {B} ids equal")
            if (lg[True].shape != (B, V) or not err < NMSE_LIMIT or same != B
                    or not np.array_equal(ids[True], ids[False])):
                failures.append(f"{label}: graphed one-step calls at B={B}: NMSE {err}, "
                                f"argmax {same} of {B}, greedy ids {ids}")
        rows = {g: decode_wall.measure_steps(torch, c, batches, 16, 2) for g, c in ctxs.items()}
        for g_row, e_row in zip(rows[True], rows[False]):
            call, B = g_row["call"], g_row["B"]
            log(f"{label} {call} B={B} ({card}): graphed wall {min(g_row['wall_ms_per_step']):.3f} "
                f"ms a call, device {g_row['device_ms_per_step']:.3f} ms, busy "
                f"{g_row['busy_share']:.3f}; eager wall {min(e_row['wall_ms_per_step']):.3f} "
                f"ms, device {e_row['device_ms_per_step']:.3f} ms, busy "
                f"{e_row['busy_share']:.3f}; {g_row['launches_per_step']:.0f} launches")
            graph_rows.append({"path": label, "call": call, "B": B, "graphed": {
                k: g_row[k] for k in ("wall_ms_per_step", "device_ms_per_step", "busy_share")},
                "eager": {k: e_row[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                                "busy_share")}})
            if not g_row["kernels"] or g_row["kernels"] != e_row["kernels"]:
                failures.append(f"{label} {call} B={B}: a replay's kernels differ from the eager "
                                "call's")
        log(f"{label} graphs captured (bucket, sampler; MiB reserved): "
            f"{captured(ctxs[True]._loops)}")

    def graph_phase(label, model, ctx_kw, prompt, gen_ids, prompts, batches, must_run,
                    server_steps=()):
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
        if server_steps:
            server_steps_phase(label, ctxs, server_steps)
        # one timed call of 8 steps a batch size, then 8 profiled: the
        # profiles take most of a graph phase
        rows = {g: decode_wall.measure(torch, c, (1, *[b for b in batches if b > 1]), 8, 1)
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
        """The measurement tools on the 1-layer llama file: llama-bench
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

    def http(url, path, body=None, stream=False):
        """One request -> the JSON reply, or for a stream (text, usage, finish
        reason, seconds to the first text, to the end)."""
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(url + path, data=data),
                                    timeout=600) as r:
            if path == "/metrics":
                return r.read().decode()
            if not stream:
                return json.loads(r.read())
            text, first, last = "", None, None
            for line in r:
                if not line.startswith(b"data: ") or line.strip() == b"data: [DONE]":
                    continue
                ev = json.loads(line[6:])
                c = ev["choices"][0]
                piece = c.get("text") if "text" in c else (c.get("delta") or {}).get("content")
                if piece and first is None:
                    first = time.perf_counter() - t0
                text += piece or ""
                last = ev
            return (text, last["usage"], last["choices"][0]["finish_reason"], first,
                    time.perf_counter() - t0)

    def path_f(model):
        """llama-server (server/app.py run_server: the standard library's
        HTTP server over the continuous-batching scheduler) on the pool
        path's model, -np 4 --kv-quant, n_ctx 4096, n_ubatch 512, graphed
        and under Context(graphs=False): four concurrent greedy /completion
        requests of 32 tokens (ignore_eos), three rounds: the first captures,
        the second's ids must equal Context.generate's (32 of 32), the
        third is streamed (time to the first token); every scheduler decode
        step of rounds two and three must be a replay. On the graphed
        server also: a streamed chat equal to the non-streamed one, a
        request at temperature 0.8 and seed 1 twice (equal text), /metrics'
        tokens_predicted_total equal to the replies' tokens. Then the host
        sampler chain's time a token on 128256 logits, and the JSON
        grammar's mask."""
        import gc
        import importlib.util
        import threading

        from llama_cpp_tpu_torch.server.app import run_server
        from llama_cpp_tpu_torch.sampling.json_schema import JSON_GBNF

        tok = model.tokenizer
        log(f"path F: jinja2 importable: {importlib.util.find_spec('jinja2') is not None} "
            "(without it chat templates fall back to the family formatter)")
        ids = [tok.encode(p, add_special=True, parse_special=True) for p in SERVER_PROMPTS]
        ref_ctx = Context(model, n_ctx=4096, n_ubatch=512, quantized_kv=True)
        want = []
        for p in ids:
            want.append(ref_ctx.generate(p, 32))
            ref_ctx.reset()
        log(f"path F: prompts of {[len(p) for p in ids]} tokens")
        served = {}
        for graphs in (True, False):
            label = f"path F ({'graphs' if graphs else 'eager'})"
            gc.collect()
            torch.cuda.synchronize()
            reset_counts()
            box, ready = {}, threading.Event()
            th = threading.Thread(target=run_server, args=(model,), daemon=True, kwargs=dict(
                host="127.0.0.1", port=0, n_seqs=4, n_ctx=4096, n_ubatch=512,
                quantized_kv=True, graphs=graphs,
                ready=lambda srv: (box.setdefault("srv", srv), ready.set())))
            th.start()
            if not ready.wait(300):
                failures.append(f"{label}: the server did not start")
                return
            srv = box["srv"]
            url = f"http://127.0.0.1:{srv.port}"
            ctx = srv.app.ctx
            n_tokens = 0
            steps = [0]

            def counted(fn):
                def step(*a):
                    steps[0] += 1
                    return fn(*a)
                return step

            def round_of_four(stream):
                out = [None] * 4

                def ask(i):
                    out[i] = http(url, "/completion", {
                        "prompt": SERVER_PROMPTS[i], "n_predict": 32, "temperature": 0,
                        "ignore_eos": True, "return_tokens": True, "cache_prompt": False,
                        "stream": stream}, stream=stream)

                threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                return out, time.perf_counter() - t0

            try:
                warm, warm_s = round_of_four(False)
                for name in ("decode_step_greedy", "decode_step_multi"):
                    setattr(ctx, name, counted(getattr(ctx, name)))
                replays0 = sum(loop.replays for loop in ctx._loops.values())
                replies, wall = round_of_four(False)
                streamed, s_wall = round_of_four(True)
                replays = sum(loop.replays for loop in ctx._loops.values()) - replays0
                n_tokens = sum(r["usage"]["completion_tokens"] for r in warm + replies)
                n_tokens += sum(r[1]["completion_tokens"] for r in streamed)
                agree = [sum(int(a == b) for a, b in zip(r["tokens"], w))
                         for r, w in zip(replies, want)]
                same_stream = [r[0] == q["choices"][0]["text"]
                               for r, q in zip(streamed, replies)]
                ttft = [r[3] for r in streamed]
                rate, s_rate = 4 * 32 / wall, 4 * 32 / s_wall
                served[graphs] = (rate, s_rate, ttft)
                log(f"{label} ({card}): ids equal to Context.generate's {agree} of 32 each; "
                    f"streamed text equal {same_stream}; scheduler decode steps {steps[0]}, "
                    f"graph replays {replays}; served {rate:.1f} tok/s (4 x 32 tokens in "
                    f"{wall:.3f} s, first round {warm_s:.3f} s), streamed {s_rate:.1f} tok/s, "
                    f"time to first token {[round(t * 1e3, 1) for t in ttft]} ms")
                if agree != [32] * 4 or not all(len(w) == 32 for w in want):
                    failures.append(f"{label}: ids agree {agree} of 32 with Context.generate")
                if not all(same_stream) or any(t is None for t in ttft):
                    failures.append(f"{label}: streamed replies {[r[0][:40] for r in streamed]}")
                if graphs and (steps[0] == 0 or replays != steps[0]):
                    failures.append(f"{label}: {steps[0]} scheduler decode steps after the "
                                    f"first round, {replays} graph replays")
                if graphs:
                    chat = {"messages": [{"role": "user", "content": CLI_PROMPT}],
                            "max_tokens": 16, "temperature": 0}
                    plain = http(url, "/v1/chat/completions", chat)
                    text, usage, finish, _, _ = http(url, "/v1/chat/completions",
                                                     {**chat, "stream": True}, stream=True)
                    same_chat = (text == plain["choices"][0]["message"]["content"]
                                 and usage == plain["usage"]
                                 and finish == plain["choices"][0]["finish_reason"])
                    hot = {"prompt": CLI_PROMPT, "n_predict": 16, "temperature": 0.8,
                           "seed": 1}
                    hot_replies = [http(url, "/completion", hot) for _ in range(2)]
                    hot_text = [r["choices"][0]["text"] for r in hot_replies]
                    n_tokens += plain["usage"]["completion_tokens"] + usage["completion_tokens"]
                    n_tokens += sum(r["usage"]["completion_tokens"] for r in hot_replies)
                    metrics = http(url, "/metrics")
                    predicted = int(next(ln.split()[1] for ln in metrics.splitlines()
                                         if ln.startswith("llamacpp_tpu_tokens_predicted_total")))
                    log(f"{label}: streamed chat equal to the non-streamed reply: {same_chat} "
                        f"({text[:40]!r}); temperature 0.8, seed 1 twice: equal "
                        f"{hot_text[0] == hot_text[1]} "
                        f"({hot_text[0][:40]!r}); tokens_predicted_total {predicted}, the replies' "
                        f"tokens {n_tokens}")
                    if not same_chat or hot_text[0] != hot_text[1] or predicted != n_tokens:
                        failures.append(f"{label}: stream equal {same_chat}, seeded repeat "
                                        f"{hot_text[0] == hot_text[1]}, metrics {predicted} of "
                                        f"{n_tokens}")
                    log(f"{label}: graphs captured (bucket, sampler; MiB reserved): "
                        f"{captured(ctx._loops)}")
            finally:
                srv.shutdown()
                th.join(timeout=60)
            if th.is_alive():
                failures.append(f"{label}: the server thread did not stop")
            all_counts[label] = read_counts(label, decode_keys + prefill_keys + paged_keys)
            del ctx, srv
        if len(served) == 2:
            log(f"path F at -np 4 ({card}): served tok/s graphed {served[True][0]:.1f} "
                f"(streamed {served[True][1]:.1f}), eager {served[False][0]:.1f} (streamed "
                f"{served[False][1]:.1f}); time to first token ms graphed "
                f"{[round(t * 1e3, 1) for t in served[True][2]]}, eager "
                f"{[round(t * 1e3, 1) for t in served[False][2]]}")
        # the host's cost a token of the temperature request: its sampler
        # chain on the prefill's 128256 logits, and the JSON grammar's mask
        logits = ref_ctx.prefill(ids[0])
        chain = SamplerChain.from_params(SamplingParams(temp=0.8, seed=1), tok.vocab)
        t0 = time.perf_counter()
        for _ in range(32):
            chain.sample(np.array(logits))
        chain_ms = (time.perf_counter() - t0) * 1e3 / 32
        t0 = time.perf_counter()
        GrammarSampler(JSON_GBNF, tok).filter_logits(np.array(logits))
        grammar_ms = (time.perf_counter() - t0) * 1e3
        log(f"path F: host sampler chain (temp 0.8, top_k 40, top_p 0.95, min_p 0.05) "
            f"{chain_ms:.3f} ms a token on {logits.shape[0]} logits; the JSON grammar's mask "
            f"{grammar_ms:.1f} ms for its first token (host Python)")

    def path_d_features(model, cli_ids, ref_gen, run_cli, prompt):
        """llama-cli's features beyond plain decoding on the 1-layer llama
        file, each run with its own load_model, greedy, each printed text
        against the same setup driven in this process: --spec-ngram
        --draft-max 8 against speculative_generate (its ids against
        Context.generate's, held teacher-forced where they part);
        --prompt-cache twice (the second run reuses the prefix; its text
        against the cache file of the first run continued here); -cnv over
        two turns of stdin against the CLI's chat loop; --lora and
        --control-vector on seeded files against Context.generate over the
        adapted model; --no-quant: the file loaded dense, its prefill logits
        against the quantized model's plain path (NMSE 5e-3), 16 greedy ids
        held teacher-forced against it, and the CLI's text against
        Context.generate over the dense model."""
        import shutil

        tok = model.tokenizer
        cli_kw = dict(n_ctx=2048, quantized_kv=True)

        def pieces(ids):
            return "".join(tok.piece(t) for t in ids if not tok.is_eog(t))

        # --spec-ngram: the verify steps at 8 or 16 rows
        reset_counts()
        text, err = run_cli("--temp", "0", "--spec-ngram", "--draft-max", "8")
        all_counts["llama-cli --spec-ngram"] = read_counts("path D --spec-ngram",
                                                           decode_keys + paged_keys)
        sids, stats = speculative_generate(
            Context(model, **cli_kw), NgramSpeculator(), cli_ids, 32, n_draft=8,
            sampler=SamplerChain.from_params(SamplingParams(temp=0.0), tok.vocab))
        want = "".join(tok.piece(t) for t in sids)  # the stream prints every token
        spec_lines = [ln for ln in err.splitlines() if ln.startswith("spec:")]
        same = sum(int(a == b) for a, b in zip(sids, ref_gen))
        log(f"path D: --spec-ngram --draft-max 8: {spec_lines}; text equal to "
            f"speculative_generate's: {text == want}; its ids equal to Context.generate's "
            f"{same} of {len(ref_gen)}")
        if text != want:
            failures.append(f"path D --spec-ngram: printed {text!r}, speculative_generate {want!r}")
        if sids != ref_gen:
            hold_ids("path D --spec-ngram", model, cli_ids, sids, **cli_kw)

        # --prompt-cache, twice: the second run loads the first's file
        cache = os.path.join(smoke_dir, "prompt.cache")
        first, err1 = run_cli("--temp", "0", "--prompt-cache", cache)
        shutil.copy(cache, cache + ".first")
        second, err2 = run_cli("--temp", "0", "--prompt-cache", cache)
        reused = [ln for ln in err2.splitlines() if ln.startswith("prompt cache: reused")]
        ctx = Context(model, **cli_kw)
        state_io.load_state(ctx, cache + ".first")
        ctx.seq_rm(0, p0=len(cli_ids) - 1)
        cont = cli_loop(ctx, ctx.prefill(cli_ids[-1:]), 32, tok)
        del ctx
        log(f"path D: --prompt-cache twice: {reused}, first text equal to Context.generate's "
            f"{first == pieces(ref_gen) + chr(10)}, second equal to the first {second == first}, "
            f"to the cache file continued here {second == pieces(cont) + chr(10)}")
        if (not reused or "reused" in err1 or first != pieces(ref_gen) + "\n"
                or second != pieces(cont) + "\n"):
            failures.append(f"path D --prompt-cache: {reused}, {first!r}, {second!r}")
        if cont != [t for t in ref_gen if not tok.is_eog(t)][: len(cont)]:
            hold_ids("path D --prompt-cache", model, cli_ids, cont, **cli_kw)
        for f in (cache, cache + ".first"):
            os.remove(f)

        # -cnv over two turns of stdin
        turns = ["the cat is on the mat", "and that was the end of it"]
        old_stdin = sys.stdin
        sys.stdin = io.StringIO("\n".join(turns) + "\n\n")
        try:
            chat, _ = run_cli("--temp", "0", "-cnv", "-n", "16")
        finally:
            sys.stdin = old_stdin
        from llama_cpp_tpu_torch.server.chat import apply_chat_template

        ctx, history, want = Context(model, **cli_kw), [], ""
        for user in turns:
            history.append({"role": "user", "content": user})
            ids = tok.encode(apply_chat_template(history, tok.vocab.chat_template, "", "", True),
                             add_special=True, parse_special=True)
            ctx.seq_rm(0)
            reply = cli_loop(ctx, ctx.prefill(ids), 16, tok)
            want += "> " + pieces(reply) + "\n"
            history.append({"role": "assistant", "content": tok.decode(reply)})
        want += "> "
        del ctx
        log(f"path D: -cnv, two turns on stdin: text equal to the chat loop here {chat == want} "
            f"({chat[:60]!r})")
        if chat != want:
            failures.append(f"path D -cnv: printed {chat!r}, the chat loop {want!r}")

        # --lora and --control-vector on seeded files
        cfg = model.cfg
        lora = make_lora_gguf(os.path.join(smoke_dir, "llama-lora.gguf"), cfg.n_layers,
                              lora_shapes(cfg), rank=16, scale=0.02)
        cvec = make_control_vector_gguf(os.path.join(smoke_dir, "llama-cvec.gguf"),
                                        cfg.n_layers, cfg.n_embd, scale=0.1)
        reset_counts()
        steered, _ = run_cli("--temp", "0", "--lora", lora, "--control-vector", cvec)
        all_counts["llama-cli --lora"] = read_counts("path D --lora --control-vector",
                                                     decode_keys + paged_keys)
        adapters.apply_lora(model, adapters.load_lora(lora))
        adapters.apply_control_vector(model, adapters.load_control_vector(cvec, cfg.n_layers,
                                                                          cfg.n_embd))
        a_gen = Context(model, **cli_kw).generate(cli_ids, 32)
        adapters.remove_lora(model)
        adapters.remove_control_vector(model)
        log(f"path D: --lora (rank 16 on attn_q, attn_k, attn_v, ffn_gate, ffn_up) "
            f"--control-vector: text equal to Context.generate over the adapted model "
            f"{steered == pieces(a_gen) + chr(10)}, different from the base text "
            f"{steered != pieces(ref_gen) + chr(10)}")
        if steered != pieces(a_gen) + "\n":
            failures.append(f"path D --lora: printed {steered!r}, generate {pieces(a_gen)!r}")
        for f in (lora, cvec):
            os.remove(f)

        # --no-quant: the file loaded dense
        t0 = time.perf_counter()
        dense = load_model(llama_path, prefer_quant=False)
        torch.cuda.synchronize()
        planes = [w for lw in dense.params["layers"] for w in lw.values()
                  if isinstance(w, qtensor.QuantTensor)]
        log(f"path D: load_model(prefer_quant=False): {time.perf_counter() - t0:.1f} s, every "
            f"matrix bf16: {not planes}")
        kw = dict(n_ctx=4096, n_seqs=2, n_ubatch=512, quantized_kv=True)
        reset_counts()
        d_ctx = Context(dense, **kw)
        d_logits = d_ctx.prefill(prompt)
        d_ids = d_ctx.generate(prompt, 16, seq=1)
        all_counts["llama --no-quant"] = read_counts("path D --no-quant (dense)", paged_keys)
        del d_ctx
        ref = Context(model, kernels=False, graphs=False, **kw).prefill(prompt)
        err = nmse(torch.from_numpy(d_logits), torch.from_numpy(ref))
        log(f"path D: dense weights: prefill logits NMSE {err:.3e} against the quantized "
            f"model's plain path (limit {NMSE_LIMIT})")
        if not err < NMSE_LIMIT:
            failures.append(f"path D --no-quant: logits NMSE {err}")
        hold_ids("path D --no-quant", dense, prompt, d_ids, ref_model=model, **kw)
        reset_counts()
        dtext, _ = run_cli("--temp", "0", "--no-quant")
        read_counts("path D llama-cli --no-quant", paged_keys)
        d_gen = Context(dense, **cli_kw).generate(cli_ids, 32)
        log(f"path D: llama-cli --no-quant: text equal to Context.generate over the dense "
            f"model {dtext == pieces(d_gen) + chr(10)}")
        if dtext != pieces(d_gen) + "\n":
            failures.append(f"path D --no-quant: printed {dtext!r}, generate {pieces(d_gen)!r}")
        del dense
        torch.cuda.empty_cache()

    def start_server(model, **kw):
        """run_server over a loaded model in a thread on a free port ->
        (server, thread), or None when it did not start."""
        import threading

        from llama_cpp_tpu_torch.server.app import run_server

        box, ready = {}, threading.Event()
        th = threading.Thread(target=run_server, args=(model,), daemon=True, kwargs=dict(
            host="127.0.0.1", port=0, ready=lambda srv: (box.setdefault("srv", srv), ready.set()),
            **kw))
        th.start()
        if not ready.wait(300):
            return None
        return box["srv"], th

    def stop_server(label, srv, th):
        srv.shutdown()
        th.join(timeout=60)
        if th.is_alive():
            failures.append(f"{label}: the server thread did not stop")

    MCP_STUB = "\n".join([
        "import json, sys",
        "for line in sys.stdin:",
        "    msg = json.loads(line)",
        "    m, mid = msg.get('method'), msg.get('id')",
        "    if m == 'notifications/initialized':",
        "        continue",
        "    if m == 'initialize':",
        "        res = {'protocolVersion': '2024-11-05', 'capabilities': {'tools': {}},",
        "               'serverInfo': {'name': 'echo-mcp', 'version': '0.1'}}",
        "    elif m == 'tools/list':",
        "        res = {'tools': [{'name': 'echo', 'description': 'echo text back',",
        "                          'inputSchema': {'type': 'object'}}]}",
        "    elif m == 'tools/call':",
        "        res = {'content': [{'type': 'text',",
        "                            'text': 'echo: ' + msg['params']['arguments']['text']}]}",
        "    else:",
        "        out = {'jsonrpc': '2.0', 'id': mid, 'error': {'code': -32601, 'message': m}}",
        "        sys.stdout.write(json.dumps(out) + '\\n'); sys.stdout.flush(); continue",
        "    sys.stdout.write(json.dumps({'jsonrpc': '2.0', 'id': mid, 'result': res}) + '\\n')",
        "    sys.stdout.flush()",
        ""])

    def path_f_features(model):
        """llama-server's features beyond plain decoding on the 1-layer
        llama: with --spec ngram (--draft-max 8, -np 4) one round of four
        concurrent 32-token greedy requests, ids against Context.generate's
        (held teacher-forced where they part); then at -c 512, -np 1, with
        --mcp over a stub MCP server this script writes: POST /slots/0 save,
        erase and restore, after which the repeated request's text equals its
        text before the save; /tools and /tools/call; and a 600-token
        request that finishes with all 600 tokens through context shifts."""
        import threading

        tok = model.tokenizer
        ids = [tok.encode(p, add_special=True, parse_special=True) for p in SERVER_PROMPTS]
        ref_ctx = Context(model, n_ctx=4096, n_ubatch=512, quantized_kv=True)
        want = []
        for p in ids:
            want.append(ref_ctx.generate(p, 32))
            ref_ctx.reset()
        del ref_ctx
        label = "path F --spec ngram"
        reset_counts()
        started = start_server(model, n_seqs=4, n_ctx=4096, n_ubatch=512, quantized_kv=True,
                               spec="ngram", n_draft=8)
        if started is None:
            failures.append(f"{label}: the server did not start")
            return
        srv, th = started
        url = f"http://127.0.0.1:{srv.port}"
        out = [None] * 4

        def ask(i):
            out[i] = http(url, "/completion", {
                "prompt": SERVER_PROMPTS[i], "n_predict": 32, "temperature": 0,
                "ignore_eos": True, "return_tokens": True, "cache_prompt": False})

        try:
            threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            m = dict(srv.app.sched.metrics)
        finally:
            stop_server(label, srv, th)
        all_counts[label] = read_counts(label, decode_keys + prefill_keys + paged_keys)
        agree = [sum(int(a == b) for a, b in zip(r["tokens"], w)) if r else 0
                 for r, w in zip(out, want)]
        log(f"{label} ({card}): four concurrent 32-token requests, ids equal to "
            f"Context.generate's {agree} of 32 each; drafted {m['draft_tokens_total']}, accepted "
            f"{m['draft_tokens_accepted']}; {wall:.3f} s")
        for i, r in enumerate(out):
            if r is None or len(r["tokens"]) != 32:
                failures.append(f"{label}: request {i} answered {r}")
            elif r["tokens"] != want[i]:
                hold_ids(f"{label} request {i}", model, ids[i], r["tokens"], n_ctx=4096,
                         n_ubatch=512, quantized_kv=True)

        label = "path F slots, tools, context shift"
        stub = os.path.join(smoke_dir, "mcp_stub.py")
        with open(stub, "w", encoding="utf-8") as fh:
            fh.write(MCP_STUB)
        reset_counts()
        started = start_server(model, n_seqs=1, n_ctx=512, n_ubatch=512, quantized_kv=True,
                               mcp=[f"{sys.executable} {stub}"], slot_save_dir=smoke_dir)
        if started is None:
            failures.append(f"{label}: the server did not start")
            return
        srv, th = started
        url = f"http://127.0.0.1:{srv.port}"
        req = {"prompt": CLI_PROMPT, "n_predict": 16, "temperature": 0, "return_tokens": True}
        try:
            http(url, "/completion", req)
            before = http(url, "/completion", req)  # reuses all but the prompt's last token
            t0 = time.perf_counter()
            saved = http(url, "/slots/0?action=save", {"filename": "slot0.bin"})
            t1 = time.perf_counter()
            erased = http(url, "/slots/0?action=erase", {})
            emptied = int(srv.app.ctx.seq_len[0])
            t2 = time.perf_counter()
            restored = http(url, "/slots/0?action=restore", {"filename": "slot0.bin"})
            t3 = time.perf_counter()
            after = http(url, "/completion", req)
            tools = http(url, "/tools")
            called = http(url, "/tools/call", {"name": "echo", "arguments": {"text": "hi"}})
            t4 = time.perf_counter()
            long = http(url, "/completion", {"prompt": CLI_PROMPT, "n_predict": 600,
                                             "temperature": 0, "ignore_eos": True,
                                             "return_tokens": True})
            long_s = time.perf_counter() - t4
        finally:
            stop_server(label, srv, th)
        all_counts[label] = read_counts(label, decode_keys + paged_keys)
        log(f"{label} ({card}): slot save {saved} in {(t1 - t0) * 1e3:.1f} ms, erase {erased} "
            f"(seq_len after it {emptied}), restore {restored} in {(t3 - t2) * 1e3:.1f} ms; the "
            f"repeated request's ids after the restore equal those before the save: "
            f"{after['tokens'] == before['tokens']}")
        if (after["tokens"] != before["tokens"] or emptied != 0 or not erased.get("erased")
                or restored.get("n_restored", 0) <= len(tok.encode(CLI_PROMPT))):
            failures.append(f"{label}: slot round trip: before {before['tokens']}, after "
                            f"{after['tokens']}, {saved}, {erased}, {restored}")
        log(f"{label}: /tools {[t['name'] for t in tools['tools']]}, /tools/call {called}")
        if [t["name"] for t in tools["tools"]] != ["echo"] or called != {
                "output": "echo: hi", "is_error": False}:
            failures.append(f"{label}: /tools {tools}, /tools/call {called}")
        n_long = long["usage"]["completion_tokens"]
        log(f"{label}: a 600-token request at -c 512: {n_long} tokens, finish "
            f"{long['choices'][0]['finish_reason']!r}, {len(set(long['tokens']))} distinct ids, "
            f"{long_s:.2f} s ({card})")
        if n_long != 600 or len(long["tokens"]) != 600 or max(long["tokens"]) >= V:
            failures.append(f"{label}: the 600-token request ended after {n_long} tokens")
        for f in (stub, os.path.join(smoke_dir, "slot0.bin")):
            os.remove(f)

    smoke_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(smoke_dir, exist_ok=True)
    # the full-width paths' fixtures, in the order main runs them: (make,
    # n_layers), arch_path's own
    FS = FAMILY_SYNTH_SCALE
    WIDE = {
        "qwen3-8b": (make_bench_qwen3_gguf, QWEN3_LAYERS),
        "qwen3-30b-a3b": (make_bench_qwen3moe_gguf, QWEN3MOE_LAYERS),
        "gemma3-4b": (make_bench_gemma3_gguf, GEMMA3_LAYERS),
        "gemma-3n-e4b": (functools.partial(make_bench_gemma3n_gguf,
                                           shared_kv_layers=GEMMA3N_SHARED, synth_scale=FS),
                         GEMMA3N_LAYERS),
        "starcoder2-7b": (functools.partial(make_bench_starcoder2_gguf, synth_scale=FS),
                          STARCODER2_LAYERS),
        "command-r": (make_bench_command_r_gguf, COMMAND_R_LAYERS),
        "gpt-oss-20b": (functools.partial(make_bench_gpt_oss_gguf, synth_scale=FS),
                        GPT_OSS_LAYERS),
        "llama4-scout": (functools.partial(make_bench_llama4_gguf, synth_scale=FS), SCOUT_LAYERS),
        "qwen3-next-80b-a3b": (functools.partial(make_bench_qwen3next_gguf, synth_scale=FS),
                               QWEN3NEXT_LAYERS),
        "nemotron-h-8b": (functools.partial(make_bench_nemotron_h_gguf, synth_scale=FS),
                          NEMOTRON_H_LAYERS),
        "rwkv7-2.9b": (functools.partial(make_bench_rwkv_gguf, arch="rwkv7", synth_scale=FS),
                       RWKV7_LAYERS),
        "deepseek-v2-lite": (make_bench_deepseek2_gguf, DS_LITE_LAYERS),
        "deepseek-v3": (functools.partial(make_bench_deepseek_v3_gguf, n_dense=0), DS_V3_LAYERS),
        "minicpm3-4b": (functools.partial(
            make_bench_deepseek2_gguf, arch="minicpm3", n_embd=2560, n_heads=40, q_lora_rank=768,
            kv_lora_rank=256, qk_nope=64, qk_rope=32, v_dim=64, n_ff=6400, n_expert=0,
            vocab_size=73448, n_ctx=32768, tie=True, synth_scale=FS), MINICPM3_LAYERS),
        "qwen3-8b-q8_0": (functools.partial(make_bench_qwen3_gguf, ftype="q8_0"), QWEN3_LAYERS),
        "qwen3-8b-q5_k_m": (functools.partial(make_bench_qwen3_gguf, ftype="q5_k_m"),
                            QWEN3_MIX_LAYERS),
        "qwen3-8b-q4_0": (functools.partial(make_bench_qwen3_gguf, ftype="q4_0"),
                          QWEN3_MIX_LAYERS),
    }

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
    log(f"llama paged rates ({SMOKE_LAYERS}-layer smoke run, not a benchmark; "
        f"{card}): " + json.dumps(rates))
    gctx = graph_phase("llama paged", model, paged_kw, prompt, gen_ids, prompts512, (8, 32),
                       decode_keys + prefill_keys + paged_keys, server_steps=(1, 4, 8))
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
    log(f"llama slots rates ({SMOKE_LAYERS}-layer smoke run, not a benchmark; {card}): " + json.dumps(rates))
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
    # a grammar-constrained run: the CLI's text against Context.generate with
    # the same greedy chain behind the same grammar
    t0 = time.perf_counter()
    g_text, _ = run_cli("--temp", "0", "-n", str(GRAMMAR_TOKENS), "--grammar", CLI_GRAMMAR)
    g_s = time.perf_counter() - t0
    constrained = cli_tool.Constrained(SamplerChain.from_params(SamplingParams(temp=0.0),
                                                                tok.vocab),
                                       GrammarSampler(CLI_GRAMMAR, tok))
    g_ref = Context(model, n_ctx=2048, quantized_kv=True).generate(
        cli_ids, GRAMMAR_TOKENS, sampler=constrained)
    g_ref_text = "".join(tok.piece(t) for t in g_ref if not tok.is_eog(t)) + "\n"
    accepted = GBNFParser().parse(CLI_GRAMMAR).would_accept(g_text[:-1])
    log(f"path D: --grammar {CLI_GRAMMAR!r} -n {GRAMMAR_TOKENS} --temp 0: {g_text[:60]!r}, "
        f"equal to Context.generate behind the grammar: {g_text == g_ref_text}, accepted by "
        f"the grammar: {accepted}; {g_s:.1f} s with its own load_model (the mask over "
        f"{V} pieces is host Python, once a token)")
    if g_text != g_ref_text or not accepted or len(g_text) < 2:
        failures.append(f"path D: constrained text {g_text!r}, Context.generate behind the "
                        f"grammar {g_ref_text!r}, accepted {accepted}")
    path_d_features = timed(path_d_features, "path")
    path_e, path_f, path_f_features = (timed(f, "path") for f in (path_e, path_f,
                                                                  path_f_features))
    path_d_features(model, cli_ids, ref_gen, run_cli, prompt)
    path_e(model, llama_path, smoke_dir)
    path_f(model)
    path_f_features(model)
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

    # heads of 64: a TinyLlama-1.1B-shaped model (depth cut 22 -> 1) on both memories
    path = os.path.join(smoke_dir, "tinyllama-q4km-1l.gguf")
    make_bench_llama_gguf(path, n_layers=1, n_embd=2048, n_heads=32, n_kv_heads=4, n_ff=5632,
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

    # the Qwen3 and Gemma-3 families at full width on the shared decoder
    import importlib.util
    log("tokenizer and chat extras on this machine: "
        + ", ".join(f"{m} importable: {importlib.util.find_spec(m) is not None}"
                    for m in ("regex", "jinja2"))
        + " (the Qwen2 pre-tokenizer needs regex; chat templates need jinja2)")

    def server_round(model, label, n_predict=16, must_run=None, near_ties=False):
        """llama-server (run_server, graphed, -np 4 --kv-quant) over the
        loaded model: one round of four concurrent greedy /completion
        requests of n_predict tokens, ids against Context.generate's (with
        near_ties, a request whose ids part from them has each id held
        teacher-forced against the plain path, hold_ids' rule: the batched
        steps run the kernels at other row counts and splits); returns
        Context.generate's ids."""
        import threading

        from llama_cpp_tpu_torch.server.app import run_server

        tok = model.tokenizer
        ids = [tok.encode(p, add_special=True, parse_special=True) for p in SERVER_PROMPTS]
        ref_ctx = Context(model, n_ctx=4096, n_ubatch=512, quantized_kv=True)
        want = []
        for p in ids:
            want.append(ref_ctx.generate(p, n_predict))
            ref_ctx.reset()
        del ref_ctx
        reset_counts()
        box, ready = {}, threading.Event()
        th = threading.Thread(target=run_server, args=(model,), daemon=True, kwargs=dict(
            host="127.0.0.1", port=0, n_seqs=4, n_ctx=4096, n_ubatch=512, quantized_kv=True,
            graphs=True, ready=lambda srv: (box.setdefault("srv", srv), ready.set())))
        th.start()
        if not ready.wait(300):
            failures.append(f"{label}: the server did not start")
            return want
        srv = box["srv"]
        url = f"http://127.0.0.1:{srv.port}"
        out = [None] * 4

        def ask(i):
            out[i] = http(url, "/completion", {
                "prompt": SERVER_PROMPTS[i], "n_predict": n_predict, "temperature": 0,
                "ignore_eos": True, "return_tokens": True, "cache_prompt": False})

        try:
            threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            agree = [sum(int(a == b) for a, b in zip(r["tokens"], w)) if r else 0
                     for r, w in zip(out, want)]
            log(f"{label} ({card}): four concurrent {n_predict}-token requests (prompts of "
                f"{[len(p) for p in ids]} tokens), graphed: ids equal to Context.generate's "
                f"{agree} of {n_predict} each, {wall:.3f} s with the graphs' capture "
                f"({captured(srv.app.ctx._loops)})")
            parted = [i for i, a in enumerate(agree) if a != n_predict]
            if parted and (not near_ties or any(out[i] is None for i in parted)):
                failures.append(f"{label}: served ids agree {agree} of {n_predict}")
        finally:
            srv.shutdown()
            th.join(timeout=60)
        if th.is_alive():
            failures.append(f"{label}: the server thread did not stop")
        all_counts[label] = read_counts(label, must_run or full_keys)
        if near_ties:
            for i in parted:
                hold_ids(f"{label} request {i}", model, ids[i], out[i]["tokens"], n_ctx=4096,
                         n_ubatch=512, quantized_kv=True)
        return want

    def tied_head_phase(model, label):
        """The tied head (the row-major token_embd, which the qmm
        dispatch refuses, as the JAX package's does): its library route,
        dequantize LIBRARY_SLAB rows at a time then torch.mm, timed at the
        decode rows beside its byte bound; no qmm kernel may launch."""
        w = model.params["token_embd"]
        before = {k: v for c in counters for k, v in c.items()}
        for n in (1, 8):
            x = torch.randn((n, w.in_features), device="cuda").to(torch.bfloat16)
            ms = timer(lambda: qtensor.matmul(x, w, dtype=torch.float32), reps=5)
            nbytes = plane_bytes(w) + x.numel() * 2 + n * w.out_features * 4
            log(f"{label} tied head {w.out_features} x {w.in_features} "
                f"({GGMLType(w.ggml_type).name}, row-major), "
                f"library route at N={n} ({card}): {ms:.4f} ms, byte bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        after = {k: v for c in counters for k, v in c.items()}
        if after != before:
            failures.append(f"{label}: the tied head launched a kernel: {before} -> {after}")

    def library_route_phase(model, label):
        """The products that the JAX package leaves to XLA (every matrix its
        dispatch refuses, the head included, and the dense router) on the
        port's library route, each timed at N=1 (a B=1 decode step's rows)
        beside the byte bound of its planes: their sum over the layers is
        what the library route costs a step; no kernel may launch."""
        before = {k: v for c in counters for k, v in c.items()}
        total = bound = 0.0
        parts = []
        mats = [(f"layer {il} {k}", w) for il, lw in enumerate(model.params["layers"])
                for k, w in lw.items()] + [("head", model.params.get("output"))]
        for name, w in mats:
            if isinstance(w, qtensor.QuantTensor):
                if w.q.dim() != 2 or qmm.dispatches(w):
                    continue
                k_in, nbytes = w.in_features, plane_bytes(w)
                what = f"{GGMLType(w.ggml_type).name} {tuple(w.q.shape)}"
            elif isinstance(w, torch.Tensor) and w.dim() == 2 and not name.endswith("_bias"):
                k_in, nbytes = w.shape[1], w.numel() * w.element_size()
                what = f"dense {tuple(w.shape)}"
            else:
                continue
            x = torch.randn((1, k_in), device="cuda").to(torch.bfloat16)
            ms = timer(lambda: qtensor.matmul(x, w, dtype=torch.float32), reps=5)
            total += ms
            bound += nbytes / HBM_BYTES_PER_S * 1e3
            if name.startswith("layer 0 ") or name == "head":
                parts.append(f"{name} {what} {ms:.4f} ms")
        log(f"{label} library route at N=1 ({card}): {total:.4f} ms a step over every layer and "
            f"the head, byte bound {bound:.4f} ms; " + "; ".join(parts))
        after = {k: v for c in counters for k, v in c.items()}
        if after != before:
            failures.append(f"{label}: the library route launched a kernel: {before} -> {after}")
        return total

    def mixer_phase(model, label, il=0, T=512):
        """Layer il's recurrent mixer over one T-token ubatch of one
        sequence from a zero state, outside any counted path: the host ms of
        a synchronised call (the DeltaNet's step loop is T eager steps), the
        best of three after a warm-up, and the device memory the call adds
        at its peak (the Mamba-2 scan's [T, H, P, S] f32 states)."""
        cfg, lw = model.cfg, model.params["layers"][il]
        ex = cfg.extra
        mixer = mamba.mixer_of(cfg, lw)
        rs = RecurrentState.create(cfg.n_layers, 1, ex["ssm_d_conv"], ex["ssm_d_inner"],
                                   ex["ssm_d_state"], conv_channels=ex.get("ssm_conv_dim"),
                                   device="cuda")
        h = torch.randn((1, T, cfg.n_embd), device="cuda").to(torch.bfloat16)
        sidx = torch.zeros(1, dtype=torch.int32, device="cuda")
        mixer(cfg, lw, h, rs, sidx, il)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            mixer(cfg, lw, h, rs, sidx, il)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        log(f"{label} layer {il} {mixer.__name__} over a {T}-token ubatch ({card}): "
            f"{min(ms):.1f} ms (runs {[round(m, 1) for m in ms]}), {peak / 2 ** 30:.2f} GiB of "
            "device memory at its peak beyond the model's")
        del rs, h

    def weight_routes(model, layers) -> str:
        """Each matrix of the given layers (and the head): its storage and
        the route its products take: a qmm kernel (K1/K3 nibble planes, K2/K4
        int8 planes, wherever the JAX package's dispatch sends it), K7 (an
        expert stack the kernel takes), or the library route (dequantize, or
        a dense bf16 weight, then torch's product), where the JAX package
        leaves the product to XLA."""
        out = []
        for name, lw in [(f"layer {il}", model.params["layers"][il]) for il in layers] + [
                ("head", {"output": model.params.get("output")})]:
            for k, w in lw.items():
                if isinstance(w, qtensor.QuantTensor):
                    if w.q.dim() == 3:
                        route = "K7" if qmm_expert.supported(w) else "library"
                    elif qmm.dispatches(w):
                        route = "K1/K3" if w.packed else "K2/K4"
                    else:
                        route = "library"
                    what = f"{GGMLType(w.ggml_type).name} {tuple(w.q.shape)}"
                elif isinstance(w, torch.Tensor) and w.dim() >= 2:
                    route = ("einsum (absorbed MLA)" if k.startswith("mla_") else "library")
                    what = f"dense {str(w.dtype).split('.')[-1]} {tuple(w.shape)}"
                else:
                    continue
                out.append(f"{name} {k} {what} -> {route}")
        return "; ".join(out)

    def arch_path(label, make, n_layers, vocab, must_run, note, profile_qe=None,
                  server=False, n_gen=32, full=True, want_layout=None, near_ties=False,
                  keep=False, routes=False, library=False, batch=8):
        """One family's model at full width, depth cut to n_layers: load,
        drive (prefill 2048, n_gen greedy tokens at B=1, decode_steps_greedy
        at B=batch), its kernel set, the plain path on the prefill logits, 8
        teacher-forced decode steps' logits and the greedy ids; with full
        also the B=1 profile, the graph phase at B=batch and the tied head's
        library route where the model has no output.weight; with server=True
        one served round. want_layout: the layout every quantized matmul
        weight must have; near_ties: against_plain's rule for varied ids;
        keep: return the loaded model for a later path; routes: log every
        matrix's route (weight_routes) of the first and last layers;
        library: time the library route's products (library_route_phase)."""
        path = os.path.join(smoke_dir, f"{label}.gguf")
        t0 = time.perf_counter()
        make(path, n_layers=n_layers, seed=0)
        t1 = time.perf_counter()
        model = load_model(path)
        torch.cuda.synchronize()
        os.remove(path)
        cfg = model.cfg
        log(f"{label}: {note}; random weights (seed 0), depth cut to {n_layers} layers (fixture "
            f"{t1 - t0:.1f} s, load_model {time.perf_counter() - t1:.1f} s, device memory "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB); window layers "
            f"{[i for i in range(cfg.n_layers) if cfg.is_swa_layer(i)]}")
        mats = {**{f"layer 0 {k}": w for k, w in model.params["layers"][0].items()},
                **{k: model.params[k] for k in ("output", "token_embd") if k in model.params}}
        mats = {k: w for k, w in mats.items() if isinstance(w, qtensor.QuantTensor)}
        log(f"{label} weights: " + "; ".join(
            f"{k} {GGMLType(w.ggml_type).name} {layout_of(w)}"
            f"{'' if w.transposed else ' row-major'}" for k, w in mats.items()))
        if routes:
            log(f"{label} weight routes: " + weight_routes(model, sorted({0, n_layers - 1})))
        if want_layout:
            matmuls = [(f"layer {i} {k}", w) for i, lw in enumerate(model.params["layers"])
                       for k, w in lw.items()] + [("output", model.params.get("output"))]
            wrong = [f"{k}: {layout_of(w)}" for k, w in matmuls
                     if isinstance(w, qtensor.QuantTensor) and layout_of(w) != want_layout]
            if wrong:
                failures.append(f"{label}: weights not {want_layout}: {wrong[:4]}")
        kw = dict(n_ctx=4096, n_seqs=8, n_ubatch=512, quantized_kv=True)
        ctx = Context(model, **kw)
        if isinstance(ctx.kv, ISWACache):
            log(f"{label}: memory {type(ctx.kv).__name__}: full layers on the pool "
                f"({ctx.alloc.n_pages} pages of {ctx.page}), window layers on rings of "
                f"{ctx.kv.swa.n_slots} slots")
        prompt = [int(t) for t in prng.integers(3, vocab, 2048)]
        prompts512 = [[int(t) for t in prng.integers(3, vocab, 512)] for _ in range(8)]
        reset_counts()
        logits, gen_ids, rates = drive(ctx, prompt, prompts512, vocab, (batch,), label, n_gen)
        all_counts[label] = read_counts(label, must_run)
        if full:
            profile_decode(torch, qmm, ctx, steps=8, qe=profile_qe)
        del ctx
        against_plain(label, model, logits, gen_ids, prompt, decode_logits=8,
                      near_ties=near_ties, **{**kw, "n_seqs": 2})
        log(f"{label} rates ({n_layers}-layer smoke run, not a benchmark; {card}): "
            + json.dumps(rates) + f"; held against the plain path at "
            f"{time.perf_counter() - t_all:.1f} s")
        if full:
            graph_phase(label, model, kw, prompt, gen_ids, prompts512, (batch,), must_run)
            if "output" not in model.params:
                tied_head_phase(model, label)
        if library:
            library_route_phase(model, label)
        if server:
            server_round(model, f"{label} server", must_run=must_run, near_ties=near_ties)
        if keep:
            return model
        del model
        torch.cuda.empty_cache()

    def family_file(path, arch, layout, synth_scale=FAMILY_SYNTH_SCALE, f32=False):
        """A narrow file of `arch` at FAMILY_SHAPE's widths: a recurrent or
        hybrid family's blocks as testing.HYBRID_LAYOUTS writes them, any
        other family's as testing.FAMILY_LAYOUTS does; the Q4_K_M mix, or
        with f32 every matrix F32 values (their products take the library
        route)."""
        if arch in HYBRID_LAYOUTS:  # the pattern sets the depth
            shape = {k: v for k, v in FAMILY_SHAPE.items() if k != "n_layers"}
            fn, kw = make_bench_hybrid_gguf, dict(arch=arch, **{**shape, **layout}, f32=f32)
        elif arch in RWKV_ARCHS:  # 16 heads of 64; rwkv6qwen2's key/value on 8 of them
            fn, kw = make_bench_rwkv_gguf, dict(arch=arch, **RWKV_SHAPE, **layout, f32=f32)
        elif arch in MLA_FAMILY_LAYOUTS:
            fn, kw = make_bench_deepseek2_gguf, dict(
                arch=arch, n_layers=FAMILY_SHAPE["n_layers"], n_embd=FAMILY_SHAPE["n_embd"],
                n_heads=FAMILY_SHAPE["n_heads"], n_ff=FAMILY_SHAPE["n_ff"],
                vocab_size=FAMILY_SHAPE["vocab_size"], n_ctx=FAMILY_SHAPE["n_ctx"],
                **layout, f32=f32)
        elif arch == "gemma4":  # window heads of 128, full heads of 256
            fn, kw = make_bench_gemma4_gguf, dict(
                n_embd=FAMILY_SHAPE["n_embd"], n_heads=FAMILY_SHAPE["n_heads"],
                n_kv_heads=FAMILY_SHAPE["n_kv_heads"], head_dim=256, head_dim_swa=128,
                n_ff=FAMILY_SHAPE["n_ff"], vocab_size=FAMILY_SHAPE["vocab_size"], **layout,
                f32=f32)
        elif arch in DIFFUSION_LAYOUTS:  # the vocab's last id the mask
            shape = {k: v for k, v in FAMILY_SHAPE.items() if k != "head_dim"}
            fn, kw = make_bench_diffusion_gguf, dict(arch=arch, **shape, mask_token=-1)
        else:
            fn, kw = make_bench_arch_gguf, dict(arch=arch, **{**FAMILY_SHAPE, **layout})
        fn(path, **kw, synth_scale=synth_scale, seed=0)

    def qmm_must(model, ubatch: bool) -> set:
        """The qmm kernels a model's quantized 2-D matrices dispatch to at
        decode, its layers' also at a ubatch where ubatch is set (the head
        and the assistant's projections take one row a step: the decode
        kernel only), and K7 for an expert stack."""
        must = set()
        mats = [(w, ubatch) for lw in model.params["layers"] for w in lw.values()] + [
            (model.params.get(k), False) for k in ("output", "nextn_proj_pre", "nextn_proj_post")]
        for w, rows in mats:
            if not isinstance(w, qtensor.QuantTensor):
                continue
            if w.q.dim() == 3 and qmm_expert.supported(w):
                must.add(expert_key)
            elif w.q.dim() == 2 and qmm.dispatches(w):
                i = 0 if w.packed else 1
                must.update((decode_keys[i],) + ((prefill_keys[i],) if rows else ()))
        return must

    def family_path_file(arch, name=None) -> str:
        return os.path.join(smoke_dir, f"family-{(name or arch).replace(' ', '-')}.gguf")

    def f32_reading(arch, layout):
        """The conditioning of an F32_FAMILIES entry's Q4_K_M file, a reading
        with no limit: the kernel path's and the plain path's logits (the
        same quantized model) each against an f32 path (the same file loaded
        dense in f32, f32 KV) on a FAMILY_PROMPT-token prefill and 8 steps
        teacher-forced with the f32 path's greedy ids. A failure only where
        a path's logits are not finite."""
        label = f"family {arch} Q4_K_M"
        path = os.path.join(smoke_dir, f"family-{arch}-q4.gguf")
        family_file(path, arch, layout)
        models = {"kernel": load_model(path), "f32": load_model(
            path, prefer_quant=False, dense_dtype=torch.float32)}
        os.remove(path)
        models["plain"] = models["kernel"]
        kw = dict(n_ctx=1024, n_seqs=1, n_ubatch=512, graphs=False)
        ctxs = {"kernel": Context(models["kernel"], quantized_kv=True, **kw),
                "plain": Context(models["plain"], quantized_kv=True, kernels=False, **kw),
                "f32": Context(models["f32"], kernels=False, **kw)}
        prompt = [int(t) for t in prng.integers(3, models["f32"].cfg.vocab_size, FAMILY_PROMPT)]
        lg = {k: c.prefill(prompt, seq=0) for k, c in ctxs.items()}
        errs = {k: [nmse(torch.from_numpy(lg[k]), torch.from_numpy(lg["f32"]))]
                for k in ("kernel", "plain")}
        between = [nmse(torch.from_numpy(lg["kernel"]), torch.from_numpy(lg["plain"]))]
        for _ in range(8):
            t = int(np.argmax(lg["f32"]))
            lg = {k: c.decode_one(t, seq=0) for k, c in ctxs.items()}
            for k in errs:
                errs[k].append(nmse(torch.from_numpy(lg[k]), torch.from_numpy(lg["f32"])))
            between.append(nmse(torch.from_numpy(lg["kernel"]), torch.from_numpy(lg["plain"])))
            if not all(np.isfinite(v).all() for v in lg.values()):
                failures.append(f"{label}: logits not finite")
        log(f"{label} ({card}): logits NMSE against the f32 path, prefill then 8 teacher-forced "
            f"steps: kernel path {[f'{e:.3e}' for e in errs['kernel']]}, plain path "
            f"{[f'{e:.3e}' for e in errs['plain']]}; kernel against plain "
            f"{[f'{e:.3e}' for e in between]} (the families' limit {NMSE_LIMIT})")
        del ctxs, models
        torch.cuda.empty_cache()

    def family_path(arch, layout, synth_scale=FAMILY_SYNTH_SCALE, name=None):
        """One family of the registry, narrow (family_file; the Q4_K_M mix,
        F32 values for F32_FAMILIES): a
        FAMILY_PROMPT-token prefill and 16 greedy tokens (Context.generate
        on the B=1 graph) with the counters read: every qmm kernel its
        matrices route to (decode and ubatch), K7 for an expert stack, K5 on
        the pool where its attention layers' heads dispatch to it and, on an
        ISWA memory, K6 in ring mode on the window layers; no other kernel,
        so an ALiBi entry launches no K5/K6, nor a recurrent stack. Then the
        plain path on the prefill logits and each id held teacher-forced
        (near_ties). name: the path's label after "family " (default: arch)."""
        label = f"family {name or arch}"
        path = family_path_file(arch, name)
        family_file(path, arch, layout, synth_scale, f32=arch in F32_FAMILIES)
        model = load_model(path)
        os.remove(path)
        cfg = model.cfg
        must = qmm_must(model, ubatch=True)
        ctx_kw = dict(n_ctx=1024, n_seqs=2, n_ubatch=512, quantized_kv=True)
        ctx = Context(model, **ctx_kw)
        attends = first_attention_layer(cfg, model.params["layers"])
        if cfg.extra.get("mla_absorb"):  # one KV head of the absorbed latent
            must.update(f"flash_attention_paged/mla {flash_attn.route(rows)}"
                        for rows in (FAMILY_PROMPT * cfg.n_heads, cfg.n_heads))
        elif not cfg.alibi_bias and "attn_output" in model.params["layers"][attends]:
            G = cfg.n_heads // cfg.n_kv_heads
            # MSA's DSAMemory is a slot table: its dense-lead layers on K6
            kind = "flash_attention_paged" if ctx.paged else "flash_attention"
            must.update(f"{kind}/{flash_attn.route(rows)}"
                        for rows in (FAMILY_PROMPT * G, G)
                        if flash_attn.dispatches(cfg.head_dim_k, cfg.head_dim_v, ctx.n_slots,
                                                 rows))
            if cfg.sliding_window and cfg.swa_pattern:  # ISWA: the window layers on rings
                must.update(slots_keys + ring_keys)
        vocab = cfg.vocab_size
        prompt = [int(t) for t in prng.integers(3, vocab, FAMILY_PROMPT)]
        reset_counts()
        logits = ctx.prefill(prompt, seq=0)
        gen_ids = ctx.generate(prompt, max_new_tokens=16, seq=1)
        del ctx
        all_counts[label] = read_counts(label, sorted(must))
        check_logits(label, logits, vocab)
        attn = {k: all_counts[label][k] for k in flash_attn.launches.keys() | ring_keys
                if all_counts[label][k]}
        mixers = [getattr(mamba.mixer_of(cfg, lw), "__name__", "-")
                  for lw in model.params["layers"]]
        log(f"{label} ({card}): {cfg.n_layers} layers, n_embd "
            f"{cfg.n_embd}, {cfg.n_heads} heads on {cfg.n_kv_heads} KV heads of "
            f"{cfg.head_dim_k}; LayerNorm {not cfg.use_rms_norm}, glu {cfg.glu}, act "
            f"{cfg.act}, parallel {cfg.parallel_residual}, norm_after {cfg.norm_after}, ALiBi "
            f"{cfg.alibi_bias}, NoPE layers {cfg.extra.get('no_rope_layers', ())}, learned "
            f"positions {'pos_embd' in model.params}; memory "
            f"{cfg.extra.get('memory', 'attn')}, mixers {mixers}; attention launches {attn}")
        against_plain(label, model, logits, gen_ids, prompt, near_ties=True, **ctx_kw)
        del model

    def mla_extras(model, label, must_pool, must_slots):
        """DeepSeek-V2-Lite after its path, Context(n_ctx=4096, n_seqs=8,
        n_ubatch=512, quantized_kv=True): (1) the same model shipped as
        attn_k_b + attn_v_b (current llama.cpp files) against the attn_kv_b
        file: mla_k_b / mla_v_b and the kernel path's prefill logits bit for
        bit; (2) context_shift (n_keep 64) at 2048 tokens on the pool and on
        the slot table (Context(paged=False): every attention through K6's
        MLA instantiation): 8 graphed greedy steps equal to eager, 8
        teacher-forced steps within NMSE 5e-3 of the plain path shifted
        alike; (3) save_seq_state of seq 0 loaded into seq 3: the next step's
        logits bit for bit."""
        kw = dict(n_ctx=4096, n_seqs=8, n_ubatch=512, quantized_kv=True)
        prompt2k = [int(t) for t in prng.integers(3, model.cfg.vocab_size, 2048)]
        path = os.path.join(smoke_dir, f"{label}-split.gguf")
        t0 = time.perf_counter()
        make_bench_deepseek2_gguf(path, n_layers=model.cfg.n_layers, split_kv_b=True, seed=0)
        t1 = time.perf_counter()
        split = load_model(path)
        t2 = time.perf_counter()
        os.remove(path)
        same_w = all(torch.equal(a[k], b[k]) for a, b in zip(model.params["layers"],
                                                             split.params["layers"])
                     for k in ("mla_k_b", "mla_v_b"))
        same_lg = np.array_equal(Context(model, **kw).prefill(prompt2k),
                                 Context(split, **kw).prefill(prompt2k))
        del split
        log(f"{label} attn_k_b/attn_v_b file (fixture {t1 - t0:.1f} s, load_model "
            f"{t2 - t1:.1f} s): mla_k_b/mla_v_b equal {same_w}, prefill logits bit for bit "
            f"{same_lg}")
        if not (same_w and same_lg):
            failures.append(f"{label}: the split file's weights {same_w}, logits {same_lg}")
        for paged in (True, False):
            lab = f"{label} context shift ({'pool' if paged else 'slot table'})"
            reset_counts()
            g = Context(model, paged=paged, **kw)
            e = Context(model, paged=paged, graphs=False, **kw)
            p = Context(model, paged=paged, kernels=False, graphs=False, **{**kw, "n_seqs": 2})
            for c in (g, e, p):
                c.prefill(prompt2k, seq=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_disc = g.context_shift(0, n_keep=64)
            torch.cuda.synchronize()
            shift_ms = (time.perf_counter() - t0) * 1e3
            e.context_shift(0, n_keep=64)
            p.context_shift(0, n_keep=64)
            ids_g = g.decode_steps_greedy(np.asarray([11]), np.asarray([0]), 8)
            ids_e = e.decode_steps_greedy(np.asarray([11]), np.asarray([0]), 8)
            e.seq_rm(0, p0=int(e.seq_len[0]) - 8)
            errs = [nmse(torch.from_numpy(e.decode_one(t)), torch.from_numpy(p.decode_one(t)))
                    for t in [11] + [int(x) for x in ids_e[0][:7]]]
            del g, e, p
            all_counts[lab] = read_counts(lab, must_pool if paged else must_slots)
            log(f"{lab} ({card}): context_shift(n_keep=64) discarded {n_disc} in "
                f"{shift_ms:.2f} ms (K re-roped on its tail 64 dims); 8 graphed greedy steps "
                f"equal to eager {np.array_equal(ids_g, ids_e)}; 8 teacher-forced steps "
                f"against the plain path shifted alike, NMSE largest {max(errs):.3e} (limit "
                f"{NMSE_LIMIT})")
            if not np.array_equal(ids_g, ids_e) or not max(errs) < NMSE_LIMIT:
                failures.append(f"{lab}: graphed {ids_g} eager {ids_e}, NMSE {errs}")
        c = Context(model, **kw)
        c.prefill(prompt2k, seq=0)
        t0 = time.perf_counter()
        blob = state_io.save_seq_state(c, 0)
        save_ms = (time.perf_counter() - t0) * 1e3
        ref = c.decode_one(11, seq=0)
        t0 = time.perf_counter()
        n = state_io.load_seq_state(c, 3, blob)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        same = np.array_equal(c.decode_one(11, seq=3), ref)
        del c
        log(f"{label} save_seq_state ({card}): {len(blob)} bytes in {save_ms:.1f} ms (one KV "
            f"head of 640/512 a layer, int8 with scales), load_seq_state of {n} cells into seq 3 "
            f"{load_ms:.1f} ms; the next step's logits bit for bit {same}")
        if not same or n != len(prompt2k):
            failures.append(f"{label}: seq state round trip {same}, {n} cells")

    def rwkv_state_phase(model, label):
        """An RWKV model's RecurrentState through the state files, Context
        as arch_path's: a 1024-token prefill of seq 0, save_state into a
        fresh context and save_seq_state into seq 1 of a third; the next
        step's logits bit for bit in both."""
        kw = dict(n_ctx=4096, n_seqs=2, n_ubatch=512)
        prompt = [int(t) for t in prng.integers(3, model.cfg.vocab_size, 1024)]
        c = Context(model, **kw)
        c.prefill(prompt, seq=0)
        path = os.path.join(smoke_dir, f"{label}.state")
        t0 = time.perf_counter()
        n_bytes = state_io.save_state(c, path)
        blob = state_io.save_seq_state(c, 0)
        save_ms = (time.perf_counter() - t0) * 1e3
        fresh, other = Context(model, **kw), Context(model, **kw)
        state_io.load_state(fresh, path)
        os.remove(path)
        state_io.load_seq_state(other, 1, blob)
        ref = c.decode_one(11, seq=0)
        same = (np.array_equal(fresh.decode_one(11, seq=0), ref),
                np.array_equal(other.decode_one(11, seq=1), ref))
        del c, fresh, other
        log(f"{label} state files ({card}): whole context {n_bytes} bytes, sequence blob "
            f"{len(blob)} bytes, both written in {save_ms:.1f} ms; the next step's logits bit "
            f"for bit (whole file, sequence blob into seq 1) {same}")
        if not all(same):
            failures.append(f"{label}: state round trip bit for bit {same}")

    def minicpm3_memories(model, label, qmm_keys_):
        """MiniCPM3 on the three other memories (the slot table int8, the
        pool and the slot table bf16): a 1024-token prefill and 16 greedy
        tokens on the B=1 graph, K5's or K6's MLA instantiation at (384,
        256) read from the counters at prefill and decode and no other
        attention kernel, held against the plain path on the same memory
        (8 teacher-forced steps, each id held: near_ties)."""
        cfg = model.cfg
        dims = (cfg.extra["cache_head_dim_k"], cfg.extra["cache_head_dim_v"])
        if dims != (384, 256) or not flash_attn.is_mla(*dims):
            failures.append(f"{label}: absorbed cache dims {dims}, not (384, 256)")
        prompt = [int(t) for t in prng.integers(3, cfg.vocab_size, 1024)]
        for paged, quant in ((False, True), (True, False), (False, False)):
            lab = (f"{label} {'pool' if paged else 'slot table'} "
                   f"{'int8' if quant else 'bf16'}")
            kw = dict(n_ctx=4096, n_seqs=2, n_ubatch=512, quantized_kv=quant, paged=paged)
            must = qmm_keys_ + (mla_paged if paged else mla_slots)
            ctx = Context(model, **kw)
            reset_counts()
            logits = ctx.prefill(prompt, seq=0)
            gen_ids = ctx.generate(prompt, max_new_tokens=16, seq=1)
            del ctx
            all_counts[lab] = read_counts(lab, must)
            check_logits(lab, logits, cfg.vocab_size)
            log(f"{lab}: MLA launches at (Dk, Dv) = {dims}: "
                f"{ {k: all_counts[lab][k] for k in must if 'mla' in k} }")
            against_plain(lab, model, logits, gen_ids, prompt, decode_logits=8,
                          near_ties=True, **kw)

    def path_quantize():
        """llama-quantize on this machine: quantize_tool.main turns an F16
        Qwen3-0.6B-shaped file (seeded values) into q8_0 and q4_0; each
        result is loaded and held against the plain path (prefill logits,
        8 teacher-forced decode steps, 32 greedy ids); on the Q8_0 file the
        32 ids of generate_ondevice and of a served round equal
        Context.generate's, with at least 4 distinct ids among them. Returns
        the paths of the q8_0 and q4_0 files, kept for path S."""
        src = os.path.join(smoke_dir, "qwen3-0.6b-f16.gguf")
        t0 = time.perf_counter()
        make_bench_arch_gguf(src, "qwen3", QUANT_LAYERS, 1024, 16, 8, 128, 3072, 151936,
                             n_ctx=40960, rope_base=1e6, qk_norm=True, tie=True, ftype="f16")
        log(f"path Q: Qwen3-0.6B shape (n_embd 1024, 16/8 heads of 128, n_ff 3072, vocab "
            f"151936, tied head), depth cut 28 -> {QUANT_LAYERS}, F16 matrices of seeded values "
            f"(fixture {time.perf_counter() - t0:.1f} s)")
        kw = dict(n_ctx=4096, n_seqs=4, n_ubatch=512, quantized_kv=True)
        prompt = [int(t) for t in prng.integers(3, 151936, 512)]
        for ftype, want, keys in (
                ("q8_0", GGMLType.Q8_0, int8_keys),
                ("q4_0", GGMLType.Q4_0, ("qmm4_planes/decode", "qmm4_planes_prefill/wgmma")
                 + paged_keys)):
            label = f"path Q {ftype}"
            dst = os.path.join(smoke_dir, f"qwen3-0.6b-{ftype}.gguf")
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = quantize_tool.main([src, dst, ftype])
            t1 = time.perf_counter()
            log(f"{label}: quantize_tool.main exit {rc} in {t1 - t0:.1f} s: "
                f"{out.getvalue().strip().splitlines()[-1]}")
            if rc != 0:
                failures.append(f"{label}: quantize_tool exited with {rc}")
                continue
            model = load_model(dst)
            types = {GGMLType(w.ggml_type).name for lw in model.params["layers"]
                     for w in lw.values() if isinstance(w, qtensor.QuantTensor)}
            log(f"{label}: load_model {time.perf_counter() - t1:.1f} s; layer weights {types}, "
                f"layer 0 ffn_gateup {layout_of(model.params['layers'][0]['ffn_gateup'])}")
            if types != {want.name}:
                failures.append(f"{label}: layer weights {types}, not {want.name}")
            ctx = Context(model, **kw)
            reset_counts()
            logits = ctx.prefill(prompt)
            gen_ids = ctx.generate(prompt, max_new_tokens=32, seq=1)
            check_logits(label, logits, 151936)
            if ftype == "q8_0":
                ctx.reset()
                ids = ctx.generate_ondevice(prompt, max_new_tokens=32, chunk=32)
                distinct = len(set(gen_ids))
                log(f"{label}: 32 greedy ids, {distinct} distinct: {gen_ids}; generate_ondevice "
                    f"equal {sum(int(a == b) for a, b in zip(ids, gen_ids))} of 32")
                if ids != gen_ids or distinct < 4:
                    failures.append(f"{label}: generate_ondevice ids {ids} against "
                                    f"Context.generate's {gen_ids} ({distinct} distinct)")
            all_counts[label] = read_counts(label, keys)
            del ctx
            against_plain(label, model, logits, gen_ids, prompt, decode_logits=8,
                          near_ties=True, **{**kw, "n_seqs": 2})
            if ftype == "q8_0":
                served = server_round(model, f"{label} server", n_predict=32, must_run=int8_keys)
                log(f"{label} server: distinct ids per request "
                    f"{[len(set(w)) for w in served]}")
                if min(len(set(w)) for w in served) < 4:
                    failures.append(f"{label} server: fewer than 4 distinct ids in a request")
            del model
            torch.cuda.empty_cache()
        os.remove(src)
        return [os.path.join(smoke_dir, f"qwen3-0.6b-{f}.gguf") for f in ("q8_0", "q4_0")]

    def traced_decode(ctx, record):
        """Wrap ctx.decode: each call's rows, padded bucket, wall ms and the
        attention kernels it launched go to `record` (the verify steps of
        speculative_generate; the call ends in a copy of the logits to the
        host, so its wall time is the step's)."""
        inner = ctx.decode

        def decode(tokens, *a, **k):
            before = dict(flash_attn.launches)
            t0 = time.perf_counter()
            out = inner(tokens, *a, **k)
            T = np.atleast_2d(tokens).shape[1]
            record.append({"T": T, "ms": (time.perf_counter() - t0) * 1e3, "kernels": {
                key: flash_attn.launches[key] - before[key] for key in paged_keys}})
            return out

        ctx.decode = decode

    def path_s(model, small_q8, small_q4):
        """What llama-cli and llama-server had refused, on Qwen3-8B Q8_0 (the
        1-layer model of the path above) and path Q's Qwen3-0.6B-shaped
        files, Context(n_ctx=4096, n_seqs=8, n_ubatch=512, quantized_kv=True):
        1. speculative_generate with NgramSpeculator over a prompt that
           repeats a 64-token span (the model's own greedy continuation of a
           random prefix, then a random stretch, then the span's first 40
           tokens), 64 new tokens, at n_draft 4 and 8; random weights do not
           copy, so the lookup may find nothing to draft; then the same with
           the model drafting for itself (DraftModelSpeculator over a second
           context of it), whose drafts fill every verify step: at n_draft 4
           the verify rows bucket to 8 (32 rows a KV head: the paged
           attention's decode kernel), at 8 to 16 (64 rows a KV head: its
           prefill kernel), each verify step's kernels read from the launch
           counters; the ids against Context.generate's, held
           teacher-forced where they part; acceptance, tok/s beside plain
           greedy, verify ms;
        2. DraftModelSpeculator: the 0.6B q4_0 file drafting for its q8_0
           (the same F16 values: an acceptance strictly between 0 and 1),
           then the 0.6B q8_0 drafting for Qwen3-8B (unrelated weights:
           constant rollback); ids held as in 1;
        3. state: save_state after a 2048-token prefill, reset, load_state;
           save_seq_state of seq 0 into seq 3: the first step's logits and 16
           graphed greedy ids equal the run without the round trip, bit for
           bit, and an eager context's after the load; on the pool and the
           slot table; bytes and ms;
        4. context shift (n_keep 64) at 2048 tokens on both memories: 8
           graphed steps equal the eager ones, 8 teacher-forced steps within
           NMSE 5e-3 of the plain path shifted alike, and on a 1-layer view of
           the model (where K and V depend on token and position only)
           within NMSE 5e-3 of a fresh context prefilled with the kept
           tokens; ms;
        5. a seeded rank-16 LoRA on attn_q/k/v, ffn_gate/up of every layer
           and a seeded control vector: prefill logits within NMSE 5e-3 of
           the plain path with the same adapters, the base products through
           K2/K4 only, lora_scale 0 and remove_lora bit for bit the base's,
           graphed steps equal to eager after each change; ms a step with and
           without the LoRA."""
        vocab = model.cfg.vocab_size
        kw = dict(n_ctx=4096, n_seqs=8, n_ubatch=512, quantized_kv=True)
        int8_qmm = ("qmm_planes/decode", "qmm_planes_prefill/wgmma")
        srng = np.random.default_rng(17)

        def toks(n):
            return [int(t) for t in srng.integers(3, vocab, n)]

        # the repeated span is the model's own greedy continuation of a
        # random prefix: text the model copies, as prompt lookup expects
        head = toks(256)
        ctx = Context(model, **kw)
        span = ctx.generate(head, 64)
        prompt = head + span + toks(128) + span[:40]
        prompt2k = toks(2048)
        n_pre = -(-len(prompt) // ctx.n_ubatch)  # the prefill's ubatches

        # 1. n-gram speculation, then the verify shapes through a self-draft
        ctx.reset()
        ctx.decode_loop(1).ready()
        n0, t0 = ctx.perf.n_decode, ctx.perf.t_decode_ms
        ref = ctx.generate(prompt, 64)
        plain_tps = (ctx.perf.n_decode - n0) / ((ctx.perf.t_decode_ms - t0) / 1e3)
        for name, make_spec in (("n-gram", NgramSpeculator),
                                ("self-draft", lambda: DraftModelSpeculator(Context(model, **kw)))):
            for n_draft, want_kernel in ((4, "flash_attention_paged/decode"),
                                         (8, "flash_attention_paged/prefill")):
                label = f"path S {name} n_draft {n_draft}"
                ctx.reset()
                record = []
                traced_decode(ctx, record)
                spec = make_spec()
                reset_counts()
                t0 = time.perf_counter()
                ids, st = speculative_generate(ctx, spec, prompt, 64, n_draft=n_draft)
                wall = time.perf_counter() - t0
                del ctx.decode, spec
                all_counts[label] = read_counts(label, int8_keys)
                verify = [r for r in record[n_pre:] if r["T"] > 1]
                big = [r for r in verify if r["T"] > 8]  # buckets of 16 rows
                small = [r for r in verify if r["T"] <= 8]
                spec_tps = (len(ids) - 1) / (wall - sum(r["ms"] for r in record[:n_pre]) / 1e3)
                def rows(rs):  # verify steps: count, median ms, attention kernels launched
                    ms = np.median([r["ms"] for r in rs]) if rs else float("nan")
                    ks = sorted({k for r in rs for k, v in r["kernels"].items() if v})
                    return f"{len(rs)}, median {ms:.3f} ms, kernels {ks}"

                log(f"{label} ({card}): {st}, acceptance "
                    f"{st['n_accept'] / max(st['n_draft'], 1):.3f}; {spec_tps:.1f} tok/s against "
                    f"plain greedy (graphed) {plain_tps:.1f} tok/s; verify steps of 2-8 rows: "
                    f"{rows(small)}; of 9-16 rows: {rows(big)}; ids equal to Context.generate's "
                    f"{sum(int(a == b) for a, b in zip(ids, ref))} of 64")
                want_rows = big if n_draft == 8 else small
                other = ("flash_attention_paged/decode" if n_draft == 8
                         else "flash_attention_paged/prefill")
                if (not all(r["kernels"][want_kernel] > 0 for r in want_rows)
                        or any(r["kernels"][other] for r in want_rows) or len(ids) != 64
                        or (name == "self-draft" and not want_rows)):
                    failures.append(f"{label}: verify steps "
                                    f"{[(r['T'], r['kernels']) for r in verify][:6]}")
                if ids != ref:
                    hold_ids(label, model, prompt, ids, **{**kw, "n_seqs": 2})
        del ctx

        # 2. draft-model speculation
        t06, d06 = load_model(small_q8), load_model(small_q4)
        p06 = toks(512)
        q4_keys = ("qmm4_planes/decode", "qmm4_planes_prefill/wgmma")
        for label, target, draft, n_new, tprompt, between, keys in (
                ("path S draft 0.6B q4_0 -> q8_0", t06, d06, 64, p06, True, int8_keys + q4_keys),
                ("path S draft 0.6B q8_0 -> Qwen3-8B", model, t06, 32, prompt, False, int8_keys)):
            tctx = Context(target, **kw)
            ref = tctx.generate(tprompt, n_new)
            tctx.reset()
            reset_counts()
            t0 = time.perf_counter()
            ids, st = speculative_generate(tctx, DraftModelSpeculator(Context(draft, **kw)),
                                           tprompt, n_new, n_draft=4)
            wall = time.perf_counter() - t0
            all_counts[label] = read_counts(label, keys)
            acc = st["n_accept"] / max(st["n_draft"], 1)
            log(f"{label} ({card}): {st}, acceptance {acc:.3f}; {n_new} tokens in {wall:.2f} s "
                f"({(n_new - 1) / wall:.1f} tok/s with the prefill); ids equal to "
                f"Context.generate's {sum(int(a == b) for a, b in zip(ids, ref))} of {n_new}")
            if len(ids) != n_new or (between and not 0 < acc < 1):
                failures.append(f"{label}: {len(ids)} ids, acceptance {acc}")
            if ids != ref:
                hold_ids(label, target, tprompt, ids, **{**kw, "n_seqs": 2})
            del tctx
        del t06, d06
        torch.cuda.empty_cache()

        # 3. state round trips
        f = os.path.join(smoke_dir, "state.npz")
        for paged in (True, False):
            label = f"path S state ({'pool' if paged else 'slot table'})"
            reset_counts()
            c = Context(model, paged=paged, **kw)
            c.prefill(prompt2k, seq=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nbytes = state_io.save_state(c, f)
            save_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            blob = state_io.save_seq_state(c, 0)
            seq_save_ms = (time.perf_counter() - t0) * 1e3

            def steps(ctx, seq):
                lg = ctx.decode_step_multi(np.asarray([11]), np.asarray([seq]))
                return lg, ctx.decode_steps_greedy(np.asarray([int(np.argmax(lg[0]))]),
                                                   np.asarray([seq]), 16)

            lg_ref, ids_ref = steps(c, 0)
            c.reset()
            t0 = time.perf_counter()
            state_io.load_state(c, f)
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
            lg_w, ids_w = steps(c, 0)
            t0 = time.perf_counter()
            state_io.load_seq_state(c, 3, blob)
            torch.cuda.synchronize()
            seq_load_ms = (time.perf_counter() - t0) * 1e3
            lg_s, ids_s = steps(c, 3)
            e = Context(model, paged=paged, graphs=False, **kw)
            state_io.load_state(e, f)
            lg_e, ids_e = steps(e, 0)
            del c, e
            all_counts[label] = read_counts(label, int8_qmm + (paged_keys if paged else slots_keys))
            same = [np.array_equal(lg_w, lg_ref), np.array_equal(ids_w, ids_ref),
                    np.array_equal(lg_s, lg_ref), np.array_equal(ids_s, ids_ref),
                    np.array_equal(ids_e, ids_ref)]
            err_e = nmse(torch.from_numpy(lg_e), torch.from_numpy(lg_ref))
            log(f"{label} ({card}): save_state {nbytes} bytes in {save_ms:.1f} ms, load_state "
                f"{load_ms:.1f} ms; save_seq_state {len(blob)} bytes in {seq_save_ms:.1f} ms, "
                f"load_seq_state into seq 3 {seq_load_ms:.1f} ms; bit for bit (whole logits, "
                f"whole ids, seq logits, seq ids, eager ids): {same}; eager logits NMSE "
                f"{err_e:.3e}")
            if not all(same) or not err_e < NMSE_LIMIT:
                failures.append(f"{label}: round trips {same}, eager NMSE {err_e}")
        os.remove(f)

        # 4. context shift
        m1 = Model(replace(model.cfg, n_layers=1), {**model.params,
                                                    "layers": model.params["layers"][:1]},
                   model.device, tokenizer=model.tokenizer)
        for paged in (True, False):
            label = f"path S context shift ({'pool' if paged else 'slot table'})"
            reset_counts()
            g = Context(model, paged=paged, **kw)
            e = Context(model, paged=paged, graphs=False, **kw)
            p = Context(model, paged=paged, kernels=False, graphs=False, **{**kw, "n_seqs": 2})
            for c in (g, e, p):
                c.prefill(prompt2k, seq=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_disc = g.context_shift(0, n_keep=64)
            torch.cuda.synchronize()
            shift_ms = (time.perf_counter() - t0) * 1e3
            e.context_shift(0, n_keep=64)
            p.context_shift(0, n_keep=64)
            ids_g = g.decode_steps_greedy(np.asarray([11]), np.asarray([0]), 8)
            ids_e = e.decode_steps_greedy(np.asarray([11]), np.asarray([0]), 8)
            e.seq_rm(0, p0=int(e.seq_len[0]) - 8)
            errs = []
            for t in [11] + [int(x) for x in ids_e[0][:7]]:
                errs.append(nmse(torch.from_numpy(e.decode_one(t)),
                                 torch.from_numpy(p.decode_one(t))))
            del g, e, p
            one = Context(m1, paged=paged, **kw)
            one.prefill(prompt2k, seq=0)
            one.context_shift(0, n_keep=64)
            fresh = Context(m1, paged=paged, **kw)
            fresh.prefill(prompt2k[:64] + prompt2k[64 + n_disc:], seq=0)
            fresh_errs = []
            for t in [11] + [int(x) for x in ids_e[0][:7]]:
                fresh_errs.append(nmse(torch.from_numpy(one.decode_one(t)),
                                       torch.from_numpy(fresh.decode_one(t))))
            del one, fresh
            all_counts[label] = read_counts(label, int8_qmm + (paged_keys if paged else slots_keys))
            log(f"{label} ({card}): context_shift(n_keep=64) discarded {n_disc} in {shift_ms:.2f} "
                f"ms; 8 graphed greedy steps equal to eager {np.array_equal(ids_g, ids_e)}; 8 "
                f"teacher-forced steps against the plain path shifted alike, NMSE largest "
                f"{max(errs):.3e}; 1-layer view against a fresh context of the kept tokens, NMSE "
                f"largest {max(fresh_errs):.3e} (limit {NMSE_LIMIT})")
            if (not np.array_equal(ids_g, ids_e) or not max(errs) < NMSE_LIMIT
                    or not max(fresh_errs) < NMSE_LIMIT):
                failures.append(f"{label}: graphed {ids_g} eager {ids_e}, NMSE {errs}, "
                                f"fresh {fresh_errs}")
        del m1

        # 5. adapters
        label = "path S adapters"
        cfg = model.cfg
        lora = make_lora_gguf(os.path.join(smoke_dir, "qwen-lora.gguf"), cfg.n_layers,
                              lora_shapes(cfg), rank=16, scale=0.02)
        cvec = make_control_vector_gguf(os.path.join(smoke_dir, "qwen-cvec.gguf"), cfg.n_layers,
                                        cfg.n_embd, scale=0.1)
        adapter = adapters.load_lora(lora)
        p512 = prompt2k[:512]
        akw = {**kw, "n_seqs": 2}
        g = Context(model, **akw)
        e = Context(model, graphs=False, **akw)

        def run(ctx):
            ctx.reset()
            lg = ctx.prefill(p512)
            return lg, ctx.decode_steps_greedy(np.asarray([int(np.argmax(lg))]),
                                               np.asarray([0]), 8)

        def step_ms(ctx):
            ctx.reset()
            ctx.prefill(p512)
            ctx.decode_steps_greedy(np.asarray([5]), np.asarray([0]), 4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctx.decode_steps_greedy(np.asarray([5]), np.asarray([0]), 64)
            return (time.perf_counter() - t0) * 1e3 / 64

        base_lg, base_ids = run(g)
        base_ms = step_ms(g)
        adapters.apply_lora(model, adapter, scale=0.0)
        zero_lg, _ = run(g)
        adapters.apply_lora(model, adapter, scale=1.0)
        reset_counts()
        lora_lg, lora_ids = run(g)
        all_counts[label] = read_counts(label, int8_keys)
        lora_ms = step_ms(g)
        _, lora_ids_e = run(e)
        lora_plain = Context(model, kernels=False, graphs=False, **akw).prefill(p512)
        adapters.apply_control_vector(model, adapters.load_control_vector(cvec, cfg.n_layers,
                                                                          cfg.n_embd))
        cv_lg, cv_ids = run(g)
        _, cv_ids_e = run(e)
        cv_plain = Context(model, kernels=False, graphs=False, **akw).prefill(p512)
        adapters.remove_lora(model)
        adapters.remove_control_vector(model)
        back_lg, back_ids = run(g)
        del g, e
        err_l = nmse(torch.from_numpy(lora_lg), torch.from_numpy(lora_plain))
        err_c = nmse(torch.from_numpy(cv_lg), torch.from_numpy(cv_plain))
        moved = nmse(torch.from_numpy(lora_lg), torch.from_numpy(base_lg))
        checks = {"scale 0 == base": np.array_equal(zero_lg, base_lg),
                  "lora graphed == eager": np.array_equal(lora_ids, lora_ids_e),
                  "cvec graphed == eager": np.array_equal(cv_ids, cv_ids_e),
                  "removed == base": np.array_equal(back_lg, base_lg)
                  and np.array_equal(back_ids, base_ids)}
        log(f"{label} ({card}): rank-16 LoRA on 6 weights a layer folded onto attn_qkv and "
            f"ffn_gateup: prefill logits NMSE {err_l:.3e} against the plain path with the "
            f"adapter (it moves them by {moved:.3e}), with the control vector too {err_c:.3e} "
            f"(limit {NMSE_LIMIT}); {checks}; graphed B=1 step {base_ms:.3f} ms, with the LoRA "
            f"{lora_ms:.3f} ms")
        if not all(checks.values()) or not err_l < NMSE_LIMIT or not err_c < NMSE_LIMIT:
            failures.append(f"{label}: {checks}, NMSE {err_l}, {err_c}")
        for f in (lora, cvec):
            os.remove(f)

    def embed_against_plain(label, model, toks, ctx_kw, poolings=EMBED_POOLINGS):
        """Context.embed on the kernel path against Context(kernels=False) on
        the same model and tokens: each pooling (the unpooled rows among
        them) within the limit, finite. -> {pooling: NMSE}."""
        kern, plain = Context(model, **ctx_kw), Context(model, kernels=False, **ctx_kw)
        errs = {}
        for pooling in poolings:
            got, ref = kern.embed(toks, pooling=pooling), plain.embed(toks, pooling=pooling)
            if not np.isfinite(got).all():
                failures.append(f"{label}: embedding ({pooling}) not finite")
            errs[pooling] = nmse(torch.from_numpy(got), torch.from_numpy(ref))
        bad = {k: v for k, v in errs.items() if not v < NMSE_LIMIT}
        if bad:
            failures.append(f"{label}: kernel against plain path, embeddings NMSE past "
                            f"{NMSE_LIMIT}: {bad}")
        return errs

    def embed_keys(layers, rows):
        """The qmm kernels the matrices of `layers` route to at `rows` rows
        (below 64 the decode kernel, 64-1023 the prefill GEMM, from 1024 the
        library route), where the JAX package's dispatch sends them."""
        keys = set()
        for lw in layers:
            for w in lw.values():
                if (isinstance(w, qtensor.QuantTensor) and w.q.dim() == 2
                        and qmm.dispatches(w) and rows < qtensor.XLA_PREFILL_MIN_N):
                    keys.add((decode_keys if rows < 64 else prefill_keys)[0 if w.packed else 1])
        return sorted(keys)

    def timed_embed(ctx, toks, runs=5):
        """Median host ms of Context.embed (it ends in a copy to the host)
        after one warm-up call."""
        ctx.embed(toks)
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            ctx.embed(toks)
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    def profile_call(label, what, fn, wall_ms):
        """One call of fn under torch.profiler: device ms and launches, the
        device's busy share of wall_ms (the call's host clock without the
        profiler), and the six kernels with the most device time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
        if dev_ms <= 0:
            log(f"{label} profile: device time not measured (the profiler saw no kernels)")
            return
        log(f"{label} profile of {what} ({card}): {dev_ms:.3f} ms device over "
            f"{sum(e.count for e in dev)} launches, busy share {dev_ms / wall_ms:.3f} of "
            f"{wall_ms:.3f} ms wall; most device time: " + "; ".join(
                f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:60]}"
                for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]))

    def profile_embed(label, ctx, toks, wall_ms):
        """One Context.embed of toks under torch.profiler (profile_call)."""
        profile_call(label, f"a {len(toks)}-token embed", lambda: ctx.embed(toks), wall_ms)

    def bge_m3_path():
        """BGE-M3 (bert in GGUF) at full width and depth: Context.embed at 7,
        512 and 1000 tokens (buckets of 512, 512 and 1024 rows: K3/K4 at the
        first two, the library route at 1024, launching no kernel), each
        pooling against the plain path, the ms of an embed and a profile of
        the 512-token one, then a served
        round of /v1/embeddings and /v1/rerank against Context.embed
        computed directly."""
        label = "bge-m3"
        t_start = time.perf_counter()
        path = os.path.join(smoke_dir, "bge-m3.gguf")
        make_bench_bge_m3_gguf(path, n_layers=BGE_M3_LAYERS, synth_scale=FAMILY_SYNTH_SCALE,
                               seed=0)
        t1 = time.perf_counter()
        model = load_model(path)
        torch.cuda.synchronize()
        os.remove(path)
        cfg = model.cfg
        log(f"{label}: BAAI/bge-m3 shape (XLM-RoBERTa-large in GGUF as bert: n_embd "
            f"{cfg.n_embd}, {cfg.n_heads} heads of {cfg.head_dim_k}, n_ff {cfg.n_ff}, "
            f"{cfg.n_layers} post-norm LayerNorm layers (eps {cfg.norm_eps}), GELU, biases "
            f"throughout, {model.params['pos_embd'].shape[0]} positions, "
            f"{model.params['token_types'].shape[0]} token type, vocab {cfg.vocab_size}), "
            f"Q4_K_M mix, synthetic block scales / 256, random weights (seed 0), full depth "
            f"(fixture {t1 - t_start:.1f} s, load_model {time.perf_counter() - t1:.1f} s, "
            f"device memory {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB)")
        log(f"{label} weight routes: " + weight_routes(model, [0]))
        ctx_kw = dict(n_ctx=2048, n_seqs=1, n_ubatch=512)
        ctx = Context(model, **ctx_kw)
        toks = {n: [int(t) for t in prng.integers(3, cfg.vocab_size, n)] for n in (7, 512, 1000)}
        must = embed_keys(model.params["layers"], 512)
        reset_counts()
        rows = {n: ctx.embed(toks[n], pooling="none") for n in (7, 512)}
        all_counts[label] = read_counts(label, must)
        reset_counts()
        rows[1000] = ctx.embed(toks[1000], pooling="none")
        all_counts[f"{label} 1024 rows"] = read_counts(f"{label} 1024 rows", ())
        for n, h in rows.items():
            if h.shape != (n, cfg.n_embd) or not np.isfinite(h).all():
                failures.append(f"{label}: {n}-token rows {h.shape}, finite "
                                f"{bool(np.isfinite(h).all())}")
        ms = {n: timed_embed(ctx, toks[n]) for n in (7, 512, 1000)}
        log(f"{label} ({card}): Context.embed ms (median of 5, host clock, one forward of the "
            f"bucket) " + ", ".join(f"{n} tokens {m:.3f} ({n / m * 1e3:,.0f} tok/s)"
                                    for n, m in ms.items()))
        profile_embed(label, ctx, toks[512], ms[512])
        errs = {n: embed_against_plain(f"{label} {n} tokens", model, toks[n], ctx_kw)
                for n in (7, 512, 1000)}
        log(f"{label}: kernel against plain path, NMSE by tokens and pooling (limit "
            f"{NMSE_LIMIT}): " + json.dumps({n: {k: f"{v:.3e}" for k, v in e.items()}
                                             for n, e in errs.items()}))
        # a served round: /v1/embeddings of 4 inputs, /v1/rerank of 8 documents
        started = start_server(model, **ctx_kw)
        if started is None:
            failures.append(f"{label} server: did not start")
            return model
        srv, th = started
        url = f"http://127.0.0.1:{srv.port}"
        inputs = ["the cat is on the mat", "a long story: " + CLI_PROMPT * 3, "of it", "w7"]
        docs = [CLI_PROMPT, "the mat was on the cat", "that was the end", "it is in the house",
                "a dog and a cat", "the end of it", "on and on", "w12 w13 w14"]
        query = "where is the cat"
        reset_counts()
        t0 = time.perf_counter()
        emb = http(url, "/v1/embeddings", {"input": inputs})
        t_emb = time.perf_counter() - t0
        t0 = time.perf_counter()
        rr = http(url, "/v1/rerank", {"query": query, "documents": docs})
        t_rr = time.perf_counter() - t0
        stop_server(f"{label} server", srv, th)
        all_counts[f"{label} server"] = read_counts(f"{label} server", must)

        def unit(text):
            v = ctx.embed(model.tokenizer.encode(text, add_special=True)[: ctx.n_ctx - 1])
            return v / (np.linalg.norm(v) + 1e-12)

        direct = [unit(t) for t in inputs]
        d_emb = max(float(np.abs(np.asarray(d["embedding"]) - v).max())
                    for d, v in zip(emb["data"], direct))
        qv = unit(query)
        scores = [float(qv @ unit(d)) for d in docs]
        order = sorted(range(len(docs)), key=lambda i: -scores[i])
        got_order = [r["index"] for r in rr["results"]]
        d_rr = max(abs(r["relevance_score"] - scores[r["index"]]) for r in rr["results"])
        log(f"{label} server ({card}): /v1/embeddings of {len(inputs)} inputs {t_emb:.3f} s, "
            f"largest difference to Context.embed {d_emb:.3e}; /v1/rerank of {len(docs)} "
            f"documents {t_rr:.3f} s, order {got_order} (direct {order}), largest score "
            f"difference {d_rr:.3e}")
        if [d["index"] for d in emb["data"]] != list(range(len(inputs))) or not d_emb < 1e-6:
            failures.append(f"{label} server: embeddings differ from Context.embed by {d_emb}")
        if got_order != order or not d_rr < 1e-6:
            failures.append(f"{label} server: rerank {got_order} against {order}, scores "
                            f"{d_rr}")
        log(f"{label}: {time.perf_counter() - t_start:.1f} s")
        return model

    def embedding_decoder_path(model, label, note):
        """An embedding model on the shared decoder at the loaded model's
        widths: Context.embed(pooling="last") of 512 tokens, one 512-row
        forward over a throwaway slot table of 520 slots, with its kernels
        read and held against the plain path. 520 is no multiple of 128, so
        the JAX package's flash_supported keeps that attention from its
        kernel, and the port's _attend takes the einsum path too."""
        t_start = time.perf_counter()
        cfg = model.cfg
        ctx_kw = dict(n_ctx=4096, n_seqs=1, n_ubatch=512)
        ctx = Context(model, **ctx_kw)
        toks = [int(t) for t in prng.integers(3, cfg.vocab_size, 512)]
        G = cfg.n_heads // cfg.n_kv_heads
        flash = flash_attn.dispatches(cfg.head_dim_k, cfg.head_dim_v, 520, 512 * G)
        must = embed_keys(model.params["layers"], 512) + (
            ["flash_attention/prefill"] if flash else [])
        reset_counts()
        vec = ctx.embed(toks, pooling="last")
        all_counts[label] = read_counts(label, must)
        if vec.shape != (cfg.n_embd,) or not np.isfinite(vec).all():
            failures.append(f"{label}: last-token vector {vec.shape}")
        ms = timed_embed(ctx, toks, runs=3)
        errs = embed_against_plain(label, model, toks, ctx_kw, ("last", "none"))
        log(f"{label} ({card}): {note}; Context.embed(pooling='last') of 512 tokens {ms:.3f} ms "
            f"({512 / ms * 1e3:,.0f} tok/s); slot table 520 slots: attention kernel dispatch "
            f"{flash}; kernel against plain path NMSE "
            f"{ {k: f'{v:.3e}' for k, v in errs.items()} }; {time.perf_counter() - t_start:.1f} s")

    def embedding_family_path(arch):
        """One embedding entry at EMBED_SHAPE's widths (2 layers of n_embd
        1024) on the Q4_K_M mix: embed of FAMILY_PROMPT tokens (a 512-row
        bucket: the prefill GEMM) with its kernels read, no attention kernel
        (the encoders' attention is plain; gemma-embedding is non-causal;
        the slot table of 520 slots takes none), held against the plain
        path; t5encoder through Context.encode at 7 tokens (an 8-row bucket:
        the decode kernel) and 200 (256 rows: the prefill GEMM)."""
        label = f"embedding {arch}"
        path = os.path.join(smoke_dir, f"embedding-{arch}.gguf")
        make_bench_embedding_gguf(path, arch, **EMBED_SHAPE, synth_scale=FAMILY_SYNTH_SCALE,
                                  seed=0)
        model = load_model(path)
        os.remove(path)
        cfg = model.cfg
        ctx_kw = dict(n_ctx=1024, n_seqs=1, n_ubatch=512)
        ctx = Context(model, **ctx_kw)
        vocab = cfg.vocab_size
        if cfg.extra.get("t5_encoder_only"):
            errs = {}
            for n in (7, 200):
                toks = [int(t) for t in prng.integers(3, vocab, n)]
                reset_counts()
                got = ctx.encode(toks)
                key = f"{label} {n} tokens"
                all_counts[key] = read_counts(key, embed_keys(model.params["enc_layers"],
                                                              8 if n == 7 else 256))
                ref = Context(model, kernels=False, **ctx_kw).encode(toks)
                errs[n] = nmse(torch.from_numpy(got), torch.from_numpy(ref))
                if not errs[n] < NMSE_LIMIT or not np.isfinite(got).all():
                    failures.append(f"{label}: encode of {n} tokens NMSE {errs[n]}")
        else:
            toks = [int(t) for t in prng.integers(3, vocab, FAMILY_PROMPT)]
            reset_counts()
            rows = ctx.embed(toks, pooling="none")
            all_counts[label] = read_counts(label, embed_keys(model.params["layers"], 512))
            if rows.shape != (FAMILY_PROMPT, cfg.n_embd):
                failures.append(f"{label}: rows {rows.shape}")
            errs = embed_against_plain(label, model, toks, ctx_kw, ("mean", "none"))
        launched = {k: v for k, v in all_counts.get(label, all_counts.get(
            f"{label} 200 tokens", {})).items() if v}
        log(f"{label} ({card}): {cfg.n_layers} layers, n_embd {cfg.n_embd}, {cfg.n_heads} "
            f"heads on {cfg.n_kv_heads}, encoder {bool(cfg.extra.get('encoder'))}, pre-norm "
            f"{bool(cfg.extra.get('pre_norm_encoder'))}, non-causal "
            f"{bool(cfg.extra.get('non_causal'))}, ALiBi {cfg.alibi_bias}, window "
            f"{cfg.sliding_window}, experts {cfg.n_expert}; launches {launched}; kernel "
            f"against plain path NMSE {({k: f'{v:.3e}' for k, v in errs.items()})}")
        del ctx, model
        torch.cuda.empty_cache()

    (arch_path, family_path, path_quantize, path_s, bge_m3_path, embedding_decoder_path,
     embedding_family_path) = (
        timed(f, "path") for f in (arch_path, family_path, path_quantize, path_s, bge_m3_path,
                                   embedding_decoder_path, embedding_family_path))
    qwen3_model = arch_path(
        "qwen3-8b", *WIDE["qwen3-8b"], 151936, full_keys,
        "Qwen3-8B shape (n_embd 4096, 32/8 heads of 128, n_ff 12288, vocab 151936, "
        "q/k norms, NEOX rope 1e6), Q4_K/Q6_K mix", server=True, keep=True)
    # the embedding path: Qwen3-Embedding-8B is Qwen3-8B's stack (the loaded
    # 1-layer model; its head is never read), then BGE-M3 at full depth and
    # the other embedding entries narrow
    t0 = time.perf_counter()
    embedding_decoder_path(
        qwen3_model, "qwen3-embedding-8b",
        "Qwen/Qwen3-Embedding-8B: Qwen3-8B's stack (the qwen3-8b path's 1-layer model) with "
        "last-token pooling")
    del qwen3_model
    torch.cuda.empty_cache()
    bge_model = bge_m3_path()
    del bge_model
    torch.cuda.empty_cache()
    for arch in EMBEDDING_ARCHS:
        if arch != "bert":
            embedding_family_path(arch)
    log(f"the embedding paths (Qwen3-Embedding, BGE-M3, {len(EMBEDDING_ARCHS) - 1} narrow "
        f"entries): {time.perf_counter() - t0:.1f} s")
    arch_path("qwen3-30b-a3b", *WIDE["qwen3-30b-a3b"], 151936,
              full_keys + (expert_key,),
              "Qwen3-30B-A3B shape (n_embd 2048, 32/4 heads of 128, 128 experts of 768, top 8, "
              "vocab 151936), Q4_K experts gate/up, Q6_K down", profile_qe=qmm_expert)
    arch_path("gemma3-4b", *WIDE["gemma3-4b"], 262208,
              full_keys + slots_keys + ring_keys,
              "Gemma-3-4B shape (n_embd 2560, 8/4 heads of 256, n_ff 10240, vocab 262208, "
              "window 1024 on five layers of six, GeGLU, post-norms, tied Q6_K head)")

    def planes_phase():
        """The 2-D matrices cut into planes on the card (quant/device_planes.py)
        against the host's extraction (quant/repack.py), bit for bit: every
        quantized 2-D tensor of a Gemma-3n-E4B file of 2 layers (vocab cut to
        4096: Q4_K and Q6_K hierarchical, Q4_K flat at 256 columns, the
        4-row AltUp router) and synthetic 4096 x 4096 matrices of the other
        flat types (Q8_0, Q4_0, Q5_0, MXFP4), each as a matmul weight and as a
        row-major table; then each route's load seconds, and load_model of
        the file both ways."""
        label = "2-D planes cut on the card"
        path = os.path.join(smoke_dir, "planes.gguf")
        make_bench_gemma3n_gguf(path, n_layers=2, shared_kv_layers=0, vocab_size=4096, seed=0)
        from llama_cpp_tpu_torch.gguf.reader import read_gguf

        cases = [(name, np.asarray(info.data), info.dtype, tuple(info.shape))
                 for name, info in read_gguf(path).tensors.items()
                 if len(info.shape) == 2 and info.dtype in device_planes.MATRIX_PLANE_TYPES]
        for t in (GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q5_0, GGMLType.MXFP4):
            raw = np.frombuffer(synth_quant_bytes(rng, 4096 * 4096, t), np.uint8)
            cases.append((f"synthetic {t.name}", raw, t, (4096, 4096)))
        routes = {"host": lambda device: False, "card": device_planes.cuts_on}
        cut_on = device_planes.cuts_on
        secs = {k: 0.0 for k in routes}
        n_bytes, wrong = 0, []
        try:
            for name, raw, t, shape in cases:
                n_bytes += raw.nbytes
                for transpose in (True, False):
                    got = {}
                    for k, rule in routes.items():
                        device_planes.cuts_on = rule
                        t0 = time.perf_counter()
                        got[k] = load_weight(raw, t, shape, transpose=transpose, device="cuda")
                        torch.cuda.synchronize()
                        secs[k] += time.perf_counter() - t0
                    for f in ("q", "scales", "mins", "d", "dmin"):
                        a, b = getattr(got["card"], f), getattr(got["host"], f)
                        if (a is None) != (b is None) or (a is not None and not (
                                a.dtype == b.dtype and a.shape == b.shape
                                and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))):
                            wrong.append((name, GGMLType(t).name, transpose, f))
                    if got["card"].packed != got["host"].packed:
                        wrong.append((name, GGMLType(t).name, transpose, "packed"))
            loads = {}
            for k, rule in routes.items():
                device_planes.cuts_on = rule
                t0 = time.perf_counter()
                m = load_model(path)
                torch.cuda.synchronize()
                loads[k] = time.perf_counter() - t0
                del m
        finally:
            device_planes.cuts_on = cut_on
        os.remove(path)
        log(f"{label} ({card}): {len(cases)} matrices ({n_bytes / 2 ** 20:.1f} MiB of blocks), "
            f"each as a matmul weight and a table: card planes equal to the host's bit for bit "
            f"{not wrong}; load_weight seconds summed: host extraction "
            f"{secs['host']:.3f}, cut on the card {secs['card']:.3f}; load_model of the "
            f"2-layer Gemma-3n-E4B file: host {loads['host']:.3f} s, card {loads['card']:.3f} s")
        if wrong:
            failures.append(f"{label}: planes differ from the host's: {wrong[:6]}")

    def gemma3n_lines(model, label):
        """The shared-KV layers of a Gemma 3n model own no line and write
        none: the ISWA memory's pool and rings hold the owned layers of each
        class, each shared layer's indices alias its source's, and a prefill
        and a decode step write the owned layers alone (each write_layer
        call's layer recorded)."""
        cfg = model.cfg
        reuse = cfg.extra["kv_reuse"]
        ctx = Context(model, n_ctx=1024, n_seqs=1, n_ubatch=512, quantized_kv=True)
        kv = ctx.kv
        owned = [il for il in range(cfg.n_layers) if reuse[il] < 0]
        n_full = sum(not cfg.is_swa_layer(il) for il in owned)
        seen = set()
        write = kv.write_layer

        def spy(il, *a, **k):
            seen.add(il)
            return write(il, *a, **k)

        kv.write_layer = spy
        prompt = [int(t) for t in prng.integers(3, cfg.vocab_size, 600)]
        first = int(np.argmax(ctx.prefill(prompt)))
        ctx.decode_one(first)
        aliased = all((kv.full_idx[il], kv.swa_idx[il]) == (kv.full_idx[reuse[il]],
                                                             kv.swa_idx[reuse[il]])
                      for il in range(cfg.n_layers) if reuse[il] >= 0)
        lines = (len(kv.full.k), len(kv.swa.k))
        log(f"{label}: kv_reuse {reuse}; pool layers and rings {lines} for the owned full and "
            f"window layers {(n_full, len(owned) - n_full)}; shared layers alias their "
            f"source's lines {aliased}; layers written by a 600-token prefill and a step "
            f"{sorted(seen)} (owned {owned})")
        if sorted(seen) != owned or lines != (n_full, len(owned) - n_full) or not aliased:
            failures.append(f"{label}: a shared layer owns or writes a line: written "
                            f"{sorted(seen)}, owned {owned}, lines {lines}, aliased {aliased}")
        del ctx

    def gemma4_assistant_round():
        """A Gemma 4 target (FAMILY_SHAPE's widths, window heads of 128 and
        full heads of 256, layers window, window, window, full; an untied
        head, each block adding 0.15 of the embedded row's RMS) and its MTP
        assistant mirrored on it (a window and a full q-only layer over the
        target's live KV; testing.make_bench_gemma4_assistant_gguf's
        mirror_of: it predicts the target's next token but where the
        target's blocks or a near-tie part them), so the target accepts
        some drafts and rejects others: Context.generate's 16 greedy ids,
        then speculative_generate with the assistant (p_min 0, 4 drafts a
        step) on a fresh context. It fails where no draft is accepted; its
        ids equal the greedy ids (or each is held teacher-forced against
        the plain path, hold_ids, where a verify step's 8 rows part from a
        one-row step at a near-tie); the counters read over the speculative
        round (the prefill and verify steps on the target's kernels, the
        drafts' q-only attention on K5 and the ring's K6)."""
        label = "gemma4-assistant"
        shape = dict(n_embd=FAMILY_SHAPE["n_embd"], n_heads=FAMILY_SHAPE["n_heads"],
                     n_kv_heads=FAMILY_SHAPE["n_kv_heads"], head_dim=256, head_dim_swa=128,
                     n_ff=FAMILY_SHAPE["n_ff"], vocab_size=FAMILY_SHAPE["vocab_size"],
                     sliding_window=512, synth_scale=FAMILY_SYNTH_SCALE)
        tpath = os.path.join(smoke_dir, "gemma4-target.gguf")
        apath = os.path.join(smoke_dir, "gemma4-assistant.gguf")
        make_bench_gemma4_gguf(tpath, n_layers=4, is_swa=(1, 1, 1, 0), shared_kv_layers=0,
                               n_embd_per_layer=0, n_expert=0, moe_layers=(), alt_v_layers=(),
                               untied_head=True, block_gain=0.15, seed=0, **shape)
        make_bench_gemma4_assistant_gguf(apath, n_layers=2, is_swa=(1, 0),
                                         n_embd_out=shape["n_embd"], mirror_of=tpath,
                                         block_gain=0.15, h_gain=0.05, seed=1, **shape)
        target, draft = load_model(tpath), load_model(apath)
        os.remove(tpath)
        os.remove(apath)
        kw = dict(n_ctx=1024, n_seqs=1, n_ubatch=512, quantized_kv=True)
        prompt = [int(t) for t in prng.integers(3, shape["vocab_size"], FAMILY_PROMPT)]
        greedy = Context(target, **kw).generate(prompt, max_new_tokens=16)
        ctx = Context(target, **kw)
        spec = Gemma4AssistantSpeculator(draft, ctx, p_min=0.0)
        must = (qmm_must(target, ubatch=True) | qmm_must(draft, ubatch=False)
                | set(paged_keys + slots_keys + ring_keys))
        reset_counts()
        ids, stats = speculative_generate(ctx, spec, prompt, max_new_tokens=16, n_draft=4)
        all_counts[label] = read_counts(label, sorted(must))
        same = ids == greedy
        log(f"{label} ({card}): speculative_generate with the assistant over the target's "
            f"memory: {stats}; ids equal Context.generate's {same}")
        if not stats["n_accept"]:
            failures.append(f"{label}: the target accepted none of the assistant's "
                            f"{stats['n_draft']} drafts")
        if not same:
            hold_ids(label, target, prompt, ids, **kw)
        del ctx, spec, target, draft
        torch.cuda.empty_cache()

    planes_phase = timed(planes_phase, "path")
    gemma4_assistant_round = timed(gemma4_assistant_round, "path")
    planes_phase()
    g3n_model = arch_path(
        "gemma-3n-e4b", *WIDE["gemma-3n-e4b"], 262144, full_keys + slots_keys + ring_keys,
        "Gemma-3n-E4B shape (google/gemma-3n-E4B config.json, text_config: n_embd 2048, 8 "
        "heads on 2 KV heads of 256, n_ff 16384, per-layer inputs of 256 from a 262144-row "
        "table, 4 AltUp streams, LAUREL rank 64, window 512 on four layers of five, the last 15 "
        "of 35 layers sharing KV, activation sparsity on the first 10, final softcap 30, a "
        f"tied head; depth 35 -> {GEMMA3N_LAYERS}, {GEMMA3N_SHARED} shared), the types "
        "llama-quantize gives each tensor under Q4_K_M, synthetic block scales / 256",
        near_ties=True, keep=True)
    gemma3n_lines(g3n_model, "gemma-3n-e4b")
    del g3n_model
    torch.cuda.empty_cache()
    family_path("gemma4", dict(is_swa=(1, 0, 1, 1), sliding_window=64))
    family_path("minimax-m3", MINIMAX_M3_LAYOUT)
    gemma4_assistant_round()

    # the dense-decoder families that differ from llama only in block variants
    arch_path(
        "starcoder2-7b", *WIDE["starcoder2-7b"], 49152, full_keys,
        "StarCoder2-7B shape (bigcode/starcoder2-7b config.json: n_embd 4608, 36 heads on 4 KV "
        "heads of 128 (G = 9), a non-gated GELU FFN of 18432, biases throughout, LayerNorm eps "
        "1e-5, NEOX rope 1e6, vocab 49152; depth 32 -> "
        f"{STARCODER2_LAYERS}), Q4_K_M mix, an untied Q6_K head, synthetic block scales / 256",
        server=True, near_ties=True, routes=True)
    arch_path(
        "command-r", *WIDE["command-r"], 256000, full_keys,
        "Command-R v01 shape (CohereForAI/c4ai-command-r-v01 config.json: n_embd 8192, 64 heads "
        "and 64 KV heads of 128, a SwiGLU FFN of 22528, one LayerNorm without bias feeding a "
        "parallel residual, logit scale 0.0625, NORM rope 8e6, vocab 256000, tied; depth 40 -> "
        f"{COMMAND_R_LAYERS}), Q4_K_M mix, the tied Q6_K token_embd on the library route",
        n_gen=16, near_ties=True, routes=True)
    t0 = time.perf_counter()
    for arch, layout in FAMILY_LAYOUTS.items():
        if arch not in ("starcoder2", "command-r", "gpt-oss"):
            family_path(arch, layout)
    torch.cuda.empty_cache()

    def default_scale(arch):
        """The default synthetic scale on a narrow file of a biased family:
        logged, not held."""
        path = os.path.join(smoke_dir, f"family-{arch}-scale1.gguf")
        make_bench_arch_gguf(path, arch, **{**FAMILY_SHAPE, **FAMILY_LAYOUTS[arch]}, seed=0)
        sc_model = load_model(path)
        os.remove(path)
        sc_prompt = [int(t) for t in prng.integers(3, FAMILY_SHAPE["vocab_size"],
                                                   FAMILY_PROMPT)]
        sc_kw = dict(n_ctx=1024, n_seqs=1, n_ubatch=512, quantized_kv=True)
        sc_err = nmse(torch.from_numpy(Context(sc_model, **sc_kw).prefill(sc_prompt)),
                      torch.from_numpy(Context(sc_model, kernels=False,
                                               **sc_kw).prefill(sc_prompt)))
        del sc_model
        log(f"family {arch} at the default synthetic scale (n_embd 1024; {card}): kernel path "
            f"against the plain path, prefill logits NMSE {sc_err:.3e} (logged, not held: near "
            "one-hot attention, bf16 q and P in the kernels against the plain path's f32)")

    default_scale("starcoder2")
    log(f"the other {len(FAMILY_LAYOUTS) - 3} families (dense and MoE): "
        f"{time.perf_counter() - t0:.1f} s")

    # the MoE families at full width: gpt-oss-20B (K7 at 2880, its 64-wide
    # last column tile; sinks on K5 and in K6's ring mode at prefill) and
    # Llama-4-Scout (K1-K5, K5 at G = 5, K7 at top 1)
    gpt_oss_keys = (expert_key, "flash_attention_paged/prefill", "flash_attention/prefill",
                    "flash_attention/prefill ring")
    arch_path(
        "gpt-oss-20b", *WIDE["gpt-oss-20b"], 201088, gpt_oss_keys,
        "gpt-oss-20B shape (openai/gpt-oss-20b config.json: n_embd 2880, 64 query heads on 8 "
        "KV heads of 64 with sinks, q/k/v and output biases, window 128 on even layers and "
        "full attention on odd ones, NEOX rope 150000 (freq_base_swa the same) with YaRN "
        "factor 32 from 4096, 32 experts of 2880 top 4 (softmax over the top 4 of the biased "
        "router's logits), expert biases, the clamped oai GLU, vocab 201088; depth 24 -> "
        f"{GPT_OSS_LAYERS}), experts MXFP4, every other matrix Q8_0: K % 256 != 0 or O % 128 "
        "!= 0, so every dense product and the head take the library route, as the JAX "
        "package leaves them to XLA; attention at 8 rows a KV head a decode token takes the "
        "einsum path, as the JAX package's; B = 4 (16 pairs: K7's gather route; at 8 the "
        "per-expert route); synthetic block scales / 256",
        profile_qe=qmm_expert, server=True, near_ties=True, routes=True, library=True,
        batch=4)
    default_scale("gpt-oss")
    arch_path(
        "llama4-scout", *WIDE["llama4-scout"], 202048, full_keys + (expert_key,),
        "Llama-4-Scout-17B-16E shape (meta-llama/Llama-4-Scout-17B-16E config.json, text "
        "config: n_embd 5120, 40 heads on 8 KV heads of 128 (G = 5), NORM rope 500000 with "
        "every fourth layer NoPE (not the first), the weightless q/k norm after rope, "
        "16 experts of 8192 top 1 by sigmoid "
        "with the gate on the expert input, an ungated shared expert of 8192, vocab 202048; "
        f"depth 48 -> {SCOUT_LAYERS}), Q4_K_M mix; synthetic block scales / 256",
        profile_qe=qmm_expert, server=True, near_ties=True, routes=True)

    # the recurrent and hybrid memories at full width: Qwen3-Next-80B-A3B
    # (gated DeltaNet, gated attention, 512 experts: K7 at top 10) and
    # Nemotron-H-8B (Mamba-2, NoPE attention, relu^2 FFN blocks)
    t0 = time.perf_counter()
    model = arch_path(
        "qwen3-next-80b-a3b", *WIDE["qwen3-next-80b-a3b"], 151936, full_keys + (expert_key,),
        "Qwen3-Next-80B-A3B shape (Qwen/Qwen3-Next-80B-A3B-Instruct config.json: n_embd 2048; "
        "layers 0-2 gated DeltaNet (16 key heads, 32 value heads of 128, conv 4), layer 3 gated "
        "full attention (16 query heads on 2 KV heads of 256, NEOX rope over 64 dims at 1e7, "
        "per-head q/k norms, a sigmoid output gate); 512 experts of 512, top 10, softmax "
        "normalised, a sigmoid-gated shared expert of 512; vocab 151936; depth 48 -> "
        f"{QWEN3NEXT_LAYERS}), Q4_K_M mix; the recurrent state beside the pool (HybridMemory), "
        "exact-shape ubatches and decode batches; synthetic block scales / 256",
        profile_qe=qmm_expert, server=True, near_ties=True, routes=True, keep=True)
    mixer_phase(model, "qwen3-next-80b-a3b")
    del model
    torch.cuda.empty_cache()
    model = arch_path(
        "nemotron-h-8b", *WIDE["nemotron-h-8b"], 131072, full_keys,
        "Nemotron-H-8B shape (nvidia/Nemotron-H-8B-Base-8K config.json: n_embd 4096; the first "
        f"{NEMOTRON_H_LAYERS} blocks of hybrid_override_pattern M-M-M-M*-...: Mamba-2 at 0, 2, "
        "4, 6 (128 heads of 64, 8 groups, state 128, conv 4), relu^2 FFN blocks of 21504 at 1, "
        "3, 5, NoPE attention at 7 (32 heads on 8 KV heads of 128); vocab 131072; 52 blocks), "
        "Q4_K_M mix; synthetic block scales / 256",
        server=True, near_ties=True, routes=True, keep=True)
    mixer_phase(model, "nemotron-h-8b")
    del model
    torch.cuda.empty_cache()
    for arch, layout in HYBRID_LAYOUTS.items():
        if arch not in ("qwen3next", "nemotron_h"):
            family_path(arch, layout)
            if arch in F32_FAMILIES:
                f32_reading(arch, layout)
    torch.cuda.empty_cache()
    log(f"the hybrid paths, the {len(HYBRID_LAYOUTS) - 2} narrow ones included: "
        f"{time.perf_counter() - t0:.1f} s")

    # RWKV on the recurrent memory: RWKV-7 World 2.9B at full width (its own
    # forward, models/rwkv.py; K1-K4 on its projections), then the other
    # three RWKV entries narrow
    t0 = time.perf_counter()
    model = arch_path(
        "rwkv7-2.9b", *WIDE["rwkv7-2.9b"], 65536, decode_keys + prefill_keys,
        "RWKV-7 World 2.9B shape (BlinkDL RWKV-x070-World-2.9B: n_embd 2560, 40 heads of 64, "
        "channel mix 10240, vocab 65536, LoRA ranks 96 decay, 96 in-context learning rate, 64 "
        f"value residual, 320 gate; depth 32 -> {RWKV7_LAYERS}, so v_first crosses layers), "
        "Q4_K_M mix as llama-quantize writes an RWKV file (Q4_K projections, Q6_K channel-mix "
        "value and head, the LoRA factors and mixing vectors F32); the RecurrentState alone "
        "(2 token-shift rows of 2560 and a 64 x 2560 f32 wkv plane a layer and a sequence), "
        "exact-shape ubatches and decode batches; synthetic block scales / 256",
        server=True, near_ties=True, routes=True, keep=True)
    rwkv_state_phase(model, "rwkv7-2.9b")
    del model
    torch.cuda.empty_cache()
    for arch in RWKV_ARCHS:
        if arch != "rwkv7":
            family_path(arch, {"n_kv_heads": 8} if arch == "rwkv6qwen2" else {})
    torch.cuda.empty_cache()
    log(f"the RWKV paths (RWKV-7 2.9B and 3 narrow entries): {time.perf_counter() - t0:.1f} s")
    for key, row in res["qmm_planes_expert"]["rows"].items():
        path = next((p for p in ("gpt-oss-20b", "llama4-scout", "qwen3-next-80b-a3b")
                     if key.startswith(p[:6])), None)
        if path is not None:  # the model path's own launches, graph replays included
            row["launches"] = all_counts[path][expert_key] + all_counts[f"{path} graphs"][
                expert_key]

    # DeepSeek's Multi-head Latent Attention: K5/K6's MLA instantiation
    mla_paged = ("flash_attention_paged/mla decode", "flash_attention_paged/mla prefill")
    mla_slots = ("flash_attention/mla decode", "flash_attention/mla prefill")
    qmm_keys = decode_keys + prefill_keys
    ds_model = arch_path(
        "deepseek-v2-lite", *WIDE["deepseek-v2-lite"], 102400,
        qmm_keys + mla_paged + (expert_key,),
        "DeepSeek-V2-Lite shape (deepseek-ai/DeepSeek-V2-Lite config.json: n_embd 2048, 16 "
        "heads, no q-LoRA, kv_lora 512, qk_nope 128, qk_rope 64, v 128, 64 routed experts of "
        "1408 top 6 by softmax, 2 shared, vocab 102400, YaRN factor 40, mscale 0.707; depth "
        f"27 -> {DS_LITE_LAYERS}: layer 0 dense (n_ff 10944), the rest MoE), Q4_K_M mix, F32 "
        "where rows are not a multiple of 256 (dense ffn_down, expert down); the absorbed "
        "cache: one KV head of K 640 (512 + 64 pad + 64) and V 512",
        profile_qe=qmm_expert, server=True, near_ties=True, keep=True, routes=True)
    mla_extras(ds_model, "deepseek-v2-lite", qmm_keys + mla_paged + (expert_key,),
               qmm_keys + mla_slots + (expert_key,))
    del ds_model
    torch.cuda.empty_cache()
    arch_path(
        "deepseek-v3", *WIDE["deepseek-v3"], 129280, qmm_keys + ("flash_attention_paged/mla prefill", expert_key),
        "DeepSeek-V3 shape (deepseek-ai/DeepSeek-V3 config.json: n_embd 7168, 128 heads, "
        "q-LoRA 1536, kv_lora 512, qk_nope 128, qk_rope 64, v 128, 256 routed experts of 2048 "
        "top 8 by sigmoid with exp_probs_b, normalised, scaled by 2.5, one shared, vocab 129280, "
        f"YaRN factor 40; depth 61 -> {DS_V3_LAYERS}: one MoE layer (the file's first three are "
        "dense layers of 18432); group-limited routing (n_group 8, topk_group 4) is not read, "
        "as in the JAX package), Q4_K_M mix; 128 query rows a KV head at B=1: every attention "
        "on the MLA prefill kernel", full=False, near_ties=True, routes=True)

    # MLA at MHA width: MiniCPM3-4B's absorbed row (384, 256) through K5/K6's
    # second MLA pair, on the pool and the slot table, int8 and bf16
    t0 = time.perf_counter()
    model = arch_path(
        "minicpm3-4b", *WIDE["minicpm3-4b"], 73448, qmm_keys + mla_paged,
        "MiniCPM3-4B shape (openbmb/MiniCPM3-4B config.json: n_embd 2560, 40 heads, q-LoRA 768, "
        "kv_lora 256, qk_nope 64, qk_rope 32, v 64, a SwiGLU FFN of 6400, vocab 73448, tied; "
        "embedding x 12, residual x 1.4 / sqrt(62), logits x 256 / 2560; depth 62 -> "
        f"{MINICPM3_LAYERS}), Q4_K_M mix, F32 where rows are not a multiple of 256; the "
        "absorbed cache: one KV head of K 384 (256 + 96 pad + 32) and V 256, G = 40 query rows "
        "a token; the tied Q6_K head of 73448 rows (no multiple of 64) row-major on the library "
        "route, as the JAX package leaves it to XLA; synthetic block scales / 256",
        server=True, near_ties=True, routes=True, keep=True)
    minicpm3_memories(model, "minicpm3-4b", qmm_keys)
    del model
    torch.cuda.empty_cache()
    for arch, layout in MLA_FAMILY_LAYOUTS.items():
        if arch != "minicpm3":
            family_path(arch, layout)
    for arch, layout in LATE_FAMILY_LAYOUTS.items():
        family_path(arch, layout)
    torch.cuda.empty_cache()
    log(f"MiniCPM3-4B and the slice's {len(MLA_FAMILY_LAYOUTS) + len(LATE_FAMILY_LAYOUTS) - 1} "
        f"narrow decoder entries: {time.perf_counter() - t0:.1f} s")

    # T5's encoder-decoder (models/t5.py; Context's encoder-decoder flow),
    # the diffusion LMs (runtime/diffusion.py, llama-diffusion-cli) and the
    # shared decoder's last text entries
    def diffusion_held(label, model, prompt, params):
        """diffusion_generate on the kernel path (a Context as
        llama-diffusion-cli builds it: n_ctx = n_ubatch = max_length), each
        step's forward teacher-forced on the plain path over the kernel
        path's sequence before the step: the logits at the step's candidate
        (masked) positions within the limit; the committed positions the
        plain confidence ranking's top count wherever the plain ranking's gap
        at the cut exceeds DIFFUSION_MARGIN times the step's largest
        confidence difference between the two paths (else a near-tie at the
        cut, counted); each committed id the plain argmax or a near-tie
        (against_plain's rule: the plain logit of the id within that row's
        largest logit difference). Every step's forward launches K3 and K4
        and no other kernel. -> (ids, step ms on the host clock)."""
        L = params.max_length
        kw = dict(n_ctx=L, n_seqs=1, n_ubatch=L)
        kern, plain = Context(model, **kw), Context(model, kernels=False, **kw)
        steps = []

        def held(ctx, seq):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lk = diffusion_rt.step_logits(ctx, seq)  # ends in a host copy
            ms = (time.perf_counter() - t0) * 1e3
            counts = {k: v for c in counters for k, v in c.items() if v}
            steps.append((seq.copy(), lk, diffusion_rt.step_logits(plain, seq), ms, counts))
            return lk

        ids = diffusion_rt.diffusion_generate(kern, prompt, params, logits_fn=held)
        mask = params.mask_token_id if params.mask_token_id >= 0 else model.tokenizer.vocab.mask_id
        final = np.asarray(list(prompt) + ids)
        errs, wrong, cut_ties, id_ties, bad_launch = [], [], [], [], []
        for i, (before, lk, lp, _, counts) in enumerate(steps):
            after = steps[i + 1][0] if i + 1 < len(steps) else final
            committed = np.where((before == mask) & (after != mask))[0]
            cand = np.where(before == mask)[0]
            if params.schedule == "block" and len(committed):
                b0 = len(prompt) + (int(committed[0]) - len(prompt)) // params.block_length * (
                    params.block_length)
                cand = cand[(cand >= b0) & (cand < b0 + params.block_length)]
            if set(counts) != set(prefill_keys):
                bad_launch.append((i, counts))
            errs.append(nmse(torch.from_numpy(lk[cand]), torch.from_numpy(lp[cand])))
            pk = diffusion_rt._softmax(lk[cand].astype(np.float64)).max(axis=-1)
            pp = diffusion_rt._softmax(lp[cand].astype(np.float64)).max(axis=-1)
            n = len(committed)
            ranked = np.sort(pp)[::-1]
            gap = ranked[n - 1] - ranked[n] if 0 < n < len(cand) else np.inf
            margin = DIFFUSION_MARGIN * float(np.abs(pk - pp).max())
            plain_set = set(cand[np.argsort(-pp, kind="stable")[:n]].tolist())
            if gap > margin and plain_set != set(committed.tolist()):
                wrong.append((i, "positions", round(float(gap), 6), round(margin, 6)))
            elif gap <= margin and n:
                cut_ties.append((i, round(float(gap), 6), round(margin, 6)))
            for j in committed:
                t, row = int(after[j]), lp[j]
                if int(np.argmax(row)) != t:
                    g, d = float(row.max() - row[t]), float(np.abs(lk[j] - row).max())
                    (id_ties if g <= d else wrong).append((i, int(j), t, round(g, 5),
                                                           round(d, 5)))
        step_ms = [s[3] for s in steps]
        log(f"{label} {params.schedule} schedule, {params.algorithm}, {len(steps)} steps of "
            f"{L} rows ({card}): logits at the masked positions against the plain path "
            f"teacher-forced, NMSE largest {max(errs):.3e} (limit {NMSE_LIMIT}); near-ties at "
            f"the cut (step, plain gap, margin) {cut_ties}; committed ids at near-ties (step, "
            f"position, id, plain gap, difference) {id_ties}; step ms (host clock, kernel "
            f"path) median {float(np.median(step_ms)):.3f}, all {[round(m, 3) for m in step_ms]}; "
            f"a step's launches {steps[0][4]}")
        if not max(errs) < NMSE_LIMIT:
            failures.append(f"{label} {params.schedule}: step logits NMSE {errs}")
        if wrong:
            failures.append(f"{label} {params.schedule}: commits off the plain path beyond a "
                            f"near-tie: {wrong[:4]}")
        if bad_launch:
            failures.append(f"{label} {params.schedule}: a step's launches not K3 and K4 "
                            f"alone: {bad_launch[:2]}")
        del kern, plain
        return ids, step_ms

    def llada_path():
        """LLaDA-8B at full width, depth cut to LLADA_LAYERS: llama-diffusion-
        cli on it (max_length 128, 16 steps, confidence), timed, its launches
        read (K3/K4 alone: every projection and the head at 128 rows; the
        bidirectional attention on the einsum path, as in the JAX package);
        then diffusion_held on the same prompt (its ids must equal the
        CLI's) and on the block schedule (blocks of 32)."""
        label = "llada-8b"
        path = os.path.join(smoke_dir, f"{label}.gguf")
        t0 = time.perf_counter()
        # the synthetic blocks at their default scale: at / 256 every masked
        # row's logits are about equal (near-uniform attention over the
        # same tokens), so each step's ranking ties at its cut
        make_bench_diffusion_gguf(path, n_layers=LLADA_LAYERS, seed=0)
        t1 = time.perf_counter()
        model = load_model(path)
        torch.cuda.synchronize()
        log(f"{label}: LLaDA-8B shape (GSAI-ML/LLaDA-8B-Instruct config.json: n_embd 4096, 32 "
            f"heads and 32 KV heads of 128, a SwiGLU FFN of 12288, vocab 126464, mask token "
            f"126336, rope base 500000, bidirectional attention; depth 32 -> {LLADA_LAYERS}), "
            f"Q4_K_M mix; random weights (seed 0) (fixture "
            f"{t1 - t0:.1f} s, load_model {time.perf_counter() - t1:.1f} s, device memory "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB)")
        argv = ["-m", path, "-p", CLI_PROMPT, "--diffusion-steps", "16",
                "--diffusion-max-length", "128", "--diffusion-algorithm", "confidence"]
        with contextlib.redirect_stdout(io.StringIO()):  # one untimed step: start-up
            diffusion_cli.main(argv[:2] + ["-p", "warm", "--diffusion-steps", "1"], model=model)
        reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli_ids = diffusion_cli.main(argv, model=model)
        wall = time.perf_counter() - t0
        os.remove(path)
        counts = read_counts(f"{label} llama-diffusion-cli", prefill_keys)
        all_counts[label] = counts
        prompt = model.tokenizer.encode(CLI_PROMPT)
        ids, step_ms = diffusion_held(label, model, prompt, diffusion_rt.DiffusionParams(
            steps=16, max_length=128, algorithm="confidence"))
        n_steps = len(step_ms)  # the run ends early once no position is masked
        log(f"{label} llama-diffusion-cli ({card}): {len(prompt)}-token prompt, 128 rows, at "
            f"most 16 steps ({n_steps} run, as the held run's): {wall * 1e3:.1f} ms, "
            f"{len(cli_ids) / wall:.1f} tokens a second ({len(cli_ids)} generated), "
            f"{wall * 1e3 / n_steps:.2f} ms a step; K3 {counts['qmm4_planes_prefill/wgmma']} and "
            f"K4 {counts['qmm_planes_prefill/wgmma']} launches "
            f"({counts['qmm4_planes_prefill/wgmma'] / n_steps:g} and "
            f"{counts['qmm_planes_prefill/wgmma'] / n_steps:g} a step)")
        if ids != cli_ids:
            failures.append(f"{label}: the held run's ids part from llama-diffusion-cli's")
        diffusion_held(label, model, prompt, diffusion_rt.DiffusionParams(
            steps=16, max_length=128, algorithm="confidence", schedule="block",
            block_length=32))
        seq = np.full(128, model.tokenizer.vocab.mask_id)
        seq[: len(prompt)] = prompt
        pctx = Context(model, n_ctx=128, n_seqs=1, n_ubatch=128)
        diffusion_rt.step_logits(pctx, seq)
        profile_call(label, "a diffusion step's forward (128 rows, the logits to the host)",
                     lambda: diffusion_rt.step_logits(pctx, seq), float(np.median(step_ms)))
        del model, pctx
        torch.cuda.empty_cache()

    def diffusion_family_path(arch):
        """A diffusion entry narrow (FAMILY_SHAPE's widths, the Q4_K_M mix):
        diffusion_held at 128 rows, 4 steps (the MoE pair's experts on the
        per-expert route: no K7 at 128 rows)."""
        label = f"family {arch}"
        path = family_path_file(arch)
        family_file(path, arch, {})
        model = load_model(path)
        os.remove(path)
        prompt = [int(t) for t in prng.integers(3, model.cfg.vocab_size - 1, 40)]
        reset_counts()
        diffusion_held(label, model, prompt, diffusion_rt.DiffusionParams(steps=4,
                                                                          max_length=128))
        all_counts[label] = read_counts(label, prefill_keys)
        del model

    def t5_path():
        """flan-t5-large at full width, both stacks cut to T5_LAYERS:
        Context.generate from a 96-token prompt (the encoder at its 128-row
        bucket on K3/K4, each decoder step on K1/K2 with its cross K/V
        projected at 128 rows on K3/K4; attention plain in both packages),
        the encode and a decoder step timed, the plain path on the start
        token's logits, 8 teacher-forced steps and each id (near_ties); a
        batch of 3 sequences whose encoder outputs are 96, 40 and 200 rows
        (one cross state padded to 256) against each row's B=1 run; a
        served round against Context.generate."""
        label = "flan-t5-large"
        path = os.path.join(smoke_dir, f"{label}.gguf")
        t0 = time.perf_counter()
        make_bench_t5_gguf(path, n_layers=T5_LAYERS, n_dec_layers=T5_LAYERS,
                           synth_scale=FAMILY_SYNTH_SCALE, seed=0)
        t1 = time.perf_counter()
        model = load_model(path)
        os.remove(path)
        log(f"{label}: flan-t5-large shape (google/flan-t5-large config.json: d_model 1024, 16 "
            f"heads of 64, a gated-GELU FFN of 2816, 32 relative-position buckets, vocab 32128, "
            f"an untied head; 24 encoder and 24 decoder layers -> {T5_LAYERS} each), Q4_K_M "
            f"mix, synthetic block scales / 256; random weights (seed 0) (fixture "
            f"{t1 - t0:.1f} s, load_model {time.perf_counter() - t1:.1f} s)")
        kw = dict(n_ctx=512, n_seqs=4, n_ubatch=512, quantized_kv=True)
        ctx = Context(model, **kw)
        vocab = model.cfg.vocab_size
        prompt = [int(t) for t in prng.integers(3, vocab, 96)]
        ctx.prefill(prompt[:80], seq=3)  # the allocator's first allocations
        ctx.seq_rm(3)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.encode(prompt, seq=2)  # ends in a host copy
        enc_ms = (time.perf_counter() - t0) * 1e3
        logits = ctx.prefill(prompt, seq=1)
        n0, d0 = ctx.perf.n_decode, ctx.perf.t_decode_ms
        gen_ids = ctx.generate(prompt, max_new_tokens=32, seq=0)
        step_ms = (ctx.perf.t_decode_ms - d0) / max(ctx.perf.n_decode - n0, 1)
        del ctx
        all_counts[label] = read_counts(label, decode_keys + prefill_keys)
        check_logits(label, logits, vocab)
        log(f"{label} ({card}): encode of 96 tokens {enc_ms:.3f} ms, decoder step (eager, "
            f"B=1, cross state of 128 rows) {step_ms:.3f} ms, {1e3 / step_ms:.1f} tokens a "
            f"second (host clock); launches K1 {all_counts[label]['qmm4_planes/decode']}, K2 "
            f"{all_counts[label]['qmm_planes/decode']}, K3 "
            f"{all_counts[label]['qmm4_planes_prefill/wgmma']}, K4 "
            f"{all_counts[label]['qmm_planes_prefill/wgmma']}")
        pctx = Context(model, **kw)
        pctx.prefill(prompt)
        profile_call(label, "an encode of 96 tokens", lambda: pctx.encode(prompt, seq=1), enc_ms)
        profile_call(label, "a decoder step (B=1, eager)",
                     lambda: pctx.decode_one(gen_ids[0]), step_ms)
        del pctx
        against_plain(label, model, logits, gen_ids, prompt, decode_logits=8, near_ties=True,
                      **{**kw, "n_seqs": 2})
        prompts3 = [prompt, prompt[:40], [int(t) for t in prng.integers(3, vocab, 200)]]
        bctx = Context(model, **kw)
        toks = np.asarray([int(np.argmax(bctx.prefill(p, seq=s)))
                           for s, p in enumerate(prompts3)], np.int32)
        rows = [[int(t)] for t in toks]
        for _ in range(8):
            toks = bctx.decode_step_greedy(toks, np.arange(3))
            for s in range(3):
                rows[s].append(int(toks[s]))
        del bctx
        for s, p in enumerate(prompts3):
            single = Context(model, **kw).generate(p, max_new_tokens=9)
            same = single == rows[s]
            log(f"{label} batch of 3 (encoder outputs of {[len(q) for q in prompts3]} rows), "
                f"row {s}: ids equal to its B=1 run {same}")
            if not same:
                hold_ids(f"{label} batch row {s}", model, p, rows[s], **kw)
        server_round(model, f"{label} server", must_run=decode_keys + prefill_keys,
                     near_ties=True)
        del model
        torch.cuda.empty_cache()

    llada_path, diffusion_family_path, t5_path = (
        timed(f, "path") for f in (llada_path, diffusion_family_path, t5_path))
    t0 = time.perf_counter()
    llada_path()
    for arch in DIFFUSION_LAYOUTS:
        if arch != "llada":
            diffusion_family_path(arch)
    log(f"the diffusion paths (LLaDA-8B and 3 narrow entries): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    t5_path()
    log(f"the flan-t5-large path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for arch, layout in LAST_TEXT_LAYOUTS.items():
        family_path(arch, layout)
    family_path("laguna", LAGUNA_ELEMENT_GATE, name="laguna element gate")
    torch.cuda.empty_cache()
    log(f"the last shared-decoder entries (5 narrow paths): {time.perf_counter() - t0:.1f} s")

    # the storage types users download beside Q4_K_M, on the main path
    q8_model = arch_path(
        "qwen3-8b-q8_0", *WIDE["qwen3-8b-q8_0"], 151936, int8_keys,
        "Qwen3-8B shape, every matrix Q8_0 (token_embd and output included; the Q8_0 "
        "file of Qwen/Qwen3-8B-GGUF), F32 norms", want_layout="int8 flat g32",
        near_ties=True, keep=True)
    arch_path("qwen3-8b-q5_k_m", *WIDE["qwen3-8b-q5_k_m"], 151936, int8_keys,
              "Qwen3-8B shape, Q5_K_M mix (Q5_K everywhere, Q6_K attn_v)", n_gen=16, full=False)
    arch_path("qwen3-8b-q4_0", *WIDE["qwen3-8b-q4_0"], 151936,
              ("qmm4_planes/decode", "qmm4_planes_prefill/wgmma", "qmm_planes/decode")
              + paged_keys,
              "Qwen3-8B shape, Q4_0 (Q6_K output)", n_gen=16, full=False)
    small = path_quantize()
    path_s(q8_model, *small)
    del q8_model
    torch.cuda.empty_cache()
    for f in small:
        os.remove(f)
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
                 **{k: "flash_attn_mla.cuh" for k in mla_paged + mla_slots},
                 "qmm_planes_expert": "qmm_expert.cu", **{k: "qmm_prefill.cu" for k in prefill_keys},
                 **{k: "qmm_decode.cu" for k in decode_keys},
                 **{name: "qmm_bench.cu" for name in qmm_bench.launches}}
    # launches: from the path that is the kernel's own (the llama path on the
    # pool, the slot-table path, the Mixtral path, the microbenchmark)
    path_of = {**{k: "llama slots" for k in slots_keys}, "qmm_planes_expert": "mixtral",
               **{k: "deepseek-v2-lite" for k in mla_paged},
               **{k: "deepseek-v2-lite context shift (slot table)" for k in mla_slots},
               **{name: "bench_qmm" for name in qmm_bench.launches}}
    kernels = []
    for name, r in res.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "llama_cpp_tpu_torch/csrc/" + source_of[name],
                        "replaces": tpu_of[name.split("/")[0]],
                        "launches": all_counts[path_of.get(name, "llama paged")][name],
                        "launches_by_path": {p: c[name] for p, c in all_counts.items()},
                        **({"ring_launches_by_path": {p: c[f"{name} ring"]
                                                      for p, c in all_counts.items()}}
                           if f"{name} ring" in ring_keys else {}),
                        "max_abs_err": r["max_abs_err"],
                        "nmse": r["nmse"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **({k: r[k] for k in ("kernel", "tile", "rows", "types") if k in r})})
    log("decode loop, graphed and eager, ms a step by path and B (smoke runs, not a "
        f"benchmark; {card}): " + json.dumps(graph_rows))
    total = time.perf_counter() - t_all
    paths = sum(v for k, v in sections.items() if k.startswith("path "))
    sections["other (the inline paths and phases)"] = (
        total - paths - sections["build"] - sections["phase 3"])
    log(f"chip_smoke: {total:.1f} s")
    log(f"card: {gpu_line()}")
    print("sections (s): " + json.dumps({k: round(v, 1) for k, v in sections.items()}),
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
