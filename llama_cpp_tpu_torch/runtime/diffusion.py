"""Diffusion-LM generation: iterative parallel unmasking.

The port's own copy of the JAX package's runtime/diffusion.py (analog of
reference examples/diffusion/diffusion.cpp diffusion_generate). The
sequence starts as [prompt, mask, mask, ...]; each step runs one
bidirectional forward over the whole sequence (Context.decode of all
max_length rows at positions 0..L-1 on a cleared sequence 0: on the card
the projections take the prefill GEMMs from 64 rows), scores every
still-masked position with a confidence function and commits the top
`transfer_count` positions. The algorithms and transfer schedules are the
reference's enums (origin / entropy / margin / random / confidence;
timestep or block). The host side is numpy, its generator drawn in the
JAX package's order (rng.random, rng.choice, rng.gumbel), so equal logits
give equal ids in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ALGORITHMS = ("origin", "entropy", "margin", "random", "confidence")


@dataclass
class DiffusionParams:
    steps: int = 64
    max_length: int = 128
    algorithm: str = "confidence"  # reference enum order 0..4
    schedule: str = "timestep"  # timestep | block
    block_length: int = 32
    temperature: float = 0.0
    eps: float = 1e-3
    alg_temp: float = 0.0  # gumbel on the confidence ranking (random pick)
    seed: int = 0
    mask_token_id: int = -1  # -1: the vocab's mask_id
    add_gumbel_noise: bool = False


def _num_transfer_tokens(mask_count: int, steps: int) -> list[int]:
    """mask_count spread over steps, the remainder on the first steps."""
    base, rem = divmod(mask_count, max(steps, 1))
    return [base + (1 if i < rem else 0) for i in range(steps)]


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def step_logits(ctx, seq: np.ndarray) -> np.ndarray:
    """One step's forward: the whole sequence as one ubatch of sequence 0 at
    positions 0..L-1 over a cleared memory -> logits [L, vocab] f32 on the
    host, with Dream's shift applied (position i scored by the logits of
    i - 1)."""
    L = len(seq)
    ctx.seq_rm(0)
    logits = ctx.decode(seq[None, :], np.asarray([0]), np.arange(L)[None, :], np.arange(L))
    ctx.seq_len[0] = 0
    if ctx.cfg.extra.get("diffusion_shift_logits", False):
        logits = np.concatenate([logits[:1], logits[:-1]], axis=0)
    return logits


def diffusion_generate(ctx, prompt: list[int], p: DiffusionParams, step_cb=None,
                       logits_fn=step_logits) -> list[int]:
    """-> the generated ids (the positions after the prompt). step_cb(step,
    seq) sees the sequence after each step; logits_fn(ctx, seq) is the
    step's forward (step_logits by default; a check may wrap it)."""
    mask_id = p.mask_token_id
    if mask_id < 0:
        tok = ctx.model.tokenizer
        mask_id = getattr(tok.vocab, "mask_id", -1) if tok else -1
    if mask_id < 0:
        raise ValueError("diffusion model needs a mask token id")

    rng = np.random.default_rng(p.seed)
    L = p.max_length
    n_input = len(prompt)
    seq = np.full(L, mask_id, dtype=np.int64)
    seq[:n_input] = prompt

    if p.schedule == "block":
        n_blocks = max(1, -(-(L - n_input) // p.block_length))
        steps_per_block = max(1, p.steps // n_blocks)
    else:
        n_blocks, steps_per_block = 1, p.steps

    global_step = 0
    for block in range(n_blocks):
        if p.schedule == "block":
            b0 = n_input + block * p.block_length
            b1 = min(b0 + p.block_length, L)
            transfers = _num_transfer_tokens(int(np.sum(seq[b0:b1] == mask_id)),
                                             steps_per_block)
        else:
            b0, b1 = 0, L
            transfers = []

        for step in range(steps_per_block):
            mask_pos = np.where(seq[b0:b1] == mask_id)[0] + b0
            if p.schedule != "block":
                mask_pos = np.where(seq == mask_id)[0]
            if len(mask_pos) == 0:
                break
            lg = logits_fn(ctx, seq)[mask_pos].astype(np.float64)
            if p.add_gumbel_noise and p.temperature > 0:
                g = -np.log(-np.log(rng.random(lg.shape) + 1e-20) + 1e-20)
                lg = lg / p.temperature + g

            if p.temperature > 0 and not p.add_gumbel_noise:
                probs = _softmax(lg / p.temperature)
                picks = np.array([rng.choice(len(pr), p=pr / pr.sum()) for pr in probs])
            else:
                probs = _softmax(lg)
                picks = lg.argmax(axis=-1)

            if p.algorithm == "origin":
                t = (step + 1) / steps_per_block
                count = transfers[step] if transfers else None
                pt = (count / len(mask_pos)) if count is not None else (
                    1.0 - (1.0 - p.eps) * (1.0 - t))
                take = rng.random(len(mask_pos)) < pt
                seq[mask_pos[take]] = picks[take]
            else:
                pp = probs[np.arange(len(picks)), picks]
                if p.algorithm == "confidence":
                    conf = pp
                elif p.algorithm == "entropy":
                    conf = np.sum(probs * np.log(probs + 1e-12), axis=-1)
                elif p.algorithm == "margin":
                    top2 = np.partition(probs, -2, axis=-1)[:, -2:]
                    conf = top2[:, 1] - top2[:, 0]
                elif p.algorithm == "random":
                    conf = rng.random(len(mask_pos))
                else:
                    raise ValueError(f"unknown algorithm {p.algorithm!r}")
                if transfers:
                    count = transfers[step]
                else:
                    t = (step + 1) / steps_per_block
                    remain = 1.0 - (1.0 - p.eps) * (1.0 - t)
                    count = max(1, int(round(len(mask_pos) * remain)))
                count = min(count, len(mask_pos))
                if p.alg_temp > 0:  # stochastic ranking
                    conf = conf / p.alg_temp + rng.gumbel(size=conf.shape)
                order = np.argsort(-conf)[:count]
                seq[mask_pos[order]] = picks[order]
            global_step += 1
            if step_cb:
                step_cb(global_step, seq.copy())
        if p.schedule != "block":
            break
    return [int(t) for t in seq[n_input:]]
