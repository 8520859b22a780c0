"""Scratch memory of the kernels whose last block merges split partial sums
(csrc/qmm_decode.cu, csrc/flash_attn_common.cuh decode, csrc/qmm_expert.cu,
csrc/qmm_bench.cu B2): per (device, stream), the partial sums and the
counters that each launch leaves zero (the last block of a tile resets its
own), so launches on one stream, which run in order, may share them. Each
kernel module keeps its own cache.

A launch passes the buffers' raw addresses, so a CUDA graph captured over
it holds no reference to them. `holding()` collects every buffer handed out
inside it; a graph keeps that list for as long as it lives, so a later
eager call that grows a buffer cannot free the one the graph replays into.
"""

from __future__ import annotations

import contextlib

import torch

_HOLDERS: list[list[torch.Tensor]] = []


@contextlib.contextmanager
def holding():
    """Collect, into the list it yields, every scratch buffer handed out by
    any kernel module inside the block (a graph's capture)."""
    held: list[torch.Tensor] = []
    _HOLDERS.append(held)
    try:
        yield held
    finally:
        _HOLDERS.remove(held)


def hand_out(*tensors: torch.Tensor | None) -> None:
    """Note buffers a launch is about to use with every open `holding()`."""
    for held in _HOLDERS:
        held.extend(t for t in tensors if t is not None)


def grow(cache: dict, device: torch.device, stream: int, n_floats: int, n_counters: int):
    """(partial sums, counters) from `cache` of at least the sizes asked,
    grown when short."""
    key = (device.index, stream)
    part, counters = cache.get(key, (None, None))
    if part is None or part.numel() < n_floats:
        part = torch.empty(max(n_floats, 1 << 20), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 4096), dtype=torch.int32, device=device)
    cache[key] = (part, counters)
    hand_out(part, counters)
    return part, counters
