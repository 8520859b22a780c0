"""Scratch memory of the kernels whose last block merges split partial sums
(csrc/flash_attn_common.cuh decode, csrc/qmm_expert.cu, csrc/qmm_bench.cu
B2): per (device, stream), the partial sums and the counters that each
launch leaves zero (the last block of a tile resets its own), so launches on
one stream, which run in order, may share them. Each kernel module keeps its
own cache."""

from __future__ import annotations

import torch


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
    return part, counters
