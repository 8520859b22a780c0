"""Device time of a function on the card, by CUDA events.

Shared by the entry points that measure (tools/bench_qmm.py) and by
chip_smoke.py, so that their numbers are taken the same way.
"""

from __future__ import annotations

import torch


class Timer:
    """Mean device time in ms of fn over reps launches, by CUDA events around
    each launch, with the 50 MB L2 flushed by a read before every launch (a decode step
    reads each weight and KV page once). A spin kernel before the start event
    lets the host enqueue fn's launches ahead of the device, so the interval
    holds device time, not Python launch overhead."""

    SPIN_CYCLES = 2_000_000  # about 1 ms on an H100

    def __init__(self, device="cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("Timer measures device time and needs a CUDA device")
        self.flush_buf = torch.zeros(128 << 20, dtype=torch.uint8, device=device)
        self.flush_sum = None

    def flush(self) -> None:
        """Push the timed function's data out of the L2 by reading 128 MB
        (a sum over a buffer kept alive). Read lines are clean, so the timed
        kernel pays for no write-back of the flush, only for its own misses."""
        self.flush_sum = self.flush_buf.sum()

    def __call__(self, fn, reps: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps
