"""qmm GEMV bandwidth microbenchmark on the card (counterpart of the JAX
package's scripts/bench_qmm.py).

    python -m llama_cpp_tpu_torch.tools.bench_qmm [case ...] [--device cpu]

cases: stream qmm4 qmm8 fp i16 tiles shapes 4d (default: stream qmm4 qmm8
tiles). Each line is one kernel at one shape: microseconds of device time by
CUDA events around the launch (L2 flushed before it), GB/s of quantized
bytes streamed, the byte bound (plane bytes over the card's memory rate) and
the share of that rate reached.

  stream  the stream probe: every plane byte through the SM (the ceiling)
  qmm4    the decode product kernel on the same packed planes (half-split
          pairing, flat f32 scales), with and without mins
  qmm8    the same kernel on int8 planes
  fp/i16  the even/odd GEMV with the nibbles unpacked by bf16 bit tricks / by
          shift, mask and convert, after a line with its kernel's plan
          (column blocks, K splits, blocks an SM)
  tiles   the even/odd GEMV over a sweep of tiles
  shapes  the same at the four decode shapes of an 8B llama
  4d      the same over planes stored tile by tile, plus the vocab head

A tile the kernel has no instantiation for is skipped and said so; anything
else that fails raises. --device cpu walks the same cases through the plain
versions at a sixteenth of the widths and measures nothing: a rehearsal of
the control flow, not a benchmark.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..models.loader import resolve_device
from ..ops.kernels import qmm, qmm_bench
from ..ops.qtensor import QuantTensor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
CASES = ("stream", "qmm4", "qmm8", "fp", "i16", "tiles", "shapes", "4d")
DEFAULT_CASES = ("stream", "qmm4", "qmm8", "tiles")
GROUP = qmm_bench.GROUP
ROWS = qmm_bench.ROWS
GATEUP = (4096, 28672)  # K, O of the largest decode product
DECODE_SHAPES = (("qkv", 4096, 6144), ("attno", 4096, 4096), ("gateup", *GATEUP),
                 ("down", 14336, 4096))
HEAD = ("head", 4096, 21376 * 6)
# tiles (tn, to, tk) of the reference's sweep, then tiles sized for this card
REFERENCE_TILES = ((8, 2048, 2048), (8, 4096, 1024), (8, 4096, 2048), (8, 2048, 4096),
                   (8, 7168, 1024), (8, 1792, 4096), (8, 3584, 2048), (8, 7168, 512))
CARD_TILES = tuple((8, to, tk) for to in (128, 256, 512) for tk in (256, 1024, 4096))
CARD_SHAPE_TILES = ((128, 512), (256, 1024), (512, 1024), (512, 2048))
CPU_SHRINK = 16  # --device cpu divides the widths by this


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def shape_tiles(o: int):
    """(to, tk) of the reference's per-shape list (scripts/bench_qmm.py:269),
    then the card's."""
    ref = [(o, 512), (o, 1024), (o // 2, 1024), (o // 4, 512), (o // 4, 1024)]
    return [t for t in dict.fromkeys(ref + list(CARD_SHAPE_TILES))
            if (t[1] // 2) * t[0] <= 4 * 1024 * 1024]


def tiles_4d(o: int):
    """(to, tk) of the reference's tile-by-tile list (:368), then the
    card's."""
    ref = [(2048, 1024), (4096, 512), (4096, 1024), (o, 512), (2048, 2048)]
    return [t for t in dict.fromkeys(ref + [(256, 1024), *CARD_SHAPE_TILES])
            if (t[1] // 2) * t[0] <= 3 * 1024 * 1024]


class Bench:
    def __init__(self, device: torch.device):
        self.device = device
        self.timer = None
        if device.type == "cuda":
            from ..utils.timing import Timer

            self.timer = Timer(device)
        self.shrink = 1 if device.type == "cuda" else CPU_SHRINK
        self.rng = np.random.default_rng(0)

    def planes(self, k: int, o: int):
        """Packed planes with f32 scales and mins, and x of 8 rows of ones,
        from the seeded generator."""
        rng = self.rng
        qp = torch.from_numpy(rng.integers(0, 255, (k // 2, o), np.uint8).view(np.int8))
        sc = torch.from_numpy(rng.normal(size=(k // GROUP, o)).astype(np.float32))
        mn = torch.from_numpy(rng.normal(size=(k // GROUP, o)).astype(np.float32))
        x = torch.ones((ROWS, k), dtype=torch.bfloat16)
        return tuple(t.to(self.device) for t in (x, qp, sc, mn))

    def width(self, o: int) -> int:
        return o // self.shrink

    def report(self, label: str, fn, nbytes: int) -> None:
        """Run fn, time it on the card, and print the line."""
        out = fn()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{label}: non-finite output")
        if self.timer is None:
            log(f"{label}: ran on the cpu (plain version), device time not measured")
            return
        ms = self.timer(fn)
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        rate = nbytes / (ms * 1e-3)
        log(f"{label}: {ms * 1e3:.1f} us -> {rate / 1e9:.0f} GB/s; bound {bound_us:.1f} us, "
            f"{rate / HBM_BYTES_PER_S:.3f} of {HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    @staticmethod
    def skipped(label: str, tn: int, to: int, tk: int, k: int, o: int) -> bool:
        """Say so when the kernel has no instantiation for the tile."""
        why = qmm_bench.tile_unsupported(tn, to, tk, k, o)
        if why:
            log(f"{label}: skipped ({why})")
        return why is not None

    def tiled(self, label: str, x, qp, sc, mn, tn: int, to: int, tk: int, nbytes: int) -> None:
        if self.skipped(label, tn, to, tk, 2 * qp.shape[0], qp.shape[1]):
            return
        self.report(label, lambda: qmm_bench.qmm_tiled(x, qp, sc, mn, group=GROUP, tn=tn, to=to,
                                                       tk=tk), nbytes)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run(cases, device: torch.device) -> None:
    b = Bench(device)
    K, O = GATEUP[0], b.width(GATEUP[1])
    x, qp, sc, mn = b.planes(K, O)
    nbytes = _nbytes(qp, sc, mn)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else f"cpu, widths / {CPU_SHRINK}, nothing measured")
    log(f"device: {where}")
    log(f"weight bytes (packed q + f32 sc + f32 mn): {nbytes / 1e6:.1f} MB")

    if "stream" in cases:
        b.report("stream ceiling", lambda: qmm_bench.stream_planes(x, qp, sc, mn, group=GROUP),
                 nbytes)

    if "qmm4" in cases:
        w = QuantTensor(q=qp, scales=sc, mins=mn, group=GROUP, ggml_type=int(GGMLType.Q4_K),
                        transposed=True, packed=True)
        w0 = QuantTensor(q=qp, scales=sc, mins=None, group=GROUP, ggml_type=int(GGMLType.Q4_K),
                         transposed=True, packed=True)
        b.report("qmm4_planes decode", lambda: qmm.qmm(x, w), nbytes)
        b.report("qmm4_planes decode no-mins", lambda: qmm.qmm(x, w0), _nbytes(qp, sc))

    if "qmm8" in cases:
        q8 = torch.from_numpy(b.rng.integers(-127, 127, (K, O), np.int8)).to(device)
        sc8 = torch.from_numpy(b.rng.normal(size=(K // GROUP, O)).astype(np.float32)).to(device)
        w8 = QuantTensor(q=q8, scales=sc8, mins=None, group=GROUP, ggml_type=int(GGMLType.Q8_0),
                         transposed=True)
        b.report("qmm_planes int8 decode", lambda: qmm.qmm(x, w8), _nbytes(q8, sc8))
        del q8, sc8, w8

    if "fp" in cases or "i16" in cases:
        p = qmm_bench.variant_plan(ROWS, K, O)
        log(f"qmm4 fp/i16 plan: {p.col_blocks} column blocks x {p.splits} K splits of "
            f"{p.stages} stages of 64 plane rows x {p.row_blocks} row blocks = {p.blocks} "
            f"blocks, {p.blocks_per_sm} an SM ({p.slots} slots)"
            + (f"; {p.note}" if p.note else ""))
    for unpack in ("fp", "i16"):
        if unpack in cases:
            b.report(f"qmm4 {unpack}-unpack",
                     lambda: qmm_bench.qmm4_variant(x, qp, sc, mn, group=GROUP, unpack=unpack),
                     nbytes)

    if "tiles" in cases:
        for tn, to, tk in REFERENCE_TILES + CARD_TILES:
            b.tiled(f"qmm4 tiles n{tn} o{to} k{tk}", x, qp, sc, mn, tn, to, tk, nbytes)
    del x, qp, sc, mn

    if "shapes" in cases or "4d" in cases:
        shapes = DECODE_SHAPES + ((HEAD,) if "4d" in cases else ())
        for name, k, o_full in shapes:
            o = b.width(o_full)
            x, qp, sc, mn = b.planes(k, o)
            nb = _nbytes(qp, sc, mn)
            if "shapes" in cases and name != HEAD[0]:
                for to, tk in shape_tiles(o):
                    b.tiled(f"{name} K{k} O{o} to{to} tk{tk}", x, qp, sc, mn, ROWS, to, tk, nb)
            if "4d" in cases:
                for to, tk in tiles_4d(o):
                    label = f"4d {name} K{k} O{o} to{to} tk{tk}"
                    if b.skipped(label, ROWS, to, tk, k, o):
                        continue
                    q4, sc4, mn4 = qmm_bench.tile_planes_4d(qp, sc, mn, to, tk)
                    b.report(label, lambda: qmm_bench.qmm_tiled4d(x, q4, sc4, mn4, group=GROUP,
                                                                  to=to, tk=tk), nb)
                    del q4, sc4, mn4
            del x, qp, sc, mn
    log("done")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bench_qmm", description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", metavar="case",
                    help=f"any of {' '.join(CASES)} (default: {' '.join(DEFAULT_CASES)})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu for a rehearsal that measures nothing")
    args = ap.parse_args(argv)
    unknown = [c for c in args.cases if c not in CASES]
    if unknown:
        ap.error(f"unknown case {unknown[0]!r}: choose from {' '.join(CASES)}")
    run(set(args.cases) or set(DEFAULT_CASES), resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
