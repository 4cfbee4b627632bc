"""The yardstick's arithmetic: published peaks, the least time of a
trace-kernel launch from its own counters, and the device time of short
launches queued behind a spin.

Operation counts are those the kernels' work needs, counted over the
non-zero terms of their tables (csrc/tile_trace.cu, csrc/group_trace.cu);
bytes are each input read once and
each output written once. A count that follows a kernel's own counters
(K1's unit visits, K2's tested lanes) follows its walk: a walk that
visits fewer units moves the bound with it.
"""
from __future__ import annotations

import statistics
import subprocess

import torch

# Published NVIDIA H100 SXM peaks (data sheet, dense, at the 700 W limit):
# float32 outside the tensor cores and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# K1 (tile trace), per (ray, leaf) test: det a 3-term dot (5), u, v and
# the w column 6-term dots (11 each), one division, four quotient
# products, four window compares, a select and the running-minimum
# compare; per (ray, unit) visit the recentred moment (9) and the fold
# (4). Rays per tile 1,024, leaves per unit 64.
OPS_PER_RAY_LEAF = 5 + 3 * 11 + 1 + 4 + 4 + 1 + 1
OPS_PER_RAY_VISIT = 64 * OPS_PER_RAY_LEAF + 9 + 4
TILE_RAYS = 32 * 32
# Per leaf of a compressed unit visit (the derive): edges 6, recentred v0
# 3, three cross products 27, e2.w2 5, t_num 6, the w column 9, the
# normal's norm 7 and its three divisions 3.
DERIVE_OPS_PER_LEAF = 6 + 3 + 27 + 5 + 6 + 9 + 7 + 3
# K2 (grouped trace), per (tested lane, leaf): det 5, u, v and w 11 each,
# t 6, one division, four quotients, four window compares, a select and
# the running-minimum compare; per leaf of a compressed visit the derive.
K2_OPS_PER_RAY_LEAF = 5 + 11 + 11 + 6 + 11 + 1 + 4 + 4 + 1 + 1
K2_DERIVE_OPS_PER_LEAF = 6 + 27 + 5 + 9 + 7 + 3
# GPU clock cycles of the spin the queued launches wait behind (~10 ms).
SPIN_CYCLES = 20_000_000


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _bound(ops: float, moved: int) -> tuple[float, str]:
    ops_ms = ops / PEAK_FP32 * 1e3
    bytes_ms = moved / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def k1_bound(visits: int, moved: int, derive: bool = False
             ) -> tuple[float, str]:
    """(least ms, what bounds it) of a K1 launch of `visits` unit visits
    moving `moved` bytes."""
    ops = visits * TILE_RAYS * OPS_PER_RAY_VISIT
    if derive:
        ops += visits * 64 * DERIVE_OPS_PER_LEAF
    return _bound(ops, moved)


def k2_bound(tests: int, visits: int, moved: int, derive: bool = False
             ) -> tuple[float, str]:
    """(least ms, what bounds it) of a K2 launch of `tests` tested
    (lane, unit) pairs and `visits` unit visits."""
    ops = tests * 64 * K2_OPS_PER_RAY_LEAF
    if derive:
        ops += visits * 64 * K2_DERIVE_OPS_PER_LEAF
    return _bound(ops, moved)


def queued_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device ms per call of fn: each round queues `reps` calls behind a
    spin of SPIN_CYCLES, so the card runs them back to back, timed by
    CUDA events; the median of the rounds. Raises if the card reached
    the timed calls before the host had queued them."""
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        if start.query():
            raise RuntimeError("the card reached the timed calls before "
                               "the host had queued them")
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (out.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]
