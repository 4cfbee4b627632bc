"""The pixels the check reads: per frame of the window a few pixels from a
pool drawn from the seed, gathered where the frame is produced; after the
window a sample of them, drawn from the seed, goes to the reference."""
from __future__ import annotations

import numpy as np

from . import harness

POOLS = 16


def pixel_pools(seed: int, width: int, height: int, frames: int,
                per_frame: int) -> np.ndarray:
    """(POOLS, frames, per_frame) int64 flat pixel indices y * width + x."""
    return harness.rng(seed, 2).integers(
        0, width * height, size=(POOLS, frames, per_frame), dtype=np.int64)


class Samples:
    """Gathered pixels: per frame its (4, 4) matrix, the flat indices and
    the (per_frame, 3) u8 values the renderer gave them."""

    def __init__(self):
        self.ivps: list[np.ndarray] = []
        self.pixels: list[np.ndarray] = []
        self.values: list = []     # u8 arrays, or device tensors until read

    def add(self, ivps: np.ndarray, pixels: np.ndarray, values) -> None:
        """ivps (F, 4, 4), pixels (F, per), values (F, per, 3)."""
        self.ivps.append(np.asarray(ivps, np.float32).reshape(-1, 4, 4))
        self.pixels.append(np.asarray(pixels).reshape(len(self.ivps[-1]), -1))
        self.values.append(values)

    def draw(self, seed: int, count: int, width: int) -> dict:
        """`count` of the gathered pixels (all, if fewer), drawn from the
        seed: {"ivps" (n, 4, 4), "px", "py" (n,) int64, "values" (n, 3)
        u8}."""
        ivps = np.concatenate([np.repeat(m, p.shape[1], axis=0)
                               for m, p in zip(self.ivps, self.pixels)])
        pix = np.concatenate([p.reshape(-1) for p in self.pixels])
        vals = np.concatenate([
            (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
            .reshape(-1, 3) for v in self.values])
        n = pix.shape[0]
        pick = (np.arange(n) if n <= count else np.sort(
            harness.rng(seed, 4).choice(n, size=count, replace=False)))
        return {"ivps": ivps[pick], "px": pix[pick] % width,
                "py": pix[pick] // width, "values": vals[pick]}
