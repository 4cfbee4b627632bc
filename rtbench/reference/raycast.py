"""The tessellated ray-cast oracle: every ray against every micro-triangle.

Möller-Trumbore with the renderer's edge tolerance (a hit where
min(u, v, 1 - u - v) >= -MT_UV_EPS, intersection.hlsl:413) and its t
window [t_min, t_max]; the nearest accepted triangle wins. Plain PyTorch
on any device, in blocks of rays so that a block's (rays x triangles)
temporaries stay near `block_elems` values. `dtype` is the precision the
whole cast runs in (float32; bfloat16 for the control).
"""
from __future__ import annotations

import torch

from .shading import MT_UV_EPS


class RayCaster:
    def __init__(self, vertices, triangles, device, dtype=torch.float32,
                 block_elems: int = 1 << 22):
        v = torch.as_tensor(vertices, dtype=torch.float32).to(device)
        tri = torch.as_tensor(triangles, dtype=torch.int64).to(device)
        v = v.to(dtype)
        self.dtype = dtype
        self.device = torch.device(device)
        p0, p1, p2 = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
        self.p0 = p0
        self.e1 = p1 - p0
        self.e2 = p2 - p0
        self.normal = torch.linalg.cross(self.e1, self.e2)
        self.block = max(1, block_elems // max(tri.shape[0], 1))

    def cast(self, o: torch.Tensor, d: torch.Tensor, t_min: float,
             t_max: float):
        """(t (n,), hit (n,), normal (n, 3) unnormalised) of rays (o, d);
        t = +inf and the normal 0 where nothing is hit."""
        o = o.to(self.device, self.dtype)
        d = d.to(self.device, self.dtype)
        outs = [self._cast(o[i:i + self.block], d[i:i + self.block], t_min,
                           t_max)
                for i in range(0, o.shape[0], self.block)]
        if not outs:
            z = torch.zeros(0, dtype=self.dtype, device=self.device)
            return z, z.bool(), z.reshape(0, 3)
        t, tri = (torch.cat(x) for x in zip(*outs))
        hit = torch.isfinite(t)
        normal = torch.where(hit[:, None], self.normal[tri],
                             torch.zeros((), dtype=self.dtype,
                                         device=self.device))
        return t, hit, normal

    def _cast(self, o, d, t_min, t_max):
        ox, oy, oz = (o[:, k:k + 1] for k in range(3))
        dx, dy, dz = (d[:, k:k + 1] for k in range(3))
        e1x, e1y, e1z = (self.e1[None, :, k] for k in range(3))
        e2x, e2y, e2z = (self.e2[None, :, k] for k in range(3))
        px_, py_, pz_ = (self.p0[None, :, k] for k in range(3))
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        tx, ty, tz = ox - px_, oy - py_, oz - pz_
        u = (tx * pvx + ty * pvy + tz * pvz) / det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) / det
        t = (e2x * qx + e2y * qy + e2z * qz) / det
        w = 1.0 - u - v
        ok = ((torch.minimum(torch.minimum(u, v), w) >= -MT_UV_EPS)
              & (t >= t_min) & (t <= t_max))
        t = torch.where(ok, t, torch.full((), float("inf"), dtype=t.dtype,
                                          device=t.device))
        best, idx = t.min(dim=1)
        return best, idx
