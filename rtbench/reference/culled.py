"""The tessellated oracle culled by base triangle: RayCaster.cast's answer,
bit for bit, without casting every ray against every micro-triangle.

A scene of a million base triangles has 64 million micro-triangles at
level 3; the oracle's all-pairs cast of a few thousand pixels would take
minutes there. This caster takes the oracle's triangles as they are (a
RayCaster's p0, e1, e2 and normals, in its dtype) and

  - per base triangle, boxes its 4^level micro-triangles (face-major, as
    geometry.tessellate lays them out), padded by 2 MT_UV_EPS times the
    base's longest micro-edge: a hit the edge tolerance accepts lies that
    close to its triangle;
  - per (ray, base), widens the box by the rounding room: how far from
    its triangle the rounded expression can accept a ray, in units of
    the dtype's epsilon times the largest coordinate magnitude of the
    cast (the rays' origins and the scene), ROUND_ULPS plus GRAZE_ULPS
    over a lower bound of det / (|e1| |e2|) over the base's
    micro-triangles, floored at 1 / GRAZE_CAP: a ray almost parallel
    to a triangle, or a sliver, is accepted farther from it. The bound
    is s (|cos| - delta): s the least sine between e1 and e2, cos
    between the ray and the base's mean normal, delta the largest
    distance of a micro-triangle's unit normal from that mean
    (degenerate micro-triangles left out);
  - per block of rays, tests every box by slabs over the t window (also
    widened by the room), giving (ray, base) pairs;
  - per pair, tests the base's micro-triangles by RayCaster._cast's
    Moller-Trumbore expression, operation for operation, so each (ray,
    triangle) value is the oracle's;
  - per ray, keeps the least t, ties to the lowest triangle index, as
    the oracle's torch.min gives it.

Plain PyTorch on any device; imports nothing of the renderer.
"""
from __future__ import annotations

import torch

from .raycast import RayCaster
from .shading import MT_UV_EPS

# A box's rounding room, in units of the cast dtype's epsilon times the
# largest coordinate magnitude of the cast (rays' origins plus the scene):
# ROUND_ULPS + GRAZE_ULPS / max(s (|cos| - delta), 1 / GRAZE_CAP). In
# bfloat16 on displaced planes the oracle accepted rays up to 1.2 units
# from their triangle, grazing ones up to 0.12 / |cos|, and one whose
# bound is under 0 120 units away; the cap's room, 4,100 units, is a
# millimetre in float32 and the whole scene in bfloat16.
ROUND_ULPS = 4.0
GRAZE_ULPS = 1.0
GRAZE_CAP = 4096.0
# Base triangles boxed at a time.
BOX_CHUNK = 1 << 16


class CulledCaster:
    """RayCaster.cast's results from `caster`'s triangles, grouped
    4^level to a base triangle. `slab_elems` and `pair_elems` bound a
    block's (rays x boxes) and (pairs x micro-triangles) temporaries."""

    def __init__(self, caster: RayCaster, level: int,
                 slab_elems: int = 1 << 24, pair_elems: int = 1 << 22):
        self.caster = caster
        self.dtype, self.device = caster.dtype, caster.device
        self.per = 4 ** int(level)
        n_tri = caster.p0.shape[0]
        if n_tri % self.per:
            raise ValueError(f"{n_tri} micro-triangles are not whole base "
                             f"triangles of {self.per}")
        self.n_base = n_tri // self.per
        self.slab_elems, self.pair_elems = slab_elems, pair_elems
        lo, hi, nrm, spread, sine = [], [], [], [], []
        for b0 in range(0, self.n_base, BOX_CHUNK):
            sl = slice(b0 * self.per,
                       min(self.n_base, b0 + BOX_CHUNK) * self.per)
            p0 = caster.p0[sl].float()
            e1, e2 = caster.e1[sl].float(), caster.e2[sl].float()
            corners = torch.stack([p0, p0 + e1, p0 + e2], 1).reshape(
                -1, self.per * 3, 3)
            edge = torch.stack([e1.norm(dim=-1), e2.norm(dim=-1),
                                (e2 - e1).norm(dim=-1)], 1).reshape(
                -1, self.per * 3).amax(1)
            pad = (2.0 * MT_UV_EPS * edge)[:, None]
            lo.append(corners.amin(1) - pad)
            hi.append(corners.amax(1) + pad)
            # The area-weighted mean normal (0 where the base is
            # degenerate), the spread of the unit normals about it and the
            # least sine between e1 and e2, over the non-degenerate ones.
            n = caster.normal[sl].float().reshape(-1, self.per, 3)
            size = n.norm(dim=-1)
            live = size > 0
            mean = n.sum(1)
            mean = mean / mean.norm(dim=-1, keepdim=True).clamp_min(1e-30)
            dist = (n / size.clamp_min(1e-30)[..., None]
                    - mean[:, None]).norm(dim=-1)
            sin = size / (e1.norm(dim=-1) * e2.norm(dim=-1)).reshape(
                size.shape).clamp_min(1e-30)
            nrm.append(mean)
            spread.append(torch.where(live, dist, 0.0).amax(1))
            sine.append(torch.where(live, sin, 1.0).amin(1))
        self.lo, self.hi = torch.cat(lo), torch.cat(hi)
        self.normal = torch.cat(nrm)
        self.spread, self.sine = torch.cat(spread), torch.cat(sine)
        self.extent = float(torch.maximum(self.lo.abs(), self.hi.abs())
                            .max())
        self.offsets = torch.arange(self.per, device=self.device)

    def cast(self, o: torch.Tensor, d: torch.Tensor, t_min: float,
             t_max: float):
        """(t (n,), hit (n,), normal (n, 3) unnormalised) of rays (o, d),
        as RayCaster.cast gives them."""
        o = o.to(self.device, self.dtype)
        d = d.to(self.device, self.dtype)
        n = o.shape[0]
        rays, ts, tris = [], [], []
        if n:
            unit = torch.finfo(self.dtype).eps * (
                float(o.float().abs().max()) + self.extent)
            block = max(1, self.slab_elems // self.n_base)
            for r0 in range(0, n, block):
                r, b = self._pairs(o[r0:r0 + block].float(),
                                   d[r0:r0 + block].float(), unit, t_min,
                                   t_max)
                r = r + r0
                step = max(1, self.pair_elems // self.per)
                for p0 in range(0, r.shape[0], step):
                    rr, t, tri = self._test(o, d, r[p0:p0 + step],
                                            b[p0:p0 + step], t_min, t_max)
                    rays.append(rr)
                    ts.append(t)
                    tris.append(tri)
        best_t = torch.full((n,), float("inf"), dtype=torch.float32,
                            device=self.device)
        best_tri = torch.zeros(n, dtype=torch.int64, device=self.device)
        if rays:
            ray, t, tri = torch.cat(rays), torch.cat(ts), torch.cat(tris)
            best_t = best_t.scatter_reduce(0, ray, t, "amin")
            at = t == best_t[ray]
            best_tri = torch.full((n,), self.n_base * self.per,
                                  dtype=torch.int64, device=self.device
                                  ).scatter_reduce(0, ray[at], tri[at],
                                                   "amin")
        t = best_t.to(self.dtype)
        hit = torch.isfinite(t)
        best_tri = torch.where(hit, best_tri, 0)
        normal = torch.where(hit[:, None], self.caster.normal[best_tri],
                             torch.zeros((), dtype=self.dtype,
                                         device=self.device))
        return t, hit, normal

    def _pairs(self, o, d, unit, t_min, t_max):
        """(ray, base) index pairs of the rays (o, d) (float32) whose
        segment [t_min, t_max] meets the base's box, both widened by the
        pair's rounding room (`unit` its unit)."""
        cos = (d[:, None, :] * self.normal[None]).sum(-1).abs()
        graze = (self.sine * (cos - self.spread)).clamp_min(1.0 / GRAZE_CAP)
        room = (unit * (ROUND_ULPS + GRAZE_ULPS / graze))[..., None]
        tiny = 1e-30
        ds = torch.where(d.abs() < tiny, torch.where(d >= 0, tiny, -tiny),
                         d)[:, None]
        t0 = (self.lo[None] - room - o[:, None]) / ds
        t1 = (self.hi[None] + room - o[:, None]) / ds
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        room = room[..., 0]
        meet = ((near <= far) & (far >= t_min - room)
                & (near <= t_max + room))
        return meet.nonzero(as_tuple=True)

    def _test(self, o, d, ray, base, t_min, t_max):
        """(ray, t float32, triangle) of each pair's nearest accepted
        micro-triangle (ties to the lower index), the pairs with none
        left out. RayCaster._cast's expression, operation for operation,
        on the pair's (ray, micro-triangle) values."""
        c = self.caster
        tri = base[:, None] * self.per + self.offsets[None]
        ox, oy, oz = (o[ray, k:k + 1] for k in range(3))
        dx, dy, dz = (d[ray, k:k + 1] for k in range(3))
        e1, e2, p0 = c.e1[tri], c.e2[tri], c.p0[tri]
        e1x, e1y, e1z = (e1[..., k] for k in range(3))
        e2x, e2y, e2z = (e2[..., k] for k in range(3))
        px_, py_, pz_ = (p0[..., k] for k in range(3))
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
        best, k = t.min(dim=1)
        keep = torch.isfinite(best)
        return (ray[keep], best[keep].float(),
                tri.gather(1, k[:, None])[:, 0][keep])
