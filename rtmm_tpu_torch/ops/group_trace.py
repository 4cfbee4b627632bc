"""Grouped trace: the port of the JAX package's grouped Pallas kernel
(rtmm_tpu/ops/pallas_grouped.py::_launch, body _trace_group_nonempty),
the path tracer's secondary-ray engine (`pallas`).

Rays come in sorted groups of GROUP = 1024 (8 sub-groups of 128
consecutive rays, each with its own origin box and reach box). Per group
the kernel walks a front-to-back list of clusters; per cluster it culls
the 64 units against every sub-group's reach box, and picks units by
their nearest sub-group distance among those still able to beat that
sub-group's worst hit. A picked unit runs the generalized Möller-Trumbore
(ray rows [d, o x d, o, 1] against the unit's absolute table unit_q16, or
one derived from its compressed record) only on the sub-groups its gate
lets through, keeping each ray's closest hit. The walk stops when no
cluster left can beat the group's worst bound; a host loop repeats
windows of clusters until every group is done.

  trace_sorted       the engine entry (pallas_grouped.trace_sorted): ray
                     rows, per-sub boxes, the window loop.
  trace_group        the kernel wrapper: csrc/group_trace.cu on CUDA
                     tensors, trace_group_plain on CPU tensors.
  trace_group_plain  the same walk in plain PyTorch, step for step (a
                     Python loop over groups, clusters and picks; each MT
                     vectorised over 64 leaves x the gated rays, summing
                     only the table's non-zero terms, TERM_ROWS, as the
                     kernel does).
  LAUNCHES           kernel launches so far, precomputed and compressed
                     (a view of the counters in utils/spans.py).

Semantics kept from the TPU kernel: the lagged pick order of its two-deep
unit pipeline (u0 and u1 picked with the cluster's entry bounds; each
step picks the next unit with the current bounds before it processes the
current one, whose gate bits are evaluated then, and refreshes the bounds
after it), the sub-group gate insides[j] & dist[j] <= ws[j], the miss
rays' scene-exit bound in the per-sub worst (dead lanes start at t = 0),
the w column (det - u) - v built on the table, the unguarded reciprocal,
acceptance min(u, v, w) >= -MT_UV_EPS and t >= t_min, the t_max window on
the leaf minimum, the tie-summed winner normal and the strict-< take.
A lane whose running best is at or below t_min can never take a hit, so
the kernel tests only the gated lanes above it; `tests` counts those
(lane, unit) pairs, and the plain version counts them the same way while
it tests every gated lane.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import RenderConfig
from ..models.scene import DeviceScene
from ..utils import spans
from . import _f32, culling, tiled
from .tile_trace import _check
from . import compressed as comp
from .intersect import MT_UV_EPS

BIG = 1e30
GROUP = 1024
SUB = 128
NS = GROUP // SUB
LPU = 64
UPC = culling.UNITS_PER_CLUSTER
BOX = NS * 16 + 16
TINY = 1e-12

KERNELS = ("group_trace", "group_trace_compressed")
LAUNCHES = spans.LaunchView(KERNELS)


def reset_launches() -> None:
    LAUNCHES.reset()


def scene_tables(scene: DeviceScene):
    """(meta, tables, normals, options) of trace_group for a scene: the
    per-cluster unit metadata, then unit_q16 and unit_nrm_pad, or the
    compressed records (normals None) with their corner lanes (None when
    each indexed record carries its own)."""
    if not scene.compressed:
        return (scene.cluster_unit_meta, scene.unit_q16, scene.unit_nrm_pad,
                {})
    return (scene.cluster_unit_meta, scene.unit_grid, None,
            {"compressed": True, "corners": tiled.corner_lanes(scene)})


# ----------------------------------------------------------------------
# Plain PyTorch version.

def _safe(dk: torch.Tensor) -> torch.Tensor:
    """Direction component kept off zero by +-1e-12 (the slab divisor)."""
    return torch.where(torch.abs(dk) < TINY,
                       torch.where(dk >= 0.0, TINY, -TINY), dk)


# The ray rows [d, o x d, o, 1] (rows 0-9 of rv) that each column block
# of the unit table, det|u|v|t|w, has non-zero terms on: the kernel stages
# and sums only these.
TERM_ROWS = ((0, 3), (0, 6), (0, 6), (6, 10), (0, 6))


def _contract(qb: torch.Tensor, rv: torch.Tensor) -> torch.Tensor:
    """(k, LPU) table rows x (k, n) ray rows -> (LPU, n), summed over the
    rows left to right, as the kernel sums them."""
    acc = qb[0][:, None] * rv[0][None, :]
    for r in range(1, qb.shape[0]):
        acc = acc + qb[r][:, None] * rv[r][None, :]
    return acc


def _unit_tables(tables, nrm_tab, unit: int, compressed_: bool, corners):
    """(the det|u|v|t|w blocks of one unit, each (rows, LPU) over its
    TERM_ROWS, nrm (3, LPU)), read from unit_q16 / unit_nrm_pad or
    derived from its record; the w column is (det - u) - v."""
    if compressed_:
        q16, nrm = comp.derive_q16(tables[unit:unit + 1], corners)
        q16, nrm = q16[0], nrm[0].T
    else:
        q16, nrm = tables[unit], nrm_tab[unit, 0:3, 0:LPU]
    q = q16[0:10]
    det, u, v, t = (q[:, i * LPU:(i + 1) * LPU] for i in range(4))
    blocks = (det, u, v, t, (det - u) - v)
    return [b[lo:hi] for b, (lo, hi) in zip(blocks, TERM_ROWS)], nrm


def _group_plain(rv, box, ccand_row, centry_row, cnt, meta, tables, nrm_tab,
                 cfg, bt, bn, compressed_, corners):
    """One group's walk. rv (16, GROUP) ray rows; box (BOX,) the per-sub
    boxes and the scene-exit tail; bt (GROUP,), bn (3, GROUP) the running
    best it starts from. Returns (bt, bn, visits, gated sub-groups,
    tests: the gated lanes above t_min summed over the visits)."""
    dev = rv.device
    tail = NS * 16
    e_row = None
    for k in range(3):
        dk = _safe(rv[k])
        ek = torch.maximum(torch.div(box[tail + k] - rv[6 + k], dk),
                           torch.div(box[tail + 3 + k] - rv[6 + k], dk))
        e_row = ek if e_row is None else torch.minimum(e_row, ek)

    def worst(bt):
        v = torch.where(bt < BIG, bt, e_row).reshape(NS, SUB)
        return torch.clamp_min(v.amax(dim=1), 0.0)            # (NS,)

    bxs = box[:tail].reshape(NS, 16)
    lane = torch.arange(UPC, device=dev)
    inf = float("inf")
    ws = worst(bt)
    nv = nsub = ntests = 0
    kc = centry_row.shape[0]
    ci = 0
    while ci < cnt and float(ws.max()) >= float(centry_row[min(ci, kc - 1)]):
        cl = int(ccand_row[ci])
        mt = meta[cl, :, 0:UPC]                               # (8, UPC)
        mn, mx = mt[0:3], mt[3:6]
        inside = mt[6][None] > 0.0                            # (NS, UPC)
        for a in range(3):
            inside = (inside & (mn[a][None] <= bxs[:, 9 + a:10 + a])
                      & (mx[a][None] >= bxs[:, 6 + a:7 + a]))
        dd = [torch.clamp_min(torch.maximum(mn[a][None] - bxs[:, 3 + a:4 + a],
                                            bxs[:, a:a + 1] - mx[a][None]),
                              0.0) for a in range(3)]
        dist = torch.sqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2])
        removed = torch.zeros(UPC, dtype=torch.bool, device=dev)

        def first(ws):
            """Nearest eligible, unremoved unit lane (lowest lane on a
            tie); 128 when none. Marks it removed."""
            key = torch.where(inside & (dist <= ws[:, None]), dist,
                              inf).amin(dim=0)
            key = torch.where(removed, inf, key)
            kmin = key.amin()
            u = int(torch.where((key <= kmin) & (key < inf), lane,
                                128).amin())
            if u < 128:
                removed[u] = True
            return u

        u, n1 = first(ws), first(ws)
        while u < 128:
            n2 = first(ws)
            bits = (inside[:, u] & (dist[:, u] <= ws)).tolist()
            if any(bits):
                nv += 1
                nsub += sum(bits)
                q, nrm = _unit_tables(tables, nrm_tab, cl * UPC + u,
                                      compressed_, corners)
                lanes = torch.cat([torch.arange(j * SUB, (j + 1) * SUB,
                                                device=dev)
                                   for j in range(NS) if bits[j]])
                r = rv[0:10, lanes]
                cur = bt[lanes]
                # Only lanes above t_min can take a hit; the kernel tests
                # those alone, this version tests every gated lane.
                ntests += int((cur > cfg.t_min).sum())

                def blk(i):
                    lo, hi = TERM_ROWS[i]
                    return _contract(q[i], r[lo:hi])

                iv = _f32.rdiv(1.0, blk(0))
                uu, vv, tt, ww = blk(1) * iv, blk(2) * iv, blk(3) * iv, \
                    blk(4) * iv
                ok = ((torch.minimum(torch.minimum(uu, vv), ww)
                       >= -MT_UV_EPS) & (tt >= cfg.t_min))
                tt = torch.where(ok, tt, BIG)
                tb = tt.amin(dim=0)
                tb = torch.where(tb <= cfg.t_max, tb, BIG)
                win = tt <= tb[None, :]
                nsel = torch.stack([torch.where(win, nrm[c][:, None], 0.0)
                                    .sum(dim=0) for c in range(3)])
                take = tb < cur
                bt[lanes] = torch.where(take, tb, cur)
                bn[:, lanes] = torch.where(take[None], nsel, bn[:, lanes])
            ws = worst(bt)
            u, n1 = n1, n2
        ci += 1
    return bt, bn, nv, nsub, ntests


def trace_group_plain(rv, box, ccand, ccount, centry, t_in, n_in, meta,
                      tables, nrm_tab, cfg: RenderConfig, *,
                      compressed=False, corners=None, groups=None):
    """Plain-PyTorch version of the grouped trace kernel (same inputs and
    outputs as trace_group). groups: walk only these groups (the others
    pass their carries through with zero counts, as empty groups do)."""
    t_out, n_out = t_in.clone(), n_in.clone()
    n_groups = rv.shape[0]
    visits = torch.zeros(n_groups, dtype=torch.int32)
    gated = torch.zeros(n_groups, dtype=torch.int32)
    tests = torch.zeros(n_groups, dtype=torch.int32)
    counts = ccount.cpu()
    ccand_h, centry_h = ccand.cpu(), centry.cpu()
    kc = ccand.shape[1]
    for g in range(n_groups) if groups is None else groups:
        cnt = min(int(counts[g]), kc)
        if cnt <= 0:
            continue
        bt, bn, nv, ns, nt = _group_plain(
            rv[g], box[g], ccand_h[g], centry_h[g], cnt, meta, tables,
            nrm_tab, cfg, t_out[g].clone(), n_out[g].clone(), compressed,
            corners)
        t_out[g], n_out[g] = bt, bn
        visits[g], gated[g], tests[g] = nv, ns, nt
    dev = rv.device
    return t_out, n_out, visits.to(dev), gated.to(dev), tests.to(dev)


# ----------------------------------------------------------------------
# Kernel wrapper.

def _lib():
    from . import _build
    lib = _build.load("group_trace")
    fn = lib.rtmm_group_trace
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([vp] * 9 + [ci]          # rays .. carries, meta, q16, npad
                   + [vp] * 2 + [ci] + [vp]  # normals, grid, rows, corners
                   + [vp] * 5               # t, n, visits, gated, tests
                   + [ci] * 3 + [cf] * 2 + [vp])
    fn.restype = ci
    err = lib.rtmm_cuda_error_string
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return fn, err


def trace_group(rv, box, ccand, ccount, centry, t_in, n_in, meta, tables,
                nrm_tab, cfg: RenderConfig, *, compressed=False,
                corners=None):
    """One cluster window of every group.

    rv (g, 16, GROUP) f32 ray rows [d, o x d, o, 1, 0 x 6]; box (g, BOX)
    f32 per-sub [omin, omax, reach_min, reach_max, pad 4] x 8, then the
    inflated scene box (6) and pad; ccand (g, kc) int32, ccount (g,)
    int32, centry (g, kc) f32: front-to-back cluster lists; t_in (g,
    GROUP) f32 running best t (BIG = miss, 0 = dead lane), n_in (g, 3,
    GROUP) f32 summed winner normals; meta (C, 8, 128) f32. tables:
    unit_q16 (U, 16, 4*LPU) f32 with nrm_tab unit_nrm_pad (U, 8, npad)
    f32, or with compressed=True the records unit_grid (U, rows, 128) f32
    (nrm_tab None) and corners the (3, LPU) int32 shared corner lanes
    (None: each record's index rows 3-5).

    Returns (t_out, n_out, visits (g,) int32 — the units whose gate let
    MT run, gated (g,) int32 — the 128-ray sub-groups those units ran
    on, tests (g,) int32 — the lanes of those sub-groups whose running
    best exceeded t_min, summed over the units: the (lane, unit) pairs
    the kernel tests). Groups with ccount 0 pass their carries through.
    On CUDA tensors
    the CUDA kernel runs (csrc/group_trace.cu); on CPU tensors the plain
    version; any other device raises.
    """
    with spans.span("rtmm.group_trace.trace_group"):
        dev = rv.device
        n_groups, kc = ccand.shape
        n_cl = meta.shape[0]
        for name, x in (("box", box), ("ccand", ccand), ("ccount", ccount),
                        ("centry", centry), ("t_in", t_in), ("n_in", n_in),
                        ("meta", meta), ("tables", tables), ("nrm", nrm_tab),
                        ("corners", corners)):
            if x is not None and x.device != dev:
                raise ValueError(f"{name} is on {x.device}, rv on {dev}")
        _check("rv", rv, torch.float32, (n_groups, 16, GROUP))
        _check("box", box, torch.float32, (n_groups, BOX))
        _check("ccand", ccand, torch.int32, (n_groups, kc))
        _check("ccount", ccount, torch.int32, (n_groups,))
        _check("centry", centry, torch.float32, (n_groups, kc))
        _check("t_in", t_in, torch.float32, (n_groups, GROUP))
        _check("n_in", n_in, torch.float32, (n_groups, 3, GROUP))
        _check("meta", meta, torch.float32, (n_cl, 8, 128))
        n_units = n_cl * UPC
        grows = 0
        if compressed:
            grows = tables.shape[1] if tables.dim() == 3 else -1
            if grows not in (comp.GRID_ROWS, comp.IDX_ROWS) or (
                    corners is None and grows != comp.IDX_ROWS):
                raise ValueError(f"unit_grid has {grows} rows (records "
                                 "without index rows need shared corners)")
            _check("unit_grid", tables, torch.float32,
                   (n_units, grows, comp.GRID_LANES))
            if corners is not None:
                _check("corners", corners, torch.int32, (3, LPU))
            if nrm_tab is not None:
                raise ValueError("compressed scenes derive their normals")
        else:
            _check("unit_q16", tables, torch.float32, (n_units, 16, 4 * LPU))
            if nrm_tab is None or nrm_tab.dim() != 3 or nrm_tab.shape[2] < LPU:
                raise ValueError("unit_nrm_pad (U, 8, >= 64) is required")
            _check("unit_nrm_pad", nrm_tab, torch.float32,
                   (n_units, 8, nrm_tab.shape[2]))
        if dev.type == "cpu":
            return trace_group_plain(rv, box, ccand, ccount, centry, t_in,
                                     n_in, meta, tables, nrm_tab, cfg,
                                     compressed=compressed, corners=corners)
        if dev.type != "cuda":
            raise ValueError(f"trace_group runs on cuda or cpu, not {dev}")
        fn, err = _lib()
        t_out = torch.empty_like(t_in)
        n_out = torch.empty_like(n_in)
        visits = torch.empty(n_groups, dtype=torch.int32, device=dev)
        gated = torch.empty(n_groups, dtype=torch.int32, device=dev)
        tests = torch.empty(n_groups, dtype=torch.int32, device=dev)
        ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(rv.data_ptr(), box.data_ptr(), ccand.data_ptr(),
                    ccount.data_ptr(), centry.data_ptr(), t_in.data_ptr(),
                    n_in.data_ptr(), meta.data_ptr(),
                    None if compressed else tables.data_ptr(),
                    0 if compressed else nrm_tab.shape[2], ptr(nrm_tab),
                    tables.data_ptr() if compressed else None, grows,
                    ptr(corners), t_out.data_ptr(), n_out.data_ptr(),
                    visits.data_ptr(), gated.data_ptr(), tests.data_ptr(),
                    n_groups, kc, n_cl,
                    cfg.t_min, cfg.t_max, stream)
        if rc != 0:
            raise RuntimeError("group_trace kernel launch failed: "
                               + err(rc).decode())
        spans.launch("group_trace_compressed" if compressed
                     else "group_trace")
        return t_out, n_out, visits, gated, tests


# ----------------------------------------------------------------------
# The engine entry: per-group boxes, ray rows and the window loop.

def _grouped_cluster_window(scene: DeviceScene, omin, omax, remaining,
                            kc: int):
    """Per-group cluster window: the kc nearest remaining clusters by
    origin-box gap (reach overlap already folded into `remaining`), ties
    to the lower cluster index. Returns (ccand (g, kc) int32, ccount (g,)
    int32, centry (g, kc) f32 ascending with +inf tail, new_remaining,
    next_bound (g,))."""
    with spans.span("rtmm.group_trace._grouped_cluster_window"):
        gap = torch.clamp_min(torch.maximum(
            scene.cluster_aabb_min[None] - omax[:, None, :],
            omin[:, None, :] - scene.cluster_aabb_max[None]), 0.0)
        dist = culling._norm(gap)                                 # (g, C)
        key, cidx = torch.sort(torch.where(remaining, dist, float("inf")),
                               dim=1, stable=True)
        key, cidx = key[:, :kc], cidx[:, :kc]
        sel = key < float("inf")
        taken = torch.zeros_like(remaining)
        taken.scatter_(1, cidx, sel)
        new_remaining = remaining & ~taken
        next_bound = torch.where(new_remaining, dist, float("inf")).amin(dim=1)
        return (cidx.to(torch.int32).contiguous(),
                sel.sum(dim=1).to(torch.int32), key.contiguous(),
                new_remaining, next_bound)


def group_inputs(scene: DeviceScene, o: torch.Tensor, d: torch.Tensor,
                 live: torch.Tensor, cfg: RenderConfig):
    """The launch inputs every window shares: (rv (g, 16, GROUP), box (g,
    BOX), exit_t (g, GROUP) per-ray reach through the inflated scene box,
    clipped to [0, t_max], whole-group origin boxes omin / omax (g, 3),
    cl_hit (g, C) reach-box x cluster overlap of groups with live rays)."""
    with spans.span("rtmm.group_trace.group_inputs"):
        g = o.shape[0]
        dev = o.device
        aabb6 = tiled.scene_exit_aabb(scene)                      # (6,)
        dsafe = _safe(d)
        ex0 = torch.div(aabb6[0:3] - o, dsafe)
        ex1 = torch.div(aabb6[3:6] - o, dsafe)
        exit_t = torch.clamp(torch.maximum(ex0, ex1).amin(dim=-1), 0.0,
                             cfg.t_max)
        end = o + exit_t[..., None] * d                       # (g, GROUP, 3)

        os_ = o.reshape(g, NS, SUB, 3)
        es = end.reshape(g, NS, SUB, 3)
        ls = live.reshape(g, NS, SUB, 1)
        omin_s = torch.where(ls, os_, BIG).amin(dim=2)            # (g, NS, 3)
        omax_s = torch.where(ls, os_, -BIG).amax(dim=2)
        reach_min_s = torch.minimum(omin_s,
                                    torch.where(ls, es, BIG).amin(dim=2))
        reach_max_s = torch.maximum(omax_s,
                                    torch.where(ls, es, -BIG).amax(dim=2))
        omin, omax = omin_s.amin(dim=1), omax_s.amax(dim=1)
        reach_min, reach_max = reach_min_s.amin(dim=1), reach_max_s.amax(dim=1)
        cl_hit = ((reach_min[:, None, :] <= scene.cluster_aabb_max[None])
                  & (reach_max[:, None, :] >= scene.cluster_aabb_min[None])
                  ).all(dim=-1)
        cl_hit &= scene.cluster_valid[None] & live.any(dim=1)[:, None]

        m = culling._cross(o, d)
        rv = torch.cat([d, m, o, torch.ones((g, GROUP, 1), device=dev),
                        torch.zeros((g, GROUP, 6), device=dev)], dim=-1)
        rv = rv.transpose(1, 2).contiguous()                  # (g, 16, GROUP)
        box = torch.cat([omin_s, omax_s, reach_min_s, reach_max_s,
                         torch.zeros((g, NS, 4), device=dev)],
                        dim=2).reshape(g, NS * 16)
        box = torch.cat([box, aabb6.expand(g, 6),
                         torch.zeros((g, 10), device=dev)], dim=1).contiguous()
        return rv, box, exit_t, omin, omax, cl_hit


def trace_sorted(scene: DeviceScene, o: torch.Tensor, d: torch.Tensor,
                 live: torch.Tensor, cfg: RenderConfig):
    """Trace pre-grouped rays through the cluster walk, window by window.

    o/d: (g, GROUP, 3) f32; live: (g, GROUP) bool. The caller owns the
    grouping (grouped._sort_key). Returns (best_t (g, GROUP) with BIG =
    miss, best_n (g, GROUP, 3) unnormalised, extra window passes: the
    windows beyond the first that groups consumed, an int). One
    trace_group launch per window; the loop runs on the host, one sync
    per window.
    """
    g = o.shape[0]
    rv, box, exit_t, omin, omax, cl_hit = group_inputs(scene, o, d, live,
                                                       cfg)
    meta, tables, nrm_tab, opts = scene_tables(scene)
    kc = max(1, min(cfg.kernel_clusters_per_window, scene.num_clusters))
    # Dead lanes start "hit at 0": they never hold a bound open.
    best_t = torch.where(live, BIG, 0.0).to(torch.float32)
    best_n = torch.zeros((g, 3, GROUP), dtype=torch.float32, device=o.device)
    active = cl_hit.any(dim=1)
    remaining = cl_hit & active[:, None]
    extra = 0
    while spans.sync("group_trace.window_any", active.any(), bool):
        ccand, ccount, centry, remaining, bound = _grouped_cluster_window(
            scene, omin, omax, remaining, kc)
        best_t, best_n, *_ = trace_group(
            rv, box, ccand, ccount, centry, best_t, best_n, meta, tables,
            nrm_tab, cfg, **opts)
        # Miss rays contribute their scene-exit reach (dead lanes carry
        # best_t = 0), so beyond-reach windows are skipped.
        worst = torch.where(best_t < BIG, best_t, exit_t).amax(dim=1)
        active = remaining.any(dim=1) & (worst >= bound)
        remaining = remaining & active[:, None]
        extra += spans.sync("group_trace.window_extra", active.sum())
    return best_t, best_n.transpose(1, 2), extra
