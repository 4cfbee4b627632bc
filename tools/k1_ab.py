"""Compare the tree's tile trace kernel K1 (csrc/tile_trace.cu) with other
versions of the same source on launches of the bench configurations, on
one NVIDIA card.

    python3 tools/k1_ab.py [VARIANT.cu ...]

A variant is a copy of tile_trace.cu with the same C entries
`rtmm_tile_trace_fused` / `_windowed` / `_raw` (an older version: `git
show <commit>:rtmm_tpu_torch/csrc/tile_trace.cu > build/ab/old.cu`; the
copy the card's machine gets has no .git). Every source is built with the
port's nvcc flags (one nvcc each, started together) and its ptxas
register and spill lines are printed. The launches, with chip_smoke.py's
scenes, cameras and settings at 1920x1080:
  config 8 raw        the merged two-level launch of 64 instances (K1d);
  config 7 cut        every window launch of the 160x160 compressed plane
                      in windows of 16 clusters (K1b + K1c), replayed;
  config 3 fused      one frame with in-kernel raygen (K1a);
  config 9 fused      one compressed frame (K1c);
  config 9 raw        the same frame through the raw mode with its ray
                      matrix, in tile order and with the rows reordered by
                      their visits, most first (how much the launch's
                      tail costs).
Each launch's line gives its visits per non-empty row (mean, max, 99th
percentile): a launch that ends on a few long rows is bound by one tile's
walk, not by the card's throughput.
The tree's kernel is held against the plain version on a subset of rows
(chip_smoke.py's _check_rows: visits and eligible equal per row, t bit for
bit, normals and pixels within 1e-5), and each variant against the tree's
kernel on every row (visits and eligible equal per row, t bit for bit;
normals and pixels within 1e-5, printed where they are not bit-equal).
Then all are timed in turns (variants, tree, tree, variants reversed;
CUDA events, the best of each). It prints one line per launch and
version, each with its share of chip_smoke.py's bound, a JSON summary of
the best ms, and the card as nvidia-smi reports it. Exits non-zero
without a card or on a mismatch.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

OUT = ROOT / "build" / "ab"


def _bind_all(srcs):
    """Build every source (one nvcc each, all started together) and bind
    its C entries as ops/tile_trace.py binds the tree's; prints ptxas's
    register and spill lines. Returns {stem: bound entries}."""
    from rtmm_tpu_torch.ops import _build, tile_trace
    procs = {}
    for src in map(Path, srcs):
        lib = OUT / f"lib{src.stem}.so"
        procs[src] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    bound = {}
    for src, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{report}")
        print(f"[ptxas {src.name}] " + " | ".join(
            line.split("ptxas info    : ")[-1]
            for line in report.splitlines()
            if "registers" in line or "spill" in line), flush=True)
        bound[src.stem] = tile_trace._bind(ctypes.CDLL(str(lib)))
    return bound


@contextlib.contextmanager
def _routed(bound):
    """Route the trace wrappers' launches to a bound variant."""
    from rtmm_tpu_torch.ops import tile_trace
    orig = tile_trace._lib
    tile_trace._lib = lambda: bound
    try:
        yield
    finally:
        tile_trace._lib = orig


def _raw_case(cs):
    """Config 8's merged raw launch."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.render import instances as inst_mod

    mesh = procedural.make_icosphere(subdivisions=1, level=3, amplitude=0.12)
    base = scene_mod.build_device_scene(mesh, device="cuda")
    cfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT)
    ivp = cs._camera(25.0, cfg, cs.DIST_8)
    rot, trn, scl = inst_mod.instance_tensors(cs._ring(64), "cuda")
    world = inst_mod.world_frame(ivp, cfg, "cuda")
    launch = inst_mod.merged_launch_inputs(base, rot, trn, scl, ivp, world,
                                           cfg)
    meta, tables, opts = tile_trace.scene_tables(base)
    args = (launch.ccand, launch.ccount, launch.centry, launch.frus, meta,
            tables, cfg)

    def run():
        return [tile_trace.trace_raw(*args, raymat=launch.raymat, **opts)]

    def plain(rows):
        return tile_trace.trace_raw_plain(*args, raymat=launch.raymat,
                                          **opts, rows=rows)

    out = run()
    nbytes = cs._nbytes(*args[:4], meta, tables, *out[0])
    return dict(run=run, plain=plain, ccount=launch.ccount, derive=False,
                nbytes=nbytes)


def _windows_case(cs):
    """Config 7 cut: every window launch of one frame."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import tile_trace

    mesh = procedural.make_plane(grid=(cs.GRID_7, cs.GRID_7), level=3,
                                 amplitude=0.05)
    scene = scene_mod.build_device_scene(mesh, compressed=True,
                                         device="cuda")
    cfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT,
                       kernel_clusters_per_window=cs.CLUSTERS_PER_WINDOW_7)
    launches, _ = cs._window_launches(scene, cs._camera(25.0, cfg), cfg,
                                      cs.CLUSTERS_PER_WINDOW_7)

    def run():
        return [tile_trace.trace_windowed(*args, **opts)
                for args, opts in launches]

    def plain(rows):
        args, opts = launches[0]
        return tile_trace.trace_windowed_plain(*args, **opts, rows=rows)

    nbytes = sum(cs._nbytes(*a[:5], *a[5], *a[6:8], o["corners"])
                 + cs._nbytes(*a[5]) for a, o in launches)
    return dict(run=run, plain=plain, ccount=launches[0][0][1],
                derive=True, nbytes=nbytes)


@functools.lru_cache(maxsize=None)
def _scene9():
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    mesh = procedural.make_plane(grid=(160, 160), level=2, amplitude=0.05)
    return scene_mod.build_device_scene(mesh, compressed=True, device="cuda")


def _raw9_case(cs, longest_first):
    """Config 9's frame through the raw mode with its ray matrix (rows are
    independent there): in the frame's tile order, or with the rows
    reordered by their visits, most first."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.ops import tile_trace

    scene = _scene9()
    cfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT)
    kc = tile_trace.clusters_per_window(scene, cfg)
    fi, frus, raymat = tile_trace.ray_frame_inputs(scene,
                                                   cs._camera(25.0, cfg), cfg)
    lists = tile_trace.cluster_lists(scene, fi, kc)
    meta, tables, opts = tile_trace.scene_tables(scene)
    rows = (*lists, frus, raymat)
    if longest_first:
        vis = tile_trace.trace_raw(*rows[:4], meta, tables, cfg,
                                   raymat=raymat, **opts)[1]
        order = torch.argsort(vis, descending=True, stable=True)
        rows = tuple(x[order].contiguous() for x in rows)
    args = (*rows[:4], meta, tables, cfg)

    def run():
        return [tile_trace.trace_raw(*args, raymat=rows[4], **opts)]

    def plain(check):
        return tile_trace.trace_raw_plain(*args, raymat=rows[4], **opts,
                                          rows=check)

    nbytes = cs._nbytes(*rows, meta, tables, opts["corners"], *run()[0])
    return dict(run=run, plain=plain, ccount=rows[1], derive=True,
                nbytes=nbytes)


def _fused_case(cs, compressed):
    """Config 3's frame (K1a) or config 9's compressed frame (K1c)."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import culling, tiled, tile_trace

    if compressed:
        scene = _scene9()
    else:
        mesh = procedural.make_icosphere(subdivisions=3, level=3,
                                         amplitude=0.12)
        scene = scene_mod.build_device_scene(mesh, device="cuda")
    cfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT)
    kc = tile_trace.clusters_per_window(scene, cfg)
    rows = tile_trace.frame_inputs(scene, cs._camera(25.0, cfg), cfg, kc)
    meta, tables, opts = tile_trace.scene_tables(scene)
    pw, ph = tiled.padded_size(cs.WIDTH, cs.HEIGHT)
    tx = pw // culling.TILE_W
    geo = dict(tiles_per_frame=tx * (ph // culling.TILE_H), tx=tx, pw=pw,
               ph=ph)
    args = (*rows, meta, tables, cfg)

    def run():
        return [tile_trace.trace_fused(*args, **opts, **geo)]

    def plain(rows_):
        return tile_trace.trace_fused_plain(*args, **opts, **geo,
                                            rows=rows_)

    nbytes = (cs._nbytes(*rows, meta, tables, opts.get("corners"))
              + pw * ph * 12 + 2 * rows[3].shape[0] * 4)
    return dict(run=run, plain=plain, ccount=rows[1], derive=compressed,
                nbytes=nbytes, fused=geo)


def _pixels(img, rows, geo):
    """The pixels of tile rows `rows` of a fused launch's image."""
    th = tw = 32
    out = []
    for n in rows:
        f, t = divmod(n, geo["tiles_per_frame"])
        y0, x0 = (t // geo["tx"]) * th, (t % geo["tx"]) * tw
        out.append(img[f, y0:y0 + th, x0:x0 + tw])
    return torch.stack(out)


def _compare(a, b, rows=None, geo=None):
    """(counts equal, t or pixels bit-equal, max |diff| of the floats) of
    one launch's outputs a and b, on `rows` (all if None)."""
    sel = slice(None) if rows is None else rows
    if geo is not None:                      # fused: image, visits, elig
        pa = a[0] if rows is None else _pixels(a[0], rows, geo)
        pb = b[0] if rows is None else _pixels(b[0], rows, geo)
        counts = (torch.equal(a[1][sel], b[1][sel])
                  and torch.equal(a[2][sel], b[2][sel]))
        return counts, torch.equal(pa, pb), float((pa - pb).abs().max())
    if len(a) == 3:                          # raw: out, visits, elig
        counts = (torch.equal(a[1][sel], b[1][sel])
                  and torch.equal(a[2][sel], b[2][sel]))
        t_eq = torch.equal(a[0][sel, 0], b[0][sel, 0])
        return counts, t_eq, float((a[0][sel] - b[0][sel]).abs().max())
    counts = (torch.equal(a[2][sel], b[2][sel])   # windowed: t, n, vis, elig
              and torch.equal(a[3][sel], b[3][sel]))
    err = max(float((a[0][sel] - b[0][sel]).abs().max()),
              float((a[1][sel] - b[1][sel]).abs().max()))
    return counts, torch.equal(a[0][sel], b[0][sel]), err


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from rtmm_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    card = cs._card_line()
    _build.build_all(("tile_trace",))
    print("[ptxas tree] " + " | ".join(
        line.split("ptxas info    : ")[-1]
        for line in _build.ptxas_report("tile_trace").splitlines()
        if "registers" in line or "spill" in line), flush=True)
    variants = _bind_all(sys.argv[1:])
    cases = {"config 8 raw": lambda: _raw_case(cs),
             "config 7 cut windows": lambda: _windows_case(cs),
             "config 3 fused": lambda: _fused_case(cs, False),
             "config 9 fused compressed": lambda: _fused_case(cs, True),
             "config 9 raw, tile order": lambda: _raw9_case(cs, False),
             "config 9 raw, most visits first": lambda: _raw9_case(cs,
                                                                   True)}
    summary = {}
    for tag, make in cases.items():
        t0 = time.perf_counter()
        case = make()
        run, geo = case["run"], case.get("fused")
        tree = run()
        torch.cuda.synchronize()
        first = tree[0]
        vis = first[2] if len(first) == 4 else first[1]
        rows = cs._check_rows(case["ccount"], vis)
        p = case["plain"](rows)
        counts, bit, err = _compare(first, p, rows, geo)
        nvis = sum(int((o[2] if len(o) == 4 else o[1]).sum()) for o in tree)
        busy = vis[case["ccount"] > 0].float()
        top = torch.sort(busy, descending=True).values
        print(f"[{tag}] visits per non-empty row of the first launch: mean "
              f"{float(busy.mean()):.1f}, max {int(top[0])} (row "
              f"{int(vis.argmax())} of {vis.shape[0]}), 99th percentile "
              f"{float(torch.quantile(busy, 0.99)):.0f}; the busiest 5% of "
              f"the rows hold {float(top[:max(1, len(top) // 20)].sum() / top.sum()):.3f}"
              " of its visits", flush=True)
        print(f"[{tag}] {len(tree)} launch(es), {nvis} visits on "
              f"{case['ccount'].shape[0]} rows (set up in "
              f"{time.perf_counter() - t0:.1f} s); tree vs plain on "
              f"{len(rows)} rows of the first launch: counts equal {counts}, "
              f"{'pixels' if geo else 't'} bit-equal {bit}, max |diff| "
              f"{err:.3e}", flush=True)
        if not counts or err > cs.MAX_ABS_ERR or (not geo and not bit):
            return 1
        runs = {"tree": run}
        for name, bound in variants.items():
            with _routed(bound):
                outs = run()
            torch.cuda.synchronize()
            res = [_compare(o, t, geo=geo) for o, t in zip(outs, tree)]
            counts = all(r[0] for r in res)
            bit = all(r[1] for r in res)
            err = max(r[2] for r in res)
            print(f"  {name} vs tree, every row: counts equal {counts}, "
                  f"{'pixels' if geo else 't'} bit-equal {bit}, max |diff| "
                  f"{err:.3e}", flush=True)
            if not counts or err > cs.MAX_ABS_ERR or (not geo and not bit):
                return 1

            def routed(bound=bound):
                with _routed(bound):
                    run()
            runs[name] = routed
        order = [*variants, "tree", "tree", *reversed(variants)]
        times = {}
        for name in order:
            runs[name]()
            times.setdefault(name, []).append(
                cs._events_ms(runs[name], reps=3, rounds=3))
        bound, by = cs._bound(card, tag, nvis, case["nbytes"],
                              case["derive"])
        for name, v in times.items():
            print(f"  {name}: {min(v):.4f} ms (turns "
                  f"{', '.join(f'{x:.4f}' for x in v)}); at "
                  f"{bound / min(v):.3f} of the bound {bound:.4f} ms ({by})",
                  flush=True)
        summary[tag] = {n: min(v) for n, v in times.items()}
        summary[tag]["bound_ms"] = bound
        summary[tag]["visits"] = nvis
    print(json.dumps(summary))
    print(card)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"[k1_ab] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
