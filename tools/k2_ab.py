"""Compare the tree's grouped trace kernel K2 (csrc/group_trace.cu) with
other versions of the same source on config 5's frame-0 launches, on one
NVIDIA card.

    python3 tools/k2_ab.py [VARIANT.cu ...]

A variant is a copy of group_trace.cu with the same C entry
`rtmm_group_trace`, with or without the `tests` output (an older
version: `git show <commit>:rtmm_tpu_torch/csrc/group_trace.cu >
build/ab/old.cu`). Every source is built with the port's nvcc flags.
The script renders bench config 5 (chip_smoke.py's scene, camera and
settings), precomputed and compressed, records frame 0's K2 launches
(one per bounce), holds the tree's kernel against the plain version on
each (t, visits, gated sub-groups and tests equal per group) and each
variant against the tree's kernel (t, visits, gated and, where it has
it, tests equal), then times them in turns (variants, tree, tree,
variants reversed; CUDA events, the best of each). It prints one line
per launch and version, a JSON summary of the best ms, and the card as
nvidia-smi reports it. Exits non-zero without a card or on a mismatch.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

OUT = ROOT / "build" / "ab"


def _bind(src: Path):
    """Build `src` and bind its rtmm_group_trace; returns (fn, has_tests)."""
    from rtmm_tpu_torch.ops import _build
    lib = OUT / f"lib{src.stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    has_tests = "int* tests" in src.read_text()
    fn = ctypes.CDLL(str(lib)).rtmm_group_trace
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([vp] * 9 + [ci] + [vp] * 2 + [ci] + [vp]
                   + [vp] * (5 if has_tests else 4) + [ci] * 3 + [cf] * 2
                   + [vp])
    fn.restype = ci
    return fn, has_tests


def _run(fn, has_tests, args, kwargs):
    """One launch of a bound variant on trace_group's arguments."""
    rv, box, ccand, ccount, centry, t_in, n_in, meta, tables, nrm, cfg = args
    comp = kwargs.get("compressed", False)
    corners = kwargs.get("corners")
    g, kc = ccand.shape
    t_out, n_out = torch.empty_like(t_in), torch.empty_like(n_in)
    counts = [torch.zeros(g, dtype=torch.int32, device=rv.device)
              for _ in range(3)]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    outs = [t_out, n_out, *counts[:3 if has_tests else 2]]
    rc = fn(rv.data_ptr(), box.data_ptr(), ccand.data_ptr(),
            ccount.data_ptr(), centry.data_ptr(), t_in.data_ptr(),
            n_in.data_ptr(), meta.data_ptr(),
            None if comp else tables.data_ptr(),
            0 if comp else nrm.shape[2], ptr(nrm),
            tables.data_ptr() if comp else None,
            tables.shape[1] if comp else 0, ptr(corners),
            *(x.data_ptr() for x in outs), g, kc, meta.shape[0], cfg.t_min,
            cfg.t_max, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: {rc}")
    return (t_out, n_out, *counts)


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_ab: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import group_trace
    from rtmm_tpu_torch.render import pathtrace

    OUT.mkdir(parents=True, exist_ok=True)
    variants = {Path(p).stem: _bind(Path(p)) for p in sys.argv[1:]}
    card = cs._card_line()
    mesh = procedural.make_icosphere(subdivisions=0, level=5, amplitude=0.1)
    cfg = RenderConfig(width=cs.PT_SIZE, height=cs.PT_SIZE, sub_frusta=8)
    pt = pathtrace.PathTraceConfig(bounces=cs.PT_BOUNCES,
                                   samples_per_pixel=cs.PT_SPP,
                                   ray_chunk=16384)
    ivp = cs._camera(25.0, cfg)
    summary = {}
    for comp in (False, True):
        scene = scene_mod.build_device_scene(mesh, compressed=comp,
                                             device="cuda")
        rec = {}
        with cs._k2_recording(rec, launches=True):
            pathtrace.PathTracer(scene, cfg, pt).render(ivp)
        torch.cuda.synchronize()
        for bounce, args, kwargs in rec["launches"]:
            tag = f"{'compressed' if comp else 'precomputed'} bounce {bounce}"
            k = group_trace.trace_group(*args, **kwargs)
            p = group_trace.trace_group_plain(*args, **kwargs)
            ok = torch.equal(k[0], p[0]) and all(
                torch.equal(k[j], p[j]) for j in (2, 3, 4))
            busy = int(k[2].argmax())
            print(f"[{tag}] visits {int(k[2].sum())}, gated "
                  f"{int(k[3].sum())}, tests {int(k[4].sum())} on "
                  f"{int((args[3] > 0).sum())} non-empty groups (busiest: "
                  f"{int(k[2][busy])} visits, {int(k[4][busy])} tests); "
                  f"tree vs plain equal: {ok}", flush=True)
            if not ok:
                return 1
            runs = {"tree": lambda: group_trace.trace_group(*args, **kwargs)}
            for name, (fn, has_tests) in variants.items():
                v = _run(fn, has_tests, args, kwargs)
                same = torch.equal(v[0], k[0]) and all(
                    torch.equal(v[j], k[j])
                    for j in ((2, 3, 4) if has_tests else (2, 3)))
                print(f"  {name}: equal to the tree: {same}", flush=True)
                if not same:
                    return 1
                runs[name] = (lambda fn=fn, h=has_tests:
                              _run(fn, h, args, kwargs))
            order = [*variants, "tree", "tree", *reversed(variants)]
            times = {}
            for name in order:
                runs[name]()
                times.setdefault(name, []).append(
                    cs._events_ms(runs[name], reps=5, rounds=3))
            print("  ms " + "; ".join(
                f"{n} {min(v):.4f} ({', '.join(f'{x:.4f}' for x in v)})"
                for n, v in times.items()), flush=True)
            summary[tag] = {n: min(v) for n, v in times.items()}
    print(json.dumps(summary))
    print(card)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"[k2_ab] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
