"""The port's benchmark module against the JAX package's bench.py.

rtmm_tpu_torch/bench.py copies bench.py's configurations, pins, gates,
orbit and row. Here each copy is held against bench.py itself: the
configuration table with the mesh and scene builders replaced by
recorders (nothing large is built), the pins and the visit gate, the
orbit's length and cameras, config 5's ray count, and the row's keys,
read from bench.py's main with its renders stubbed. One row runs for
real, config 2 at 256x256 on the plain versions; and without a card the
module refuses to run instead of falling back to the CPU.
"""
import dataclasses
import json
import os
import sys
import tempfile
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")
import bench  # noqa: E402
from rtmm_tpu import config as jax_config  # noqa: E402
from rtmm_tpu.models import procedural as jax_procedural  # noqa: E402
from rtmm_tpu.models import scene as jax_scene  # noqa: E402
from rtmm_tpu.render import instances as jax_instances  # noqa: E402
from rtmm_tpu.render import pathtrace as jax_pathtrace  # noqa: E402
from rtmm_tpu.render import renderer as jax_renderer  # noqa: E402
from rtmm_tpu.utils import cache as jax_cache  # noqa: E402
from rtmm_tpu.utils import camera as jax_camera  # noqa: E402
from rtmm_tpu.io import loader as jax_loader  # noqa: E402
from rtmm_tpu_torch import bench as port  # noqa: E402
from rtmm_tpu_torch.config import RenderConfig  # noqa: E402
from rtmm_tpu_torch.io import loader as port_loader  # noqa: E402
from rtmm_tpu_torch.models import procedural as port_procedural  # noqa: E402
from rtmm_tpu_torch.models import scene as port_scene  # noqa: E402
from rtmm_tpu_torch.render import instances as port_instances  # noqa: E402

torch.set_num_threads(1)

# Configurations and environment variants of the table (bench.py:70-199).
CASES = [(n, None) for n in range(1, 12)] + [
    (5, "RTMM_PT_COMPRESSED"), (8, "RTMM_INSTANCE_BAKED"),
    (10, "RTMM_INSTANCE_BAKED")]


def _bench_distance(n):
    """bench.py:777 (and _bench_instanced / _verify_instanced's default
    6.5 for the two-level configs)."""
    return 4.5 if n == 4 else (6.5 if n in (8, 10) else 3.0)


@dataclasses.dataclass(frozen=True)
class _Built:
    """What a recorder returns in place of a mesh or a scene."""
    name: str
    index: int


def _record(monkeypatch, procedural, scene, instances, loader):
    """Replace a package's mesh, scene, bake and asset io builders by
    recorders; returns the list of calls they record."""
    calls = []

    def recorder(name):
        def rec(*args, **kwargs):
            kwargs.pop("device", None)
            calls.append((name, args, kwargs))
            return _Built(name, len(calls) - 1)
        return rec

    monkeypatch.setattr(procedural, "make_icosphere",
                        recorder("make_icosphere"))
    monkeypatch.setattr(procedural, "make_plane", recorder("make_plane"))
    monkeypatch.setattr(scene, "build_device_scene", recorder("scene"))
    monkeypatch.setattr(instances, "bake_instances", recorder("bake"))
    monkeypatch.setattr(loader, "save_gltf_bary", lambda *a, **k: None)
    monkeypatch.setattr(loader, "load_micromesh", recorder("load"))
    return calls


def _normal(calls):
    """Calls with build_device_scene's flags made explicit, rings as
    arrays and the asset's path as its directory (each package writes a
    file of its own name)."""
    out = []
    for name, args, kwargs in calls:
        if name == "load":
            args = (os.path.dirname(args[0]),)
        if name == "scene":
            kwargs = {k: bool(kwargs.get(k, False))
                      for k in ("tessellated", "compressed")}
        if name == "bake":
            args = (args[0], _ring_arrays(args[1]))
        out.append((name, args, kwargs))
    return out


def _ring_arrays(ring):
    return [np.stack([i.rotation for i in ring]),
            np.stack([i.translation for i in ring]),
            np.asarray([i.scale for i in ring])]


def _assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("n,env", CASES,
                         ids=[f"{n}-{e or 'default'}" for n, e in CASES])
def test_config_table_equals_bench(n, env, monkeypatch, tmp_path):
    if env:
        monkeypatch.setenv(env, "1")
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    jax_calls = _record(monkeypatch, jax_procedural, jax_scene,
                        jax_instances, jax_loader)
    # bench.py's disk cache of config 7 stores the recorder's stand-in.
    monkeypatch.setattr(jax_cache, "_meta_arrays", lambda scene: {})
    metric, scene, cfg, _ = bench._build_config_raw(n)
    port_calls = _record(monkeypatch, port_procedural, port_scene,
                         port_instances, port_loader)
    got = port._build_config_raw(n, device="cpu")

    assert got.metric == metric
    assert (got.cfg.width, got.cfg.height, got.cfg.sub_frusta) == (
        cfg.width, cfg.height, cfg.sub_frusta)
    assert got.dist == _bench_distance(n)
    _assert_same(_normal(port_calls), _normal(jax_calls))
    for a, b in zip(port_calls, jax_calls):
        if a[0] == "load":
            assert os.path.basename(a[1][0]) != os.path.basename(b[1][0])
    if isinstance(scene, tuple):
        assert got.scene[0] == scene[0]
        _assert_same(_ring_arrays(got.scene[1]), _ring_arrays(scene[1]))
    assert jax_calls


def test_pins_and_visit_gate_equal_bench():
    assert port.EXPECTED_VISITS == bench.EXPECTED_VISITS
    assert port.VISITS_RTOL == bench.VISITS_RTOL
    for n in range(1, 12):
        pin = bench.EXPECTED_VISITS.get(n, 1000)
        for f in (-0.06, -0.04, 0.0, 0.04, 0.06, 0.10):
            v = int(round(pin * (1 + f)))
            assert port.visit_gate(n, v) == bench.visit_gate(n, v)
        if n in bench.EXPECTED_VISITS:
            assert port.visit_gate(n, int(pin * 1.10)) is not None


@pytest.mark.parametrize("frames", [None, "5"])
def test_frames_per_call_and_cameras_equal_bench(frames, monkeypatch):
    if frames:
        monkeypatch.setenv("RTMM_BENCH_FRAMES", frames)
    for w, h in ((256, 256), (512, 512), (1024, 1024), (1920, 1080)):
        cfg = jax_config.RenderConfig(width=w, height=h)
        assert port._frames_per_call(RenderConfig(width=w, height=h)) == (
            bench._frames_per_call(cfg))
    # bench.py:317-327, over the JAX package's camera.
    cfg = RenderConfig(width=1920, height=1080)
    for n_frames, offset, dist in ((32, 25.0 + 0.7, 3.0), (4, 25.0, 6.5)):
        ref = []
        for k in range(n_frames):
            tb = jax_camera.Trackball()
            tb.set_camera([0.0, 0.0, 0.0],
                          [np.radians(-30.0),
                           np.radians(offset + 360.0 / n_frames * k), 0.0],
                          dist)
            ref.append(jax_camera.inv_view_proj(tb, cfg.width, cfg.height))
        got = port._orbit_cameras(cfg, n_frames, offset, dist, "cpu")
        np.testing.assert_array_equal(
            got.numpy(), np.stack(ref).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pathtrace_ray_count_equals_bench(seed):
    rng = np.random.default_rng(seed)
    live = np.sort(rng.uniform(0, 512 * 512, 4).astype(np.float32))[::-1]
    live = np.ascontiguousarray(live) + np.float32(0.37)
    for spp in (1, 2, 4):
        # bench.py:706-708 on the orbit's float32 live means.
        ref = int(512 * 512 + live[:-1].sum() * spp)
        assert port._pathtrace_rays(512, 512, live, spp) == ref


class _Scene(NamedTuple):
    unit_valid: np.ndarray


def _bench_row(monkeypatch, capsys, n):
    """bench.py main's row for config n, its scene, timing and renders
    stubbed (blank frames; the verify fields are bench's own)."""
    def blank(*args, **kwargs):
        cfg = next(a for a in args if hasattr(a, "width"))
        return jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    class Tracer:
        def __init__(self, scene, cfg, pt):
            self.pt = pt

    cfgs = {2: jax_config.RenderConfig(width=256, height=256),
            5: jax_config.RenderConfig(width=512, height=512, sub_frusta=8),
            8: jax_config.RenderConfig(width=1920, height=1080)}
    scene = {2: _Scene(np.ones(1, bool)), 5: None,
             8: (None, port._ring(64)[:2])}[n]
    monkeypatch.setattr(bench, "_build_config",
                        lambda k: (port.METRICS[k], scene, cfgs[k], 1))
    monkeypatch.setattr(bench, "_bench_render", lambda *a, **k: 1.0)
    monkeypatch.setattr(bench, "_bench_instanced", lambda *a, **k: 1.0)
    monkeypatch.setattr(bench, "_bench_pathtrace", lambda *a, **k: 1.0)
    monkeypatch.setattr(bench, "_visit_stats", lambda *a, **k: (95, 95))
    monkeypatch.setattr(jax_renderer, "render_image", blank)
    monkeypatch.setattr(jax_instances, "_render_instanced", blank)
    monkeypatch.setattr(jax_pathtrace, "PathTracer", Tracer)
    monkeypatch.setattr(jax_pathtrace, "path_trace",
                        lambda s, m, cfg, pt: (blank(cfg), {}))
    monkeypatch.setattr(sys, "argv", ["bench.py", "--config", str(n)])
    capsys.readouterr()
    bench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_row(monkeypatch, capsys, n):
    """The port's row for config n with the same stubs."""
    def blank(*args, **kwargs):
        cfg = next(a for a in args if hasattr(a, "width"))
        return torch.zeros((cfg.height, cfg.width, 3))

    class Tracer:
        def __init__(self, scene, cfg, pt):
            self.pt, self.cfg = pt, cfg

        def render(self, ivp):
            return blank(self.cfg), {}

    ring = port._ring(64)[:2]
    base = type("S", (), {"device": torch.device("cpu"),
                          "unit_valid": torch.ones(1, dtype=torch.bool)})()
    cfgs = {2: RenderConfig(width=256, height=256),
            5: RenderConfig(width=512, height=512, sub_frusta=8),
            8: RenderConfig(width=1920, height=1080)}
    scene = {2: base, 5: base, 8: (base, ring)}[n]
    monkeypatch.setattr(port, "_build_config_raw", lambda k, d: port.Config(
        port.METRICS[k], scene, cfgs[k], 3.0))
    for name in ("_bench_render", "_bench_instanced", "_bench_pathtrace"):
        monkeypatch.setattr(port, name, lambda *a, **k: 1.0)
    monkeypatch.setattr(port, "_visit_stats", lambda *a, **k: (95, 95))
    monkeypatch.setattr(port, "render_image", blank)
    monkeypatch.setattr(port_instances, "_render_instanced", blank)
    monkeypatch.setattr(port, "PathTracer", Tracer)
    capsys.readouterr()
    assert port.main(["--config", str(n), "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("n,kind", [(2, "image"), (8, "instanced"),
                                    (5, "pathtrace")])
def test_row_keys_equal_bench(n, kind, monkeypatch, capsys):
    ref = _bench_row(monkeypatch, capsys, n)
    got = _port_row(monkeypatch, capsys, n)
    want = tuple(k for k in ref if k != "vs_baseline")
    assert tuple(got) == want == port.ROW_KEYS[kind]
    verify = {k: v for k, v in ref.items() if k.startswith("verify_")
              or k.startswith("covered")}
    assert {k: got[k] for k in verify} == verify


@pytest.mark.parametrize("code", [4, 5])
def test_failing_gate_exits_with_bench_code(code, monkeypatch, capsys):
    """A visit count 10% over the pin exits 5, an image over its budget
    4, each with value 0.0 and the error in the row (bench.py:745-831)."""
    base = type("S", (), {"device": torch.device("cpu")})()
    monkeypatch.setattr(port, "_build_config_raw", lambda k, d: port.Config(
        port.METRICS[k], base, RenderConfig(width=256, height=256), 3.0))
    monkeypatch.setattr(port, "_bench_render", lambda *a, **k: 1.0)
    monkeypatch.setattr(port, "_visit_stats", lambda *a, **k: (
        (int(95 * 1.10), 95) if code == 5 else (95, 95)))
    fail = {"verify_npix": 65, "verify_nbig": 0, "verify_maxdiff": 0.5,
            "verify_budget": 64, "verify_big_budget": 16,
            "verify_mode": "pixel", "verify_ncell": 0, "verify_maxcell": 0.0,
            "verify_cell_budget": 8}
    monkeypatch.setattr(port, "_verify_image", lambda *a, **k: fail)
    capsys.readouterr()
    assert port.main(["--config", "2", "--device", "cpu"]) == code
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["value"] == 0.0 and row["error"]
    assert ("visit-count gate" in row["error"]) == (code == 5)


def test_cpu_row_of_config2(monkeypatch, capsys):
    """Config 2 at 256x256 on the plain versions, 2 frames per call: the
    pin's 95 visits, bench.py's verify in pixel mode within budget."""
    monkeypatch.setenv("RTMM_BENCH_FRAMES", "2")
    capsys.readouterr()
    assert port.main(["--config", "2", "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tuple(row) == port.ROW_KEYS["image"]
    assert row["metric"] == "micromesh_256_lowpoly"
    assert row["visits"] == row["visits_expected"] == 95
    assert row["verify_mode"] == "pixel"
    assert row["verify_npix"] <= row["verify_budget"]
    assert row["verify_nbig"] <= row["verify_big_budget"]
    assert row["value"] > 0


def test_no_card_exits_without_rendering(monkeypatch, capsys):
    """--device cuda (the default) with no card: the error row and exit
    1; no configuration is built, nothing falls back to the CPU."""
    def forbidden(*args, **kwargs):
        raise AssertionError("built a configuration without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port, "_build_config_raw", forbidden)
    capsys.readouterr()
    assert port.main(["--config", "2"]) == 1
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row == {"metric": "micromesh_256_lowpoly", "value": 0.0,
                   "unit": "Mrays/s", "error": row["error"]}
    assert "no CUDA device" in row["error"]
