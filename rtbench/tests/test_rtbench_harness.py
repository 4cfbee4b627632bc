"""The harness on the CPU: the contract's shape of BENCHMARK.json, the
import guard, each cell's run through the renderer's plain versions, the
control and the faults judged incorrect, and a cell added as new files
only."""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from rtbench import check, faults, harness, runner, scene
from rtbench.tests.tiny import ROOT, tiny_cell

CELLS = ("sphere3-orbit", "sphere5-pathtrace", "sphere3-interactive")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "check"]


def _line(result: dict) -> dict:
    return {k: v for k, v in result.items() if not k.startswith("_")}


def test_benchmark_json_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    names = [c["name"] for c in bench["configs"]] + [
        w["name"] for w in bench["workloads"]] + [
        m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moved = next(x for x in bench["end_to_end"]
                         if x["name"] == m["moves"])
            assert "workloads" not in moved or w in moved["workloads"]
    for name in CELLS:
        cell = harness.Cell(name)
        assert cell.limits is not None
        for m in cell.metrics(False) + cell.metrics(True):
            cell.reader(m["name"])


def test_run_needs_a_card():
    """Without a CUDA card the command exits 2 and prints no result."""
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "sphere3-orbit",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 2 and out.stdout == ""


IMPORT_WALK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(4)
import rtbench.run, rtbench.calibrate
from rtbench import harness, runner
from rtbench.tests.tiny import tiny_cell
lines = {}
for name in sys.argv[2:]:
    cell = tiny_cell(name)
    res = runner.run_cell(cell, 2**31 + 11, 0.1, False, "cpu")
    lines[name] = {k: v for k, v in res.items() if not k.startswith("_")}
print(json.dumps({"held": sorted({m.split(".")[0] for m in sys.modules}),
                  "lines": lines}))
"""


@pytest.fixture(scope="module")
def cpu_runs():
    """Each cell run once at a tiny size in a fresh process; the modules
    the process held afterwards."""
    out = subprocess.run([sys.executable, "-c", IMPORT_WALK, str(ROOT),
                          *CELLS], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_nothing_imports_jax(cpu_runs):
    held = set(cpu_runs["held"])
    assert "rtmm_tpu_torch" in held
    assert not held & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_renderer():
    """The reference and the base meshes load nothing of the renderer."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import rtbench.reference.render, rtbench.reference.geometry; "
            "from rtbench import harness; "
            "[harness.base_arrays(harness.Cell(c).config['recipe']) "
            "for c in sys.argv[2:]]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), *CELLS],
                         capture_output=True, text=True, timeout=300)
    held = set(eval(out.stdout))
    assert not held & {"rtmm_tpu_torch", *harness.FORBIDDEN}


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_plain_versions(cpu_runs, name):
    line = cpu_runs["lines"][name]
    assert list(line) == RESULT_KEYS
    assert line["correct"] is True and line["attempted"] > 0
    assert line["failed"] == 0
    cell = harness.Cell(name)
    want = {m["name"] for m in cell.metrics(False)} - {"peak_mem_mib"}
    assert set(line["metrics"]) == want
    assert set(line["check"]) == set(cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_judged_incorrect(name):
    """The reference in bfloat16 in the renderer's place fails a limit."""
    cell = tiny_cell(name)
    res = runner.run_cell(cell, 424242, 0.1, False, "cpu")
    assert res["correct"]
    low, ok = check.control(res["_run"].driver, res["_drawn"],
                            scene.reference_arrays(cell), "cpu",
                            res["_want"], res["_subsets"], cell.limits)
    assert not ok, low


FAULTS = [(name, fault) for name in CELLS
          for fault in faults.for_entry(harness.Cell(name).traffic["entry"])]


@pytest.mark.parametrize("name, fault", FAULTS,
                         ids=[f"{n}-{f}" for n, f in FAULTS])
def test_fault_is_judged_incorrect(monkeypatch, name, fault):
    cell = tiny_cell(name)
    faults.plant(fault, cell.traffic["entry"], monkeypatch.setattr)
    res = runner.run_cell(cell, 77, 0.3, False, "cpu")
    assert res["correct"] is False, res["check"]


def test_bounce_subset_is_seen():
    """The path tracer's sample holds pixels whose bounce rays hit the
    mesh again, so the bounce faults have pixels to show on."""
    res = runner.run_cell(tiny_cell("sphere5-pathtrace"), 77, 0.3, False,
                          "cpu")
    assert int(res["_subsets"]["bounce"].sum()) >= 20
    assert "px_over_2.bounce" in res["check"]


def _digest(path):
    return {p.relative_to(path): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


PLANE = '''"""Base mesh "plane": the square [-1, 1]^2 of the y = 0 plane,
a grid of recipe["grid"] squares a side, two triangles each, normals +y."""
import numpy as np


def arrays(recipe):
    n = int(recipe["grid"])
    xs = np.linspace(-1.0, 1.0, n + 1)
    pos = np.array([[x, 0.0, z] for x in xs for z in xs], np.float32)
    faces = []
    for i in range(n):
        for j in range(n):
            a, b = i * (n + 1) + j, (i + 1) * (n + 1) + j
            faces += [[a, a + 1, b + 1], [a, b + 1, b]]
    return {"positions": pos,
            "normals": np.tile(np.float32([0, 1, 0]), (len(pos), 1)),
            "faces": np.asarray(faces, np.int64)}
'''


def test_new_cell_from_new_files_only(tmp_path):
    """A cell, its configuration on a new base mesh, its traffic and a
    per-layer metric added as new files; no file the benchmark has is
    edited."""
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "rtbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tmp_path / "rtbench"
    (base / "bases" / "plane.py").write_text(PLANE)
    (base / "configs" / "plane4-l2.json").write_text(json.dumps({
        "recipe": {"base": "plane", "grid": 4, "level": 2,
                   "amplitude": 0.1, "phase": [0, 0, 0, 0],
                   "compressed": False, "io": "memory"}}))
    (base / "traffic" / "orbit4_tiny.json").write_text(json.dumps({
        "entry": "orbit", "width": 64, "height": 64, "frames_per_call": 4,
        "pitch_deg": -30.0, "distance": 2.0, "yaw_step_deg": 1.0,
        "check_per_frame": 32, "check_pixels": 256}))
    (base / "metrics" / "frames_seen.tiny.py").write_text(
        "def read(run, name):\n    return float(run.frames)\n")
    (base / "checks" / "tiny-orbit.json").write_text(
        json.dumps({"limits": {"px_over_2": 0.01, "mean_gap": 0.25}}))
    bench["configs"].append({"name": "plane4-l2", "source": "test",
                             "file": "rtbench/configs/plane4-l2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-orbit", "config": "plane4-l2",
                               "traffic": "orbit4_tiny", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "frames_seen.tiny", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "renderers", "moves": "setup_s",
                               "workloads": ["tiny-orbit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    added = set(_digest(base)) - set(before)
    assert {str(p) for p in added} == {
        "bases/plane.py", "configs/plane4-l2.json",
        "traffic/orbit4_tiny.json", "metrics/frames_seen.tiny.py",
        "checks/tiny-orbit.json"}
    assert all(_digest(base)[p] == h for p, h in before.items())
    cell = harness.Cell("tiny-orbit", tmp_path)
    assert [m["name"] for m in cell.metrics(True)] == ["frames_seen.tiny"]
    res = runner.run_cell(cell, 5, 0.1, True, "cpu")
    assert res["correct"]
    assert res["metrics"]["frames_seen.tiny"]["value"] == res["attempted"]
    covered = (res["_want"].to(torch.int32) != 74).any(-1)
    assert int(covered.sum()) > 256 // 8
