"""The program's spans read by the benchmark (rtbench/program_spans.py and
its six metrics) in traced runs on the CPU, through the renderer's plain
versions; and nothing of them where the program has no spans module."""
from __future__ import annotations

import builtins
import json

import pytest

from rtbench import harness, program_spans, runner
from rtbench.tests.tiny import ROOT, tiny_cell

NEW = {"sphere5-pathtrace": ("host_syncs_per_frame.pathtrace",
                             "pt_host_ms.pathtrace",
                             "launch_host_us.pathtrace"),
       "sphere3-interactive": ("submit_issue_ms.interactive",
                               "fence_wait_ms.interactive",
                               "prologue_host_ms.interactive")}


def _cell(name):
    cell = tiny_cell(name)
    if name == "sphere3-interactive":
        # Two tiles a frame: enough frames in a short window for a mean.
        cell.traffic.update(width=64, height=32)
    return cell


@pytest.fixture(scope="module")
def traced():
    return {name: runner.run_cell(_cell(name), 2**31 + 77, 3.0, True, "cpu")
            for name in NEW}


@pytest.mark.parametrize("name", NEW)
def test_traced_run_reads_the_new_metrics(traced, name):
    res = traced[name]
    assert res["correct"]
    for metric in NEW[name]:
        assert res["metrics"][metric]["value"] is not None, metric
    got = res["_run"].program_spans
    assert got["frames"] >= program_spans.MIN_STEPS - 2
    names = {r.name for r in got["records"]}
    assert names & set(program_spans.WRAPPERS)


def test_submit_split_adds_up(traced):
    """Issue and fence wait make up the submits of the loop they are read
    from. (Against the window's `submit_host_ms`, read seconds earlier,
    they are compared on the card: on a shared CPU the two loops' frame
    times drift apart by more than 10%.)"""
    res = traced["sphere3-interactive"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    split = m["submit_issue_ms.interactive"] + m["fence_wait_ms.interactive"]
    assert split == pytest.approx(program_spans.per_submit_ms(
        res["_run"], "rtmm.submit"), rel=0.02)
    assert m["submit_host_ms.interactive"] > 0


def test_host_syncs_per_frame_counts_every_site(traced):
    """The CPU runs the grouped engine: per bounce its candidate count and
    its overflow count, and lane-cap reads where a cap is under the
    state."""
    got = traced["sphere5-pathtrace"]["_run"].program_spans
    syncs = got["counters"]["syncs"]
    bounces = int(_cell("sphere5-pathtrace").traffic["bounces"])
    assert syncs["grouped.candidates"] == bounces * got["frames"]
    assert syncs["pathtrace.overflow"] == bounces * got["frames"]
    value = traced["sphere5-pathtrace"]["metrics"][
        "host_syncs_per_frame.pathtrace"]["value"]
    assert value == sum(syncs.values()) / got["frames"]


def test_no_spans_module_reads_nothing(monkeypatch):
    """A program without utils/spans.py (the parent of these metrics):
    the readers return None and raise nothing."""
    real = builtins.__import__

    def deny(name, *args, **kwargs):
        if name == "rtmm_tpu_torch.utils" and "spans" in (args[2] or ()):
            raise ImportError("no spans")
        return real(name, *args, **kwargs)

    class Run:
        pass

    monkeypatch.setattr(builtins, "__import__", deny)
    for name, metrics in NEW.items():
        cell = harness.Cell(name)
        for metric in metrics:
            assert cell.reader(metric).read(Run(), metric) is None


def test_new_metrics_are_appended():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    tail = bench["per_layer"][-6:]
    assert [m["name"] for m in tail] == [m for ms in NEW.values()
                                         for m in ms]
    for m in tail:
        assert m["workloads"] == [next(c for c, ms in NEW.items()
                                       if m["name"] in ms)]
