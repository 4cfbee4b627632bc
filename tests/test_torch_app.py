"""The port's CLI on the CPU: a render writes a PNG, errors exit non-zero."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtmm_tpu_torch import app
from rtmm_tpu_torch.io import image as image_io
from rtmm_tpu_torch.io import loader
from rtmm_tpu_torch.models import procedural

# One intra-op thread: the suite runs several pytest workers on one shared
# CPU, and with JAX in the same process the first multi-threaded PyTorch
# op after a JAX computation was seen to compute part of its range wrong
# (about one process in twenty; never single-threaded).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_renders_png(tmp_path):
    out = tmp_path / "frames"
    proc = subprocess.run(
        [sys.executable, "-m", "rtmm_tpu_torch.app", "proc:sphere?level=2",
         "--width", "64", "--height", "64", "--frames", "1",
         "--device", "cpu", "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    img = image_io.read_png(str(out / "frame_0000.png"))
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 1   # not just bg


def test_cli_renders_compressed_png(tmp_path, capsys):
    out = tmp_path / "frames"
    rc = app.main(["proc:plane?level=2,grid=4", "--compressed", "--width",
                   "64", "--height", "64", "--device", "cpu", "--out",
                   str(out)])
    assert rc == 0
    assert "mode=compressed" in capsys.readouterr().out
    img = image_io.read_png(str(out / "frame_0000.png"))
    assert img.shape == (64, 64, 3)
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 1   # not just bg


def test_missing_asset_exits_1(tmp_path, capsys):
    rc = app.main([str(tmp_path / "nope.gltf"), "--device", "cpu"])
    assert rc == 1
    assert "Micro-mesh file does not exist." in capsys.readouterr().err


@pytest.mark.parametrize("flags,says", [
    (["--instances", "3"], "instanced: 3 instances, 72 triangles total"),
    (["--instances", "3", "--tlas"],
     "instanced (two-level TLAS): 3 instances, shared BLAS"),
    (["--compressed", "--instances", "2"], "instanced: 2 instances"),
    (["--compressed", "--instances", "2", "--tlas"], "two-level TLAS"),
])
def test_cli_renders_instances(flags, says, tmp_path, capsys):
    """A ring of instances, baked into one world-space scene or traced
    two-level (--tlas), over precomputed or compressed tables."""
    out = tmp_path / "frames"
    rc = app.main(["proc:sphere?level=2,subdivisions=0", "--width", "96",
                   "--height", "64", "--distance", "5", "--device", "cpu",
                   "--out", str(out), *flags])
    assert rc == 0
    assert says in capsys.readouterr().out
    img = image_io.read_png(str(out / "frame_0000.png"))
    assert img.shape == (64, 96, 3)
    assert (np.abs(img.astype(int) - 74).max(-1) > 0).mean() > 0.02


def test_cli_tlas_matches_baked(tmp_path):
    """The two CLI paths render the same ring: a few silhouette pixels may
    differ by a u8 step, no surface."""
    frames = []
    for name, flags in (("baked", []), ("tlas", ["--tlas"])):
        out = tmp_path / name
        assert app.main(["proc:sphere?level=2,subdivisions=0", "--width",
                         "96", "--height", "64", "--distance", "5",
                         "--instances", "3", "--device", "cpu", "--out",
                         str(out), *flags]) == 0
        frames.append(image_io.read_png(str(out / "frame_0000.png")))
    diff = np.abs(frames[0].astype(int) - frames[1].astype(int)).max(-1)
    assert int((diff > 1).sum()) <= 3, int((diff > 1).sum())


def _flag_cache(tmp_path, monkeypatch, capsys):
    """Run twice on a saved .gltf: one .npz under the port's cache
    directory, written by the first run and read by the second."""
    monkeypatch.setenv("HOME", str(tmp_path))
    asset = str(tmp_path / "a.gltf")
    loader.save_gltf_bary(procedural.make_plane(grid=(2, 2), level=1,
                                                amplitude=0.2), asset)
    args = [asset, "--width", "32", "--height", "16", "--device", "cpu",
            "--cache", "--out", str(tmp_path / "f")]
    assert app.main(args) == 0
    cdir = tmp_path / ".cache" / "rtmm_tpu_torch"
    (npz,) = cdir.iterdir()
    built = npz.stat().st_mtime_ns
    assert app.main(args) == 0
    assert list(cdir.iterdir()) == [npz] and npz.suffix == ".npz"
    assert npz.stat().st_mtime_ns == built      # loaded, not rewritten
    assert (tmp_path / "f" / "frame_0000.png").exists()


def _flag_dump_bary(tmp_path, monkeypatch, capsys):
    """Prints what the JAX package's app prints for the same asset."""
    from rtmm_tpu import app as jax_app

    asset = str(tmp_path / "a.gltf")
    loader.save_gltf_bary(procedural.make_plane(grid=(2, 2), level=1,
                                                amplitude=0.2), asset)
    assert app.main([asset, "--dump-bary"]) == 0
    out = capsys.readouterr().out
    assert jax_app.main([asset, "--dump-bary"]) == 0
    assert out == capsys.readouterr().out and "bary" in out.lower()


def _flag_stats(tmp_path, monkeypatch, capsys):
    """Writes the step heatmap and prints FrameStats and the kernel's
    visit counters (its plain version here)."""
    out = tmp_path / "s"
    assert app.main(["proc:sphere?level=2,subdivisions=0", "--width", "64",
                     "--height", "32", "--device", "cpu", "--stats",
                     "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "traversal_steps_total" in text and "kernel visits:" in text
    assert "spans:" in text and "rtmm.tile_trace.render_frame" in text
    hm = image_io.read_png(str(out / "heatmap_0000.png"))
    assert hm.shape == (32, 64, 3) and hm.max() > 0


def _flag_pipeline_ray(tmp_path, monkeypatch, capsys):
    """The per-ray frame equals the tile backend's within 1e-3, at most
    one u8 step after quantization."""
    frames = []
    for pipeline in ("ray", "tile"):
        out = tmp_path / pipeline
        assert app.main(["proc:sphere?level=2,subdivisions=0", "--width",
                         "64", "--height", "32", "--device", "cpu",
                         "--pipeline", pipeline, "--out", str(out)]) == 0
        frames.append(image_io.read_png(str(out / "frame_0000.png")))
    diff = np.abs(frames[0].astype(int) - frames[1].astype(int))
    assert int(diff.max()) <= 1
    assert len(np.unique(frames[0].reshape(-1, 3), axis=0)) > 1


@pytest.mark.parametrize("flag", [_flag_cache, _flag_dump_bary, _flag_stats,
                                  _flag_pipeline_ray],
                         ids=["cache", "dump-bary", "stats", "pipeline-ray"])
def test_cli_flags_work(flag, tmp_path, monkeypatch, capsys):
    flag(tmp_path, monkeypatch, capsys)


def test_compare_t_oracle(capsys):
    rc = app.main(["proc:sphere?level=2,subdivisions=0", "--width", "64",
                   "--height", "32", "--device", "cpu", "--compare-t"])
    assert rc == 0
    assert "PASS" in capsys.readouterr().out


def test_cli_pathtrace_writes_frame(tmp_path, capsys):
    out = tmp_path / "pt"
    rc = app.main(["proc:sphere?level=2,subdivisions=0", "--width", "48",
                   "--height", "32", "--device", "cpu", "--pathtrace", "1",
                   "--spp", "1", "--stats", "--out", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "live rays/bounce" in text and "1 bounces, 1 spp" in text
    assert "spans:" in text and "rtmm.path_trace" in text
    img = image_io.read_png(str(out / "frame_0000.png"))
    assert img.shape == (32, 48, 3)
    assert (np.abs(img.astype(int) - 74).max(-1) > 2).sum() > 50


def test_cli_pipeline_tile_renders(tmp_path):
    """--pipeline tile (the XLA tile backend) renders the frame of the
    tile kernel's plain version."""
    frames = []
    for pipeline in ("tile", "auto"):
        out = tmp_path / pipeline
        assert app.main(["proc:sphere?level=2,subdivisions=0", "--width",
                         "64", "--height", "32", "--device", "cpu",
                         "--pipeline", pipeline, "--out", str(out)]) == 0
        frames.append(image_io.read_png(str(out / "frame_0000.png")))
    diff = np.abs(frames[0].astype(int) - frames[1].astype(int)).max(-1)
    assert int((diff > 1).sum()) <= 3, int((diff > 1).sum())
