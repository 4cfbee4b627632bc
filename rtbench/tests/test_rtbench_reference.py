"""The plain reference against known answers and against the renderer's
plain versions on small scenes (CPU), and against itself on the card."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from rtbench import check, harness
from rtbench.reference import camera, geometry, render, threefry
from rtbench.reference.raycast import RayCaster

RECIPE = {"base": "icosphere", "subdivisions": 0, "level": 3,
          "amplitude": 0.1, "phase": [0, 0, 0, 0]}


def test_threefry_known_answers():
    """Random123's known answers for Threefry-2x32, 20 rounds."""
    def words(k0, k1, x0, x1):
        out = threefry.block(*(torch.tensor(v) for v in (k0, k1, x0, x1)))
        return [int(w) for w in out]

    assert words(0, 0, 0, 0) == [0x6B200159, 0x99BA4EFE]
    assert words(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF) == [
        0x1CB996FC, 0xBB002BE7]
    assert words(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3) == [
        0xC4923A9C, 0x483DF7A0]


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 1])
def test_draw_matches_renderer(seed):
    from rtmm_tpu_torch.ops import path_shade
    from rtmm_tpu_torch.utils import threefry as port_threefry
    lanes = torch.arange(0, 5000, 7, dtype=torch.int32)
    for bounce in (0, 1, 2):
        want = path_shade.rand2(port_threefry.key(seed), bounce, lanes, 2048)
        got = threefry.draw(seed, bounce, lanes, 2048)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _arrays(recipe):
    return geometry.scene_arrays(recipe, harness.base_arrays(recipe))


def test_tessellation_matches_renderer_mesh():
    from rtmm_tpu_torch.models import procedural
    arrays = _arrays(RECIPE)
    mesh = procedural.make_icosphere(subdivisions=0, level=3,
                                     amplitude=0.1, height_fn=arrays["height"])
    ref = arrays["vertices"].reshape(len(mesh.triangles), -1, 3)
    for t, r in zip(mesh.triangles, ref):
        np.testing.assert_array_equal(t.u_positions + t.u_displacements, r)


def _port_scene(recipe):
    from rtmm_tpu_torch.models import procedural, scene
    height = geometry.HeightField(recipe["amplitude"], recipe["phase"])
    mesh = procedural.make_icosphere(
        subdivisions=recipe["subdivisions"], level=recipe["level"],
        amplitude=recipe["amplitude"], height_fn=height)
    return scene.build_device_scene(mesh, device="cpu")


def _all_pixels(width, height):
    py, px = torch.meshgrid(torch.arange(height), torch.arange(width),
                            indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def test_oracle_matches_plain_primary_frames():
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.render.renderer import _quantize
    w, h = 96, 72
    ivps = camera.inv_view_projs(-30.0, np.array([25.0, 140.0]), 2.2, w, h)
    frames = _quantize(tile_trace.render_frames(
        _port_scene(RECIPE), torch.from_numpy(ivps),
        RenderConfig(width=w, height=h)))
    caster = RayCaster(**_geometry(RECIPE), device="cpu")
    px, py = _all_pixels(w, h)
    for f in range(2):
        want = render.primary_pixels(caster, torch.from_numpy(ivps[f]), px,
                                     py, w, h)
        got = frames[f].reshape(-1, 3)
        assert int((got != 74).any(-1).sum()) > w * h // 10   # covered
        assert check.numbers(got, want)["px_over_2"] == 0.0


def _geometry(recipe):
    arrays = _arrays(recipe)
    return {"vertices": arrays["vertices"], "triangles": arrays["triangles"]}


@pytest.mark.parametrize("engine", ["pallas", "grouped"])
def test_oracle_matches_plain_path_tracer(engine):
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.render.pathtrace import PathTraceConfig, PathTracer
    from rtmm_tpu_torch.render.renderer import _quantize
    w, h, seed = 48, 48, 987654321
    ivp = camera.inv_view_projs(-30.0, 60.0, 2.2, w, h)[0]
    tracer = PathTracer(_port_scene(RECIPE),
                        RenderConfig(width=w, height=h, sub_frusta=8),
                        PathTraceConfig(bounces=3, samples_per_pixel=2,
                                        seed=seed, engine=engine))
    img, stats = tracer.render(ivp)
    got = _quantize(img).reshape(-1, 3)
    caster = RayCaster(**_geometry(RECIPE), device="cpu")
    px, py = _all_pixels(w, h)
    want, rehit = render.pathtrace_pixels(
        caster, torch.from_numpy(ivp), px, py, w, h, 2, 3, seed,
        1024 * ((w * h + 1023) // 1024))
    assert float(stats["live_rays_per_bounce"][1]) > 0
    assert int(rehit.sum()) > 0
    got_numbers = check.numbers(got, want, {"bounce": rehit})
    assert got_numbers["px_over_2"] == 0.0
    assert got_numbers["px_over_2.bounce"] == 0.0


def test_bfloat16_reference_is_far_off():
    """The control's precision moves pixels well past the limits."""
    w, h = 96, 72
    ivp = torch.from_numpy(camera.inv_view_projs(-30.0, 25.0, 2.2, w, h)[0])
    px, py = _all_pixels(w, h)
    geo = _geometry(RECIPE)
    want = render.primary_pixels(RayCaster(**geo, device="cpu"), ivp, px, py,
                                 w, h)
    low = render.primary_pixels(
        RayCaster(**geo, device="cpu", dtype=torch.bfloat16), ivp, px, py,
        w, h)
    assert check.numbers(low, want)["px_over_2"] > 0.05


@pytest.mark.gpu
def test_oracle_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, h = 160, 120
    ivp = torch.from_numpy(camera.inv_view_projs(-30.0, 25.0, 2.2, w, h)[0])
    px, py = _all_pixels(w, h)
    geo = _geometry(RECIPE)
    cpu = render.primary_pixels(RayCaster(**geo, device="cpu"), ivp, px, py,
                                w, h)
    card = render.primary_pixels(RayCaster(**geo, device="cuda"), ivp, px,
                                 py, w, h)
    assert check.numbers(card.cpu(), cpu)["px_over_2"] == 0.0
