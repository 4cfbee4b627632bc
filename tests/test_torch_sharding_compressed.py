"""The tile-sharded path on compressed scenes: render_tiled_sharded
(backend="pallas") on a 2 x 2 mesh, each shard deriving its local units'
tables from their records (K1b + K1c; on the CPU the plain version),
against the JAX package's interpret-mode Pallas path on the same mesh and
the very same tables. Tolerance as tests/test_parallel.py allows the JAX
package against itself: at most 5 pixels over 1e-4 (0 expected).
"""
import pytest
import torch

from rtmm_tpu.models import procedural as jproc
from rtmm_tpu.models import scene as jscene
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.models import scene as scene_mod
from rtmm_tpu_torch.parallel import entry, launch
from test_torch_sharding import jax_arrays, same_on_every_rank
from test_torch_sharding_kernel import CFG, diverging, jax_sharded, tile_job

torch.set_num_threads(1)

MIXED = (False, True)


@pytest.fixture(scope="module")
def planes():
    """mixed -> (JAX scene, port frames of its 4 ranks): the compressed
    level-2 plane of tests/test_parallel.py, uniform and stitched
    mixed-level (indexed records either way), both rendered by one world
    of four ranks."""
    ds = {mixed: jscene.build_device_scene(
        jproc.make_plane(grid=(2, 2), level=2, amplitude=0.15,
                         mixed_levels=mixed), compressed=True)
        for mixed in MIXED}
    arrays = {str(m): scene_mod.scene_arrays(scene_mod.scene_from_arrays(
        jax_arrays(d), device="cpu")) for m, d in ds.items()}
    cfg = RenderConfig(**CFG)
    results = launch.spawn(entry.render_jobs, 4, "cpu", args=(arrays, [
        tile_job((2, 2), cfg, scene=str(m)) for m in MIXED]))
    return {m: (ds[m], [r[i] for r in results]) for i, m in enumerate(MIXED)}


@pytest.mark.parametrize("mixed", MIXED)
def test_tiled_sharded_kernel_compressed(planes, mixed):
    """Compressed scenes shard too: unit_grid splits over "scene" and each
    shard derives its local units (K1b + K1c's derive); mixed=True:
    indexed records of a stitched mixed-level mesh."""
    ds, results = planes[mixed]
    assert ds.indexed
    assert {r["chosen"] for r in results} == {("tile-sharded", "pallas")}
    out = same_on_every_rank(results)
    npix = diverging(out, jax_sharded(ds, 2, 2))
    print(f"compressed mixed={mixed} 2x2 against JAX: {npix} pixels over "
          "1e-4")
    assert npix <= 5, f"{npix} pixels diverge"
