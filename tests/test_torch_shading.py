"""The port's shading against the JAX package's, on the CPU.

Seeded random unit normals and view directions. shade_rows, the form the
trace kernel's epilogue uses, agrees to 1e-6. The vector form shade()
(and shade_or_miss) agrees to 1e-5: XLA's CPU compiler contracts its
3-term dot products into fused multiply-adds, and near a specular peak
the GGX lobe amplifies that last-bit difference of n.h several hundred
times (measured up to 5.3e-6 at roughness 0.2, 1.1e-6 at the default
0.45). Colours lie in [0, 1].
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.config import RenderConfig as JaxConfig
from rtmm_tpu.ops import shading as jshading
from rtmm_tpu_torch.config import RenderConfig
from rtmm_tpu_torch.ops import shading

# One intra-op thread: the suite runs several pytest workers on one shared
# CPU, and with JAX in the same process the first multi-threaded PyTorch
# op after a JAX computation was seen to compute part of its range wrong
# (about one process in twenty; never single-threaded).
torch.set_num_threads(1)

ATOL = 1e-6
ATOL_VECTOR = 1e-5
N = 4096


def _unit(rng, n):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(params=[0, 1], ids=["seed0", "seed1"])
def inputs(request):
    rng = np.random.default_rng(request.param)
    normal, view = _unit(rng, N), _unit(rng, N)
    # Include the light axes and normals facing away from the view.
    normal[:6] = [[0, 0, 1], [0, 1, 0], [0, 0, -1], [0, -1, 0], [1, 0, 0],
                  [-1, 0, 0]]
    view[6:12] = -normal[6:12]
    hit = rng.random(N) < 0.7
    return normal, view, hit


CONFIGS = [
    (JaxConfig(), RenderConfig()),
    (JaxConfig(metallic=0.8, roughness=0.2, mesh_color=(0.9, 0.3, 0.1),
               background=(0.0, 0.1, 0.2), shading_weight=0.5),
     RenderConfig(metallic=0.8, roughness=0.2, mesh_color=(0.9, 0.3, 0.1),
                  background=(0.0, 0.1, 0.2), shading_weight=0.5)),
]


@pytest.mark.parametrize("cfgs", CONFIGS, ids=["default", "material"])
def test_shade_and_shade_or_miss(inputs, cfgs):
    normal, view, hit = inputs
    jcfg, cfg = cfgs
    want = np.asarray(jshading.shade(jnp.asarray(normal), jnp.asarray(view),
                                     jcfg))
    got = shading.shade(torch.from_numpy(normal), torch.from_numpy(view), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_VECTOR)
    want = np.asarray(jshading.shade_or_miss(
        jnp.asarray(hit), jnp.asarray(normal), jnp.asarray(view), jcfg))
    got = shading.shade_or_miss(torch.from_numpy(hit),
                                torch.from_numpy(normal),
                                torch.from_numpy(view), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_VECTOR)
    np.testing.assert_array_equal(got.numpy()[~hit], np.broadcast_to(
        np.float32(cfg.background), (int((~hit).sum()), 3)))


@pytest.mark.parametrize("cfgs", CONFIGS, ids=["default", "material"])
def test_shade_rows(inputs, cfgs):
    normal, view, hit = inputs
    jcfg, cfg = cfgs
    want = jshading.shade_rows(*(jnp.asarray(normal[:, i]) for i in range(3)),
                               *(jnp.asarray(view[:, i]) for i in range(3)),
                               jnp.asarray(hit), jcfg)
    got = shading.shade_rows(*(torch.from_numpy(normal[:, i].copy())
                               for i in range(3)),
                             *(torch.from_numpy(view[:, i].copy())
                               for i in range(3)),
                             torch.from_numpy(hit), cfg)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
    # The row form and the vector form are the same colours.
    vec = shading.shade_or_miss(torch.from_numpy(hit),
                                torch.from_numpy(normal),
                                torch.from_numpy(view), cfg)
    np.testing.assert_allclose(torch.stack(got, -1).numpy(), vec.numpy(),
                               rtol=0, atol=ATOL)
