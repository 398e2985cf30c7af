"""Training through the PREPARED fast path (flagship-scale regime).

make_train_step accepts a PreparedScene: the loss then renders through the
configured fast intersector (tiled kernel here) with gradients restored by
the fixed-topology recompute (diff/render.py) — the only feasible form at
flagship scale, where the dense forward is O(rays x triangles).  Pins:
loss descent, exact agreement between single-device / DP-mesh / remat
variants, and that params must come from the PREPARED (padded + reordered)
scene.  Also regression-guards the miss-ray inf-forward NaN (integrator
pins t=0 for misses; gradients were NaN through o + inf*d before).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from simple_raytracer.config import (default_config, CameraConfig,
                                         LightConfig)
from simple_raytracer.dist import (make_mesh, make_train_step,
                                       extract_params)
from simple_raytracer.render.renderer import render_radiance
from simple_raytracer.accel.prepared import prepare
from simple_raytracer.scene.scene import SceneManager
import simple_raytracer.scene.transforms as T
from simple_raytracer.scene.generated import cube_mesh

from conftest import INTERPRET




@pytest.fixture(scope="module")
def setup():
    sm = SceneManager()
    sm.add_mesh("cube", cube_mesh())
    sm.set_color("cube", (0.2, 0.8, 0.3))
    sm.transform_triangles(
        "cube", T.translate((0.0, 5.0, 80.0)) @ T.rotate_y(25.0)
        @ T.scale(15.0, 15.0, 15.0))
    sm.add_mesh("ground", cube_mesh())
    sm.set_color("ground", (0.7, 0.6, 0.2))
    sm.transform_triangles(
        "ground", T.translate((0.0, 24.0, 80.0)) @ T.scale(30.0, 2.0, 30.0))
    scene = sm.build()
    cfg = default_config().replace(
        mode="tiled", kernel=INTERPRET, camera=CameraConfig(width=64, height=32),
        light=LightConfig(enable_shadows=True))
    light = jnp.asarray([500.0, -300.0, -200.0], jnp.float32)
    prep = prepare(scene, cfg)
    target, hit = render_radiance(prep, cfg, light)
    target = jnp.where(hit[..., None], target, 0.0)
    return prep, cfg, light, target


def _run(step, prep, light, n=5):
    params = extract_params(prep.scene, light)   # the PADDED/REORDERED scene
    params = dataclasses.replace(params, obj_color=params.obj_color * 0.7)
    losses = []
    for _ in range(n):
        params, loss = step(params, _run.target)
        losses.append(float(loss))
    return losses


def test_prepared_train_step_descends_and_matches(setup):
    prep, cfg, light, target = setup
    _run.target = target
    single = _run(make_train_step(prep, cfg, lr=1e-3), prep, light)
    assert all(np.isfinite(single)), single       # the miss-ray NaN guard
    assert single[-1] < single[0], single

    mesh = _run(make_train_step(prep, cfg, mesh=make_mesh(4, ("dp",)),
                                lr=1e-3), prep, light)
    remat = _run(make_train_step(prep, cfg, lr=1e-3, remat=True),
                 prep, light)
    np.testing.assert_allclose(single, mesh, rtol=1e-6)
    np.testing.assert_allclose(single, remat, rtol=1e-6)


def test_pad_band_rays_do_not_shift_loss_optimum(setup):
    """primary_rays_tiled pads ragged frames with REAL out-of-frame rays
    that can hit geometry (the ground slab here); the train loss masks that
    pad band, so the loss at the GROUND-TRUTH parameters must be ~0 even
    when width/height are not tile multiples (64x32 at 64px tiles pads 32
    rows).  Regression: before the mask, pred carried nonzero radiance
    against zero-padded target rows (measured loss 0.0061 at truth)."""
    prep, cfg, light, target = setup
    step = make_train_step(prep, cfg, lr=0.0)     # lr 0: params untouched
    params = extract_params(prep.scene, light)
    _, loss = step(params, target)
    assert float(loss) < 1e-10, float(loss)
