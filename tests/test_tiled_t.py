"""Tiled path variants (window width, range fallback, walk tile size) vs the
jnp oracle, the Triton walk in interpret mode on the CPU."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from simple_raytracer.config import (default_config, CameraConfig,
                                         LightConfig)
from simple_raytracer.accel.prepared import prepare
from simple_raytracer.kernels import tiled
from simple_raytracer.ops.camera import primary_rays
from simple_raytracer.render.renderer import render, brute_force_hits
from simple_raytracer.scene.generated import cube_mesh, uv_sphere_mesh
from simple_raytracer.scene.scene import SceneManager
import simple_raytracer.scene.transforms as T

from conftest import INTERPRET


def _scene(two_objects=True):
    sm = SceneManager()
    sm.add_mesh("cube", cube_mesh())
    sm.set_color("cube", (0.2, 0.8, 0.3))
    sm.transform_triangles(
        "cube", T.translate((0.0, 5.0, 80.0)) @ T.rotate_y(25.0)
        @ T.scale(15.0, 15.0, 15.0))
    if two_objects:
        sm.add_mesh("sphere", uv_sphere_mesh())
        sm.set_color("sphere", (0.9, 0.9, 0.2))
        sm.transform_triangles(
            "sphere", T.translate((-10.0, -15.0, 60.0))
            @ T.scale(6.0, 6.0, 6.0))
    return sm.build()


@pytest.mark.parametrize("wb", [1, 2, 4])
def test_hits_match_bruteforce(wb):
    kernel = dataclasses.replace(INTERPRET, window_blocks=wb)
    scene = _scene()
    prep = prepare(scene, default_config().replace(mode="tiled",
                                                   kernel=kernel))
    o, d = primary_rays(64, 32)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)

    t_ref, idx_ref = jax.jit(lambda s, o, d: brute_force_hits(s, o, d))(
        prep.scene, o, d)
    t_k, idx_k = jax.jit(lambda p, o, d: tiled.hits(
        p, o, d, 256, 1e-12, kernel=kernel))(prep, o, d)

    assert np.isfinite(np.asarray(t_ref)).sum() > 200
    np.testing.assert_allclose(np.asarray(t_ref), np.asarray(t_k),
                               rtol=1e-4, atol=1e-6)
    same = np.asarray(idx_ref) == np.asarray(idx_k)
    assert same.mean() > 0.999, f"idx mismatch fraction {1 - same.mean()}"


def test_range_fallback_matches_lists():
    scene = _scene()
    prep = prepare(scene, default_config().replace(mode="tiled"))
    o, d = primary_rays(64, 32)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t_l, idx_l = jax.jit(lambda p, o, d: tiled.hits(
        p, o, d, 256, 1e-12, maxv=248, kernel=INTERPRET))(prep, o, d)
    t_r, idx_r = jax.jit(lambda p, o, d: tiled.hits(
        p, o, d, 256, 1e-12, maxv=0, kernel=INTERPRET))(prep, o, d)
    assert np.isfinite(np.asarray(t_l)).sum() > 200
    np.testing.assert_array_equal(np.asarray(t_l), np.asarray(t_r))
    np.testing.assert_array_equal(np.asarray(idx_l), np.asarray(idx_r))


def test_render_matches_bruteforce_image():
    scene = _scene()
    cam = CameraConfig(width=64, height=32)
    cfg_bf = default_config().replace(mode="bruteforce", camera=cam)
    cfg_tl = default_config().replace(mode="tiled", camera=cam,
                                      kernel=INTERPRET)
    light = jnp.array([500.0, -300.0, -200.0], jnp.float32)

    img_bf = np.asarray(render(scene, cfg_bf, light))
    img_tl = np.asarray(render(scene, cfg_tl, light))
    diff = np.abs(img_bf.astype(int) - img_tl.astype(int))
    assert (diff <= 1).mean() > 0.999, f"max diff {diff.max()}"
    assert (diff == 0).mean() > 0.98


def test_shadow_matches_bruteforce():
    """Hard-shadow occlusion through the any-hit walk (incl. the
    self-object skip read from the geometry's object-id row)."""
    scene = _scene()
    prep = prepare(scene, default_config().replace(mode="tiled"))
    o, d = primary_rays(32, 16)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t, idx = jax.jit(lambda s, o, d: brute_force_hits(s, o, d))(
        prep.scene, o, d)
    point = np.asarray(o + np.asarray(t)[:, None] * np.asarray(d))
    hitm = np.isfinite(np.asarray(t))
    point = jnp.asarray(np.where(hitm[:, None], point, 0.0))
    self_obj = prep.scene.tri_obj[jnp.maximum(idx, 0)]
    light = jnp.broadcast_to(jnp.array([500.0, -300.0, -200.0]), point.shape)

    from simple_raytracer.render.renderer import brute_force_shadow
    ref = jax.jit(brute_force_shadow(prep.scene))(point, light, self_obj)
    fn = tiled.tiled_shadow_fn(prep, 128, 1e-12, kernel=INTERPRET)
    got = jax.jit(fn)(point, light, self_obj)
    assert hitm.sum() > 50
    np.testing.assert_array_equal(np.asarray(ref)[hitm], np.asarray(got)[hitm])


def test_soft_shadow_render_matches_bruteforce():
    """Folded multi-sample occlusion through the any-hit walk."""
    scene = _scene()
    cam = CameraConfig(width=48, height=32)
    lcfg = LightConfig(enable_shadows=True, num_samples=4)
    cfg_bf = default_config().replace(mode="bruteforce", camera=cam,
                                      light=lcfg)
    cfg_tl = cfg_bf.replace(mode="tiled", kernel=INTERPRET)
    light = jnp.array([500.0, -300.0, -200.0], jnp.float32)
    img_bf = np.asarray(render(scene, cfg_bf, light))
    img_tl = np.asarray(render(scene, cfg_tl, light))
    diff = np.abs(img_bf.astype(int) - img_tl.astype(int))
    assert (diff <= 1).mean() > 0.999, f"max diff {diff.max()}"


def test_hit_tile_subchunks_match_full_tile():
    """kernel.ray_tile cuts each 16px pixel tile (256 rays) into
    contiguous walk tiles of the tile-major stream; the rendered image must
    be pixel-identical for every walk tile size (same walk, tighter
    per-tile plans)."""
    scene = _scene()
    cam = CameraConfig(width=64, height=48)
    light = jnp.array([500.0, -300.0, -200.0], jnp.float32)
    cfg = default_config().replace(mode="tiled", camera=cam, tile_px=16,
                                   kernel=INTERPRET)
    img_full = np.asarray(render(scene, cfg.replace(
        kernel=dataclasses.replace(INTERPRET, ray_tile=256)), light))
    img_sub = np.asarray(render(scene, cfg, light))
    assert (~np.all(img_full == np.array([173, 216, 230]), -1)).sum() > 200
    assert (img_full == img_sub).all()
