"""Tiled path (cull + Triton window walk in interpret mode) vs the jnp
oracle on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp

from simple_raytracer.config import default_config, CameraConfig
from simple_raytracer.accel.prepared import prepare
from simple_raytracer.kernels import tiled
from simple_raytracer.ops.camera import primary_rays
from simple_raytracer.render.renderer import (render, brute_force_hits,
                                                  brute_force_shadow)
from simple_raytracer.scene.generated import cube_mesh, uv_sphere_mesh
from simple_raytracer.scene.scene import SceneManager
import simple_raytracer.scene.transforms as T

from conftest import INTERPRET


def _scene(two_objects=False):
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
            "sphere", T.translate((-10.0, -15.0, 60.0)) @ T.scale(6.0, 6.0, 6.0))
    return sm.build()


def _tiled_cfg(**kw):
    return default_config().replace(mode="tiled", kernel=INTERPRET, **kw)


def test_cull_blocks_is_conservative():
    scene = _scene(two_objects=True)
    prep = prepare(scene, _tiled_cfg())
    o, d = primary_rays(64, 32)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    tile = 256
    lo, cnt = jax.jit(
        lambda o, d, bm, bx: tiled.cull_blocks(o, d, tile, bm, bx))(
            o, d, prep.block_min, prep.block_max)
    lo, cnt = np.asarray(lo), np.asarray(cnt)

    # oracle: per-ray brute force against every block's triangles
    t_ref, idx_ref = jax.jit(lambda s, o, d: brute_force_hits(s, o, d))(
        prep.scene, o, d)
    idx_ref = np.asarray(idx_ref)
    assert (idx_ref >= 0).sum() > 200           # the scene is in view
    bs = prep.block_size
    n = o.shape[0] // tile
    for ti in range(n):
        vis = set(range(lo[ti], lo[ti] + cnt[ti]))
        hit_idx = idx_ref[ti * tile:(ti + 1) * tile]
        hit_blocks = set((hit_idx[hit_idx >= 0] // bs).tolist())
        assert hit_blocks <= vis, \
            f"tile {ti}: hit blocks {hit_blocks - vis} were culled"


def test_tiled_hits_match_bruteforce():
    scene = _scene(two_objects=True)
    prep = prepare(scene, _tiled_cfg())
    o, d = primary_rays(64, 32)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)

    t_ref, idx_ref = jax.jit(lambda s, o, d: brute_force_hits(s, o, d))(
        prep.scene, o, d)
    t_k, idx_k = jax.jit(lambda p, o, d: tiled.hits(
        p, o, d, 256, 1e-12, kernel=INTERPRET))(prep, o, d)

    assert np.isfinite(np.asarray(t_ref)).sum() > 200
    np.testing.assert_allclose(np.asarray(t_ref), np.asarray(t_k),
                               rtol=1e-4, atol=1e-6)
    same = np.asarray(idx_ref) == np.asarray(idx_k)
    assert same.mean() > 0.999, f"idx mismatch fraction {1 - same.mean()}"


def test_tiled_render_matches_bruteforce_image():
    scene = _scene(two_objects=True)
    cam = CameraConfig(width=64, height=32)
    cfg_bf = default_config().replace(mode="bruteforce", camera=cam)
    cfg_tl = _tiled_cfg(camera=cam)
    light = jnp.array([500.0, -300.0, -200.0], jnp.float32)

    img_bf = np.asarray(render(scene, cfg_bf, light))
    img_tl = np.asarray(render(scene, cfg_tl, light))
    diff = np.abs(img_bf.astype(int) - img_tl.astype(int))
    assert (diff <= 1).mean() > 0.999, f"max diff {diff.max()}"
    assert (diff == 0).mean() > 0.98


def test_tiled_shadow_matches_bruteforce():
    scene = _scene(two_objects=True)
    prep = prepare(scene, _tiled_cfg())
    o, d = primary_rays(32, 16)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t, idx = jax.jit(lambda s, o, d: brute_force_hits(s, o, d))(prep.scene, o, d)
    point = np.asarray(o + np.asarray(t)[:, None] * np.asarray(d))
    hitm = np.isfinite(np.asarray(t))
    point = jnp.asarray(np.where(hitm[:, None], point, 0.0))
    self_obj = prep.scene.tri_obj[jnp.maximum(idx, 0)]
    light = jnp.broadcast_to(jnp.array([500.0, -300.0, -200.0]), point.shape)

    ref = jax.jit(brute_force_shadow(prep.scene))(point, light, self_obj)
    fn = tiled.tiled_shadow_fn(prep, 256, 1e-12, kernel=INTERPRET)
    got = jax.jit(fn)(point, light, self_obj)
    assert hitm.sum() > 50
    np.testing.assert_array_equal(np.asarray(ref)[hitm], np.asarray(got)[hitm])


def test_tile_chunking_matches_unchunked():
    """The walk tests each window in [tile, chunk] blocks of pairs; any
    chunk width that divides the window gives identical hits."""
    import dataclasses
    scene = _scene(two_objects=True)
    prep = prepare(scene, _tiled_cfg())
    o, d = primary_rays(64, 32)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    window = INTERPRET.window_blocks * prep.block_size
    outs = []
    for chunk in (window, 16, 8):
        k = dataclasses.replace(INTERPRET, chunk=chunk)
        outs.append(jax.jit(lambda p, o, d: tiled.hits(
            p, o, d, 256, 1e-12, kernel=k))(prep, o, d))
    for t, i in outs[1:]:
        np.testing.assert_array_equal(np.asarray(outs[0][0]), np.asarray(t))
        np.testing.assert_array_equal(np.asarray(outs[0][1]), np.asarray(i))


def test_soft_shadow_folded_matches_bruteforce():
    """S>1 routes through the folded shadow path (one plan per point tile,
    samples as extra kernel rows); pixels must match the bruteforce
    oracle."""
    from simple_raytracer.config import LightConfig
    scene = _scene(two_objects=True)
    cam = CameraConfig(width=64, height=32)
    light_cfg = LightConfig(enable_shadows=True, num_samples=4)
    cfg_bf = default_config().replace(mode="bruteforce", camera=cam,
                                      light=light_cfg)
    cfg_tl = _tiled_cfg(camera=cam, light=light_cfg)
    light = jnp.array([500.0, -300.0, -200.0], jnp.float32)
    img_bf = np.asarray(render(scene, cfg_bf, light))
    img_tl = np.asarray(render(scene, cfg_tl, light))
    diff = np.abs(img_bf.astype(int) - img_tl.astype(int))
    assert (diff <= 1).mean() > 0.999, f"max diff {diff.max()}"
    assert (diff == 0).mean() > 0.98


def test_mixed_hit_miss_tiles_keep_shadows():
    """A miss ray's point = o + inf*d must not poison its tile's shadow cull
    bounds (integrator pins miss points to the origin before the occlusion
    query)."""
    sm = SceneManager()
    sm.add_mesh("ground", cube_mesh())
    sm.set_color("ground", (0.1, 0.8, 0.2))
    sm.transform_triangles("ground", T.scale(8.0, 1.0, 8.0))
    sm.transform_triangles("ground", T.translate((0.0, 6.0, 60.0)))
    sm.add_mesh("s", uv_sphere_mesh())
    sm.set_color("s", (0.9, 0.3, 0.2))
    sm.transform_triangles("s", T.scale(2.5, 2.5, 2.5))
    sm.transform_triangles("s", T.translate((0.0, 1.0, 60.0)))
    scene = sm.build()
    light = jnp.array([500.0, -300.0, -200.0], jnp.float32)
    cam = CameraConfig(width=96, height=64)   # many mixed hit/miss tiles
    img_bf = np.asarray(render(scene, default_config().replace(
        mode="bruteforce", camera=cam), light))
    img_tl = np.asarray(render(scene, _tiled_cfg(camera=cam), light))
    same = (img_bf == img_tl).all(axis=-1)
    assert same.mean() > 0.995, same.mean()
