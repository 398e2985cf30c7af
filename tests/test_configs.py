"""The five BASELINE.json benchmark configs as (scaled-down) golden tests.

Each config renders through at least two independent implementations
(bruteforce jnp oracle vs BVH vs the tiled walk) and must agree
pixel-for-pixel (minus rare quantization flips at fp-tie edges).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from simple_raytracer.config import (default_config, CameraConfig,
                                         LightConfig)
from simple_raytracer.render.renderer import render
from simple_raytracer.scene.scene import SceneManager
from simple_raytracer.scene import catalog
import simple_raytracer.scene.transforms as T
from simple_raytracer.scene.generated import (blob_mesh, cube_mesh,
                                                  leaf_texture,
                                                  set_planar_texture,
                                                  uv_sphere_mesh)

from conftest import INTERPRET

LIGHT = jnp.array([500.0, -300.0, -200.0], jnp.float32)


def _agree(img_a, img_b, frac=0.995):
    same = (img_a == img_b).all(axis=-1)
    assert same.mean() > frac, f"pixel agreement {same.mean():.4f}"


def test_config1_sphere_phong():
    """Config 1: single sphere + 1 point light, Phong, no BVH needed."""
    sm = SceneManager()
    sm.add_mesh("s", uv_sphere_mesh())
    sm.transform_triangles("s", T.translate((0.0, 6.0, 30.0))
                           @ T.scale(3.0, 3.0, 3.0))
    scene = sm.build()
    cam = CameraConfig(width=128, height=128)
    img_bf = np.asarray(render(scene, default_config().replace(
        mode="bruteforce", camera=cam), LIGHT))
    img_bvh = np.asarray(render(scene, default_config().replace(
        mode="bvh", camera=cam), LIGHT))
    _agree(img_bf, img_bvh)
    bg = np.all(img_bf == np.array([173, 216, 230]), axis=-1)
    assert 0.01 < (~bg).mean() < 0.9      # sphere visible, not full-screen


def test_config2_textured_mesh():
    """Config 2: texture-mapped mesh with baked texel UVs (a sphere with the
    seeded foliage texture, the stand-in for the reference's oak tree)."""
    sm = SceneManager()
    sm.add_mesh("tree", uv_sphere_mesh())
    set_planar_texture(sm, "tree", "leaves", leaf_texture(), axes=(0, 1))
    sm.transform_triangles("tree", T.scale(6.0, 6.0, 6.0))
    sm.transform_triangles("tree", T.translate((0.0, 3.0, 40.0)))
    scene = sm.build()
    assert int(np.asarray(scene.tri_tex).max()) >= 0    # textured tris exist
    cam = CameraConfig(width=96, height=96)
    cfg_bf = default_config().replace(mode="bruteforce", camera=cam)
    cfg_tl = default_config().replace(mode="tiled", camera=cam,
                                      kernel=INTERPRET)
    img_bf = np.asarray(render(scene, cfg_bf, LIGHT))
    img_tl = np.asarray(render(scene, cfg_tl, LIGHT))
    diff = np.abs(img_bf.astype(int) - img_tl.astype(int))
    assert (diff <= 1).mean() > 0.995
    # texture variation: many distinct colors on the mesh
    bg = np.all(img_bf == np.array([173, 216, 230]), axis=-1)
    colors = {tuple(c) for c in img_bf[~bg][::7]}
    assert len(colors) > 20, f"only {len(colors)} distinct colors"


def test_config3_bunny_bvh_shadows():
    """Config 3: the bunny stand-in (81,920 triangles) with BVH traversal +
    hard shadows."""
    sm = SceneManager()
    sm.add_mesh("bunny", blob_mesh())
    sm.set_color("bunny", (0.9, 0.9, 0.9))
    # the blob has radius ~1; at 4x it is ~8 units tall, centred in the
    # small frustum (visible y at z=60 is about +-7), resting on the ground
    sm.transform_triangles("bunny", T.scale(4.0, 4.0, 4.0))
    sm.transform_triangles("bunny", T.rotate_y(float(np.radians(180.0))))
    sm.transform_triangles("bunny", T.translate((0.0, 1.0, 60.0)))
    # ground slab below (image +y is down) so the bunny shadows something
    sm.add_mesh("ground", cube_mesh())
    sm.set_color("ground", (0.0, 1.0, 0.0))
    sm.transform_triangles("ground", T.scale(35.0, 1.5, 35.0))
    sm.transform_triangles("ground", T.translate((0.0, 7.0, 60.0)))
    scene = sm.build()
    cam = CameraConfig(width=96, height=96)
    cfg_bvh = default_config().replace(mode="bvh", camera=cam)
    cfg_tl = default_config().replace(mode="tiled", camera=cam,
                                      kernel=INTERPRET)
    img_bvh = np.asarray(render(scene, cfg_bvh, LIGHT))
    img_tl = np.asarray(render(scene, cfg_tl, LIGHT))
    diff = np.abs(img_bvh.astype(int) - img_tl.astype(int))
    assert (diff <= 1).mean() > 0.995
    bg = np.all(img_bvh == np.array([173, 216, 230]), axis=-1)
    assert (~bg).mean() > 0.1
    # hard shadows change the image
    img_ns = np.asarray(render(scene, cfg_bvh.replace(
        light=LightConfig(enable_shadows=False)), LIGHT))
    assert (img_ns != img_bvh).any()


def test_config4_soft_shadows_multiobject():
    """Config 4: multi-object scene, soft shadows (multi-sample) + tone map.
    The cumulative-jitter sampling (simple_raytracer.cpp:362-383) and /5
    dimming (:369) must agree between oracle and BVH."""
    sm = SceneManager()
    sm.add_mesh("ground", cube_mesh())
    sm.set_color("ground", (0.0, 1.0, 0.0))
    sm.transform_triangles("ground", T.scale(20.0, 3.0, 20.0))
    sm.transform_triangles("ground", T.translate((0.0, 18.0, 60.0)))
    sm.add_mesh("s", uv_sphere_mesh())
    sm.set_color("s", (0.9, 0.3, 0.2))
    sm.transform_triangles("s", T.scale(3.0, 3.0, 3.0))
    sm.transform_triangles("s", T.translate((0.0, 5.0, 60.0)))
    scene = sm.build()
    cam = CameraConfig(width=96, height=64)
    light_cfg = LightConfig(num_samples=4)
    cfg_bf = default_config().replace(mode="bruteforce", camera=cam,
                                      light=light_cfg)
    cfg_bvh = default_config().replace(mode="bvh", camera=cam,
                                       light=light_cfg)
    img_bf = np.asarray(render(scene, cfg_bf, LIGHT))
    img_bvh = np.asarray(render(scene, cfg_bvh, LIGHT))
    _agree(img_bf, img_bvh)
    # soft shadows: with 4 samples there must be penumbra pixels whose value
    # differs from the 1-sample render
    cfg_1 = cfg_bf.replace(light=LightConfig(num_samples=1))
    img_1 = np.asarray(render(scene, cfg_1, LIGHT))
    assert (img_1 != img_bf).any()


def test_config5_animated_sweep_sharded():
    """Config 5: animated camera sweep, frames sharded over the device mesh
    (frame-parallel PP mode); each frame equals its serial render."""
    from simple_raytracer.driver.animation import frames_parallel
    from simple_raytracer.dist import make_mesh
    sm, _, light = catalog.four_cubes(0.0, bake_view=False)
    scene = sm.build()
    cfg = default_config().replace(camera=CameraConfig(width=48, height=32))
    angles = np.arange(0.0, 360.0, 45.0)
    views = np.stack([catalog.orbit_view(a, 100.0, 0.0, 0.0) for a in angles])
    mesh = make_mesh(8, ("pp",))
    imgs = np.asarray(frames_parallel(scene, cfg, views, light, mesh))
    assert imgs.shape == (8, 32, 48, 3)
    ref = np.asarray(render(scene, cfg, light, view_matrix=views[5]))
    np.testing.assert_array_equal(ref, imgs[5])
