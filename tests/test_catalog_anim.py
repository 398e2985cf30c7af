"""Scene catalog + animation driver tests: world-space camera vs the
reference's inverse-view bake, turntable sweep, frame-parallel mode, BMP."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from simple_raytracer.config import (default_config, AnimationConfig,
                                         CameraConfig)
from simple_raytracer.driver.animation import (render_turntable,
                                                   frames_parallel)
from simple_raytracer.dist import make_mesh
from simple_raytracer.io.image import write_bmp
from simple_raytracer.render.renderer import render
from simple_raytracer.scene import catalog

CAM = CameraConfig(width=60, height=40)


def test_world_space_camera_matches_bake():
    """A rigid view transform must not change the image: rendering the baked
    (view-space) scene with the origin camera == rendering the world-space
    scene with transformed rays.  (This is the correctness proof for the
    static-BVH animation fast path.)"""
    angle = 40.0
    cfg = default_config().replace(camera=CAM)

    sm_b, _, light_b = catalog.four_cubes(angle, bake_view=True)
    img_bake = np.asarray(render(sm_b.build(), cfg, light_b))

    sm_w, view, light_w = catalog.four_cubes(angle, bake_view=False)
    img_world = np.asarray(render(sm_w.build(), cfg, light_w,
                                  view_matrix=view))

    same = (img_bake == img_world).all(axis=-1)
    # fp differences along silhouette edges can flip isolated quantized
    # pixels; demand near-exact agreement
    assert same.mean() > 0.995, f"pixel agreement {same.mean()}"


def test_one_cube_scene_has_default_red():
    sm, view, light = catalog.one_cube(0.0, bake_view=False)
    assert sm.get_color("cube") == (1.0, 0.0, 0.0)      # Object.cpp:29 default
    scene = sm.build()
    assert scene.num_triangles == 12


def test_instance_color_not_copied():
    """Reference quirk: instanced keys default to black objColors
    (simple_raytracer.cpp:573-574 copies only triangles+properties)."""
    sm, _, _ = catalog.complex_scene(0.0, bake_view=False)
    assert sm.get_color("tree1") == (0.0, 0.0, 0.0)
    assert sm.objects["tree1"].specular == 0.0          # properties copied


def test_turntable_sweep_and_resume(tmp_path):
    cfg = default_config().replace(camera=CAM)
    anim = AnimationConfig(start_deg=0.0, stop_deg=360.0, step_deg=120.0,
                           orbit_radius=100.0, camera_y=0.0, pitch_deg=0.0)
    out = str(tmp_path / "gen")
    files = render_turntable("four_cubes", cfg, anim, out_dir=out,
                             fmt="bmp", metrics_path=str(tmp_path / "m.jsonl"))
    assert len(files) == 3
    assert all(os.path.exists(f) for f in files)
    mtimes = {f: os.path.getmtime(f) for f in files}
    # resume: nothing re-rendered
    files2 = render_turntable("four_cubes", cfg, anim, out_dir=out,
                              fmt="bmp")
    assert files2 == files
    assert all(os.path.getmtime(f) == mtimes[f] for f in files)


def test_frame_parallel_matches_serial():
    cfg = default_config().replace(camera=CAM)
    sm, _, light = catalog.four_cubes(0.0, bake_view=False)
    scene = sm.build()
    angles = [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0, 315.0]
    views = np.stack([catalog.orbit_view(a, 100.0, 0.0, 0.0) for a in angles])

    mesh = make_mesh(8, ("pp",))
    imgs = np.asarray(frames_parallel(scene, cfg, views, light, mesh))
    for k in (0, 3, 7):
        ref = np.asarray(render(scene, cfg, light, view_matrix=views[k]))
        np.testing.assert_array_equal(ref, imgs[k])


def test_bmp_writer_roundtrip(tmp_path):
    img = (np.arange(31 * 17 * 3) % 251).reshape(17, 31, 3).astype(np.uint8)
    p = str(tmp_path / "x.bmp")
    write_bmp(p, img)
    from PIL import Image
    back = np.asarray(Image.open(p).convert("RGB"))
    np.testing.assert_array_equal(img, back)


def test_complex_scene_end_to_end():
    """The reference's ACTIVE scene (simple_raytracer.cpp:553-618): ground
    cube + bunny stand-in + 3 textured trees (canopy + trunk), world-space
    camera, BVH, hard shadows."""
    # 0 degrees: the narrow 90x60 view (focal 400) sees a tree and the
    # bunny stand-in with its shadow
    sm, view, light = catalog.complex_scene(0.0, bake_view=False)
    scene = sm.build()
    assert scene.num_objects == 8          # cube + bunny + 3 x (trunk, tree)
    assert scene.num_triangles > 80_000
    assert scene.has_textures
    cfg = default_config().replace(
        mode="bvh", camera=CameraConfig(width=90, height=60))
    img = np.asarray(render(scene, cfg, light, view_matrix=view))
    bg = np.all(img == np.array([173, 216, 230]), axis=-1)
    assert (~bg).mean() > 0.5              # ground+trees dominate the frame
    # textured trees: many distinct colors
    colors = {tuple(c) for c in img[~bg][::5]}
    assert len(colors) > 30
    # shadows darken part of the ground
    img_ns = np.asarray(render(
        scene, cfg.replace(light=cfg.light.__class__(enable_shadows=False)),
        light, view_matrix=view))
    assert img_ns.sum() > img.sum()


def test_frames_batched_chunking(monkeypatch):
    """Sweeps larger than FRAMES_PER_SWEEP split into fixed-size device
    programs; results must equal per-frame renders."""
    from simple_raytracer.driver import animation as anim_mod
    sm, _, light = catalog.four_cubes(0.0, bake_view=False)
    scene = sm.build()
    cfg = default_config().replace(camera=CameraConfig(width=48, height=32))
    angles = [0.0, 30.0, 60.0, 90.0, 120.0]
    views = np.stack([catalog.orbit_view(a, 100.0, 0.0, 0.0) for a in angles])
    monkeypatch.setattr(anim_mod, "FRAMES_PER_SWEEP", 2)   # 5 -> 3 chunks
    imgs = np.asarray(anim_mod.frames_batched(scene, cfg, views, light))
    assert imgs.shape == (5, 32, 48, 3)
    for k in (0, 2, 4):
        ref = np.asarray(render(scene, cfg, light, view_matrix=views[k]))
        np.testing.assert_array_equal(ref, imgs[k])
