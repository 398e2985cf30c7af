"""Numerical-safety tests (SURVEY.md §5 sanitizer row): NaN-free renders under
jax debug_nans, smooth-normal path, degenerate-geometry robustness."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from simple_raytracer.config import default_config, CameraConfig, ShadingConfig
from simple_raytracer.render.renderer import render, render_radiance
from simple_raytracer.scene.scene import SceneManager
import simple_raytracer.scene.transforms as T
from simple_raytracer.scene.generated import cube_mesh, uv_sphere_mesh

from conftest import INTERPRET



LIGHT = jnp.array([500.0, -300.0, -200.0], jnp.float32)


def _sphere_scene():
    sm = SceneManager()
    sm.add_mesh("s", uv_sphere_mesh())
    sm.transform_triangles("s", T.translate((0.0, 4.0, 30.0))
                           @ T.scale(2.5, 2.5, 2.5))
    return sm.build()


def test_radiance_is_finite_on_hits():
    scene = _sphere_scene()
    cfg = default_config().replace(camera=CameraConfig(width=64, height=64))
    rad, hit = render_radiance(scene, cfg, LIGHT)
    rad, hit = np.asarray(rad), np.asarray(hit)
    assert np.isfinite(rad[hit]).all()


def test_smooth_normals_differ_from_flat():
    """The sphere carries vertex normals; the smooth path (the reference's
    commented-out interpolateNormal, simple_raytracer.cpp:132-140) must
    produce a smoother sphere than flat facets."""
    scene = _sphere_scene()
    cam = CameraConfig(width=64, height=64)
    cfg_flat = default_config().replace(camera=cam)
    cfg_smooth = cfg_flat.replace(
        shading=ShadingConfig(smooth_normals=True))
    img_f = np.asarray(render(scene, cfg_flat, LIGHT))
    img_s = np.asarray(render(scene, cfg_smooth, LIGHT))
    assert (img_f != img_s).any()
    # facets produce repeated identical shades along each triangle; the
    # smooth image should have MORE distinct colors on the sphere
    bg = np.array([173, 216, 230])
    mf = ~np.all(img_f == bg, axis=-1)
    colors_f = len({tuple(c) for c in img_f[mf]})
    colors_s = len({tuple(c) for c in img_s[mf]})
    assert colors_s > colors_f


def test_degenerate_triangles_never_hit():
    """Zero-area triangles (det ~ 0) must be rejected by the epsilon guard,
    not produce NaN/garbage hits — this is what makes the padding scheme in
    accel/prepared.py safe."""
    sm = SceneManager()
    sm.add_mesh("c", cube_mesh())
    sm.transform_triangles("c", T.translate((0.0, 0.0, 40.0)) @ T.scale(5, 5, 5))
    scene = sm.build()
    # collapse every triangle to its first vertex
    v = np.asarray(scene.verts).copy()
    v[:, 1] = v[:, 0]
    v[:, 2] = v[:, 0]
    degenerate = scene.replace(verts=jnp.asarray(v))
    cfg = default_config().replace(camera=CameraConfig(width=32, height=32))
    rad, hit = render_radiance(degenerate, cfg, LIGHT)
    assert not np.asarray(hit).any()


def test_render_under_debug_nans():
    """The full pipeline must not produce intermediate NaNs on hit paths that
    XLA would silently mask (jax_debug_nans raises on any NaN production).

    Miss lanes legitimately produce inf-inf style garbage after the
    min-reduction, so this runs on a fully-covered frame (sphere fills it).
    """
    sm = SceneManager()
    sm.add_mesh("c", cube_mesh())
    sm.set_color("c", (0.3, 0.5, 0.9))
    sm.transform_triangles("c", T.translate((0.0, 0.0, 30.0)) @ T.scale(20, 20, 20))
    scene = sm.build()
    cfg = default_config().replace(camera=CameraConfig(width=16, height=16))
    rad, hit = render_radiance(scene, cfg, LIGHT)
    assert np.asarray(hit).all()          # cube covers the whole frame
    with jax.debug_nans(True):
        rad, hit = jax.jit(lambda s, l: render_radiance(s, cfg, l))(
            jax.device_put(scene), LIGHT)
        np.asarray(rad)


def test_empty_scene_renders_background():
    """Missing-OBJ soft failure (Object.cpp:35-39): an empty scene renders a
    pure background frame instead of crashing."""
    from simple_raytracer.scene.scene import SceneManager
    sm = SceneManager(root="/tmp/nonexistent")
    sm.load_obj_file("/tmp/nonexistent/missing.obj", key="gone")
    scene = sm.build()
    cfg = default_config().replace(camera=CameraConfig(width=16, height=12))
    img = np.asarray(render(scene, cfg, LIGHT))
    assert (img == np.array([173, 216, 230])).all()


def test_shadow_max_t_toggle():
    """shadow_no_max_t=True (reference quirk): an occluder BEYOND the light
    still shadows; False: it does not."""
    from simple_raytracer.config import LightConfig
    from simple_raytracer.scene.scene import SceneManager
    sm = SceneManager()
    # target plane at z=40
    sm.add_mesh("plane", cube_mesh())
    sm.set_color("plane", (0.8, 0.8, 0.8))
    sm.transform_triangles("plane", T.scale(10.0, 10.0, 1.0))
    sm.transform_triangles("plane", T.translate((0.0, 0.0, 40.0)))
    # occluder BEHIND the light as seen from the plane: light is at z=10,
    # occluder at z=-20 (farther along the plane->light direction)
    sm.add_mesh("occ", cube_mesh())
    sm.set_color("occ", (0.1, 0.1, 0.9))
    sm.transform_triangles("occ", T.scale(30.0, 30.0, 1.0))
    sm.transform_triangles("occ", T.translate((0.0, 0.0, -20.0)))
    scene = sm.build()
    light = jnp.array([0.0, 0.0, 10.0], jnp.float32)
    cam = CameraConfig(width=24, height=24)
    cfg_quirk = default_config().replace(
        camera=cam, light=LightConfig(shadow_no_max_t=True))
    cfg_sane = default_config().replace(
        camera=cam, light=LightConfig(shadow_no_max_t=False))
    img_q = np.asarray(render(scene, cfg_quirk, light))
    img_s = np.asarray(render(scene, cfg_sane, light))
    # quirk mode: beyond-light occluder dims the plane; sane mode: no shadow
    assert (img_q != img_s).any()
    assert img_s.sum() > img_q.sum()


def test_specular_nl_toggle():
    from simple_raytracer.scene.scene import SceneManager
    sm = SceneManager()
    sm.add_mesh("s", uv_sphere_mesh())
    sm.transform_triangles("s", T.translate((0.0, 0.0, 20.0)))
    scene = sm.build()
    cam = CameraConfig(width=48, height=48)
    cfg_on = default_config().replace(camera=cam)
    cfg_off = default_config().replace(
        camera=cam, shading=ShadingConfig(specular_nl_factor=False))
    img_on = np.asarray(render(scene, cfg_on, LIGHT))
    img_off = np.asarray(render(scene, cfg_off, LIGHT))
    assert (img_on != img_off).any()


def test_tiled_fused_render_under_debug_nans():
    """The FUSED production pipeline (in-kernel attr fetch + Phong +
    from-t shadow, interpret mode on CPU) must be debug_nans-clean
    including its padded off-frame and miss lanes — the epilogue pins
    miss t to 0 and floors rv with a NORMAL f32 precisely so no masked
    NaN is ever produced (the round-4 shin==0 NaN lived here)."""
    sm = SceneManager()
    sm.add_mesh("c", cube_mesh())
    sm.set_color("c", (0.3, 0.5, 0.9))
    sm.transform_triangles(
        "c", T.translate((0.0, 0.0, 30.0)) @ T.scale(20, 20, 20))
    sm.add_mesh("s", uv_sphere_mesh())
    sm.set_color("s", (0.9, 0.8, 0.2))
    sm.transform_triangles(
        "s", T.translate((0.0, 0.0, 20.0)) @ T.scale(3, 3, 3))
    scene = sm.build()
    cfg = default_config().replace(
        mode="tiled", kernel=INTERPRET, camera=CameraConfig(width=16, height=16))
    from simple_raytracer.accel.prepared import prepare
    prep = prepare(scene, cfg)
    with jax.debug_nans(True):
        rad, hit = jax.jit(
            lambda p, l: render_radiance(p, cfg, l))(prep, LIGHT)
        r = np.asarray(rad)
    m = np.asarray(hit)
    assert m.all()
    assert np.isfinite(r[m]).all()
