"""Gradient correctness: fixed-topology diff rendering vs brute-force AD and
finite differences (north star: pixel-grad allclose)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from simple_raytracer.config import default_config, CameraConfig, LightConfig
from simple_raytracer.accel.prepared import prepare
from simple_raytracer.diff import render_radiance_diff
from simple_raytracer.scene.scene import SceneManager
import simple_raytracer.scene.transforms as T
from simple_raytracer.scene.generated import cube_mesh, uv_sphere_mesh

from conftest import INTERPRET




def _scene():
    sm = SceneManager()
    sm.add_mesh("cube", cube_mesh())
    sm.set_color("cube", (0.2, 0.8, 0.3))
    sm.transform_triangles(
        "cube", T.translate((0.0, 5.0, 80.0)) @ T.rotate_y(25.0)
        @ T.scale(15.0, 15.0, 15.0))
    sm.add_mesh("sphere", uv_sphere_mesh())
    sm.set_color("sphere", (0.9, 0.9, 0.2))
    sm.transform_triangles(
        "sphere", T.translate((-10.0, -15.0, 60.0)) @ T.scale(6.0, 6.0, 6.0))
    return sm.build()


CAM = CameraConfig(width=48, height=32)
LIGHT = jnp.array([500.0, -300.0, -200.0], jnp.float32)


def _loss_fn(cfg, operand_template):
    """loss(verts, light, obj_color) via mode ``cfg.mode``."""
    def loss(verts, light, obj_color):
        if hasattr(operand_template, "scene"):   # PreparedScene
            operand = operand_template.replace_scene_arrays(
                verts=verts, obj_color=obj_color)
        else:
            operand = operand_template.replace(verts=verts,
                                               obj_color=obj_color)
        rad, hit = render_radiance_diff(operand, cfg, light)
        return jnp.sum(jnp.where(hit[..., None], rad, 0.0) ** 2)
    return loss


def _prep_with(scene, cfg):
    prep = prepare(scene, cfg)

    # tiny helper so the loss can rebind differentiable arrays into the
    # prepared pytree (the permuted scene!)
    import dataclasses

    def replace_scene_arrays(**kw):
        return dataclasses.replace(prep, scene=prep.scene.replace(**kw))
    prep.replace_scene_arrays = replace_scene_arrays
    return prep


def test_bvh_grads_match_bruteforce():
    """The fixed-topology grads through the BVH path must equal brute-force AD
    grads — note both must use the SAME triangle ordering, so the brute-force
    run uses the prepared (permuted) scene too."""
    scene = _scene()
    cfg_bvh = default_config().replace(mode="bvh", camera=CAM)
    prep = _prep_with(scene, cfg_bvh)
    cfg_bf = cfg_bvh.replace(mode="bruteforce")

    loss_bvh = _loss_fn(cfg_bvh, prep)
    loss_bf = _loss_fn(cfg_bf, prep.scene)

    args = (prep.scene.verts, LIGHT, prep.scene.obj_color)
    g_bvh = jax.jit(jax.grad(loss_bvh, argnums=(0, 1, 2)))(*args)
    g_bf = jax.jit(jax.grad(loss_bf, argnums=(0, 1, 2)))(*args)

    for a, b, name in zip(g_bvh, g_bf, ("verts", "light", "color")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-5, err_msg=name)
        assert np.abs(np.asarray(a)).sum() > 0, f"zero grad for {name}"


def test_tiled_grads_match_bruteforce():
    scene = _scene()
    cfg_tl = default_config().replace(mode="tiled", kernel=INTERPRET, camera=CAM)
    prep = _prep_with(scene, cfg_tl)
    cfg_bf = cfg_tl.replace(mode="bruteforce")

    loss_tl = _loss_fn(cfg_tl, prep)
    loss_bf = _loss_fn(cfg_bf, prep.scene)

    args = (prep.scene.verts, LIGHT, prep.scene.obj_color)
    g_tl = jax.jit(jax.grad(loss_tl, argnums=(0, 1, 2)))(*args)
    g_bf = jax.jit(jax.grad(loss_bf, argnums=(0, 1, 2)))(*args)
    for a, b, name in zip(g_tl, g_bf, ("verts", "light", "color")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-5, err_msg=name)


def test_light_grad_finite_difference():
    """Pixel-sum gradient w.r.t. light position vs central differences.
    Shadows off: the shadow predicate is a step function whose FD estimate is
    unstable; smooth paths only."""
    scene = _scene()
    cfg = default_config().replace(
        mode="bvh", camera=CAM,
        light=LightConfig(enable_shadows=False))
    prep = _prep_with(scene, cfg)
    loss = _loss_fn(cfg, prep)

    f = jax.jit(lambda l: loss(prep.scene.verts, l, prep.scene.obj_color))
    g = jax.jit(jax.grad(lambda l: loss(prep.scene.verts, l,
                                        prep.scene.obj_color)))(LIGHT)
    g = np.asarray(g)
    # eps sized for f32: the loss is O(100), so the FD delta must clear the
    # ~1e-5 rounding floor by a couple of orders of magnitude
    eps = 4.0
    for k in range(3):
        e = np.zeros(3, np.float32)
        e[k] = eps
        fd = (float(f(LIGHT + e)) - float(f(LIGHT - e))) / (2 * eps)
        np.testing.assert_allclose(g[k], fd, rtol=5e-2, atol=1e-6)


def test_vertex_grad_finite_difference():
    scene = _scene()
    cfg = default_config().replace(
        mode="bvh", camera=CAM, light=LightConfig(enable_shadows=False))
    prep = _prep_with(scene, cfg)
    loss = _loss_fn(cfg, prep)

    verts = prep.scene.verts
    f = jax.jit(lambda v: loss(v, LIGHT, prep.scene.obj_color))
    g = np.asarray(jax.jit(jax.grad(f))(verts))

    # probe the largest-gradient vertex coords by finite differences;
    # keep only eps-stable probes (an eps-dependent FD means the probe sits
    # on a triangle-assignment edge — the documented fixed-topology
    # non-differentiability, not an AD error)
    flat = np.abs(g[..., :3]).reshape(-1)
    order = np.argsort(flat)[::-1][:6]
    v_np = np.asarray(verts)

    def fd_at(ti, vi, ci, eps):
        vp = v_np.copy(); vp[ti, vi, ci] += eps
        vm = v_np.copy(); vm[ti, vi, ci] -= eps
        return (float(f(jnp.asarray(vp))) - float(f(jnp.asarray(vm)))) / (2 * eps)

    checked = 0
    for o_idx in order:
        ti, vi, ci = np.unravel_index(o_idx, g[..., :3].shape)
        # eps sized for f32: the loss is O(50), so a central difference at
        # 1e-3 sits on its ~1e-3 rounding floor; 1e-2 clears it
        fd1 = fd_at(ti, vi, ci, 3e-2)
        fd2 = fd_at(ti, vi, ci, 1e-2)
        if abs(fd1 - fd2) > 0.1 * max(abs(fd1), abs(fd2), 1e-3):
            continue        # assignment edge: FD itself is ill-defined
        np.testing.assert_allclose(g[ti, vi, ci], fd2, rtol=5e-2, atol=2e-3)
        checked += 1
    assert checked >= 2, "not enough smooth probes"
