"""Gradient coverage for the remaining differentiable scene parameters:
texture atlas pixels (the scatter-add VJP of the texel gather), material
scalars (specular/shininess), and the multi-sample soft-shadow path.

Completes SURVEY §2's gradients row: every trainable quantity in
dist/train.DiffParams now has an automated finite-difference or cross-AD
check (verts/light/color live in test_grad.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from simple_raytracer.config import (default_config, CameraConfig,
                                         LightConfig)
from simple_raytracer.accel.prepared import prepare
from simple_raytracer.diff import render_radiance_diff
from simple_raytracer.render.renderer import render_radiance
from simple_raytracer.scene.scene import SceneManager
import simple_raytracer.scene.transforms as T
from simple_raytracer.scene.generated import (cube_mesh, leaf_texture,
                                                  set_planar_texture,
                                                  uv_sphere_mesh)

from conftest import INTERPRET



LIGHT = jnp.array([500.0, -300.0, -200.0], jnp.float32)


def _tree_scene():
    """Textured scene: the tree stand-in (a sphere with the seeded foliage
    texture atlas)."""
    sm = SceneManager()
    sm.add_mesh("tree", uv_sphere_mesh())
    set_planar_texture(sm, "tree", "leaves", leaf_texture(), axes=(0, 1))
    sm.transform_triangles("tree", T.scale(5.0, 5.0, 5.0))
    sm.transform_triangles("tree", T.translate((0.0, 2.0, 40.0)))
    import jax as _jax
    return _jax.device_put(sm.build())


def _shiny_scene():
    sm = SceneManager()
    sm.add_mesh("s", uv_sphere_mesh())
    sm.set_color("s", (0.8, 0.2, 0.2))
    sm.transform_triangles(
        "s", T.translate((0.0, 0.0, 30.0)) @ T.scale(2.0, 2.0, 2.0))
    import jax as _jax
    return _jax.device_put(sm.build())


def test_texture_grad_finite_difference():
    """d(loss)/d(atlas pixel) via the gather's scatter-add VJP vs central
    differences.  The loss is smooth in texel VALUES (the texel ASSIGNMENT is
    frozen), so FD is well-conditioned."""
    scene = _tree_scene()
    assert scene.has_textures
    cfg = default_config().replace(
        camera=CameraConfig(width=48, height=36),
        light=LightConfig(enable_shadows=False))

    def loss_fn(tex):
        rad, h = render_radiance(scene.replace(tex_data=tex), cfg, LIGHT)
        return jnp.sum(jnp.where(h[..., None], rad, 0.0) ** 2)

    tex0 = jnp.asarray(scene.tex_data)
    f = jax.jit(loss_fn)
    g = np.asarray(jax.jit(jax.grad(loss_fn))(tex0))
    assert np.abs(g).sum() > 0, "texture gradient identically zero"

    tex_np = np.asarray(tex0)
    order = np.argsort(np.abs(g).reshape(-1))[::-1][:4]
    eps = 1e-2
    for o in order:
        pi, ci = np.unravel_index(o, g.shape)
        tp = tex_np.copy(); tp[pi, ci] += eps
        tm = tex_np.copy(); tm[pi, ci] -= eps
        fd = (float(f(jnp.asarray(tp))) - float(f(jnp.asarray(tm)))) / (2 * eps)
        np.testing.assert_allclose(g[pi, ci], fd, rtol=5e-2, atol=1e-4)


def test_material_grads_finite_difference():
    """specular / shininess / ambient gradients vs central differences
    (the Phong terms of simple_raytracer.cpp:144-200 are smooth in these)."""
    scene = _shiny_scene()
    cfg = default_config().replace(
        camera=CameraConfig(width=48, height=32),
        light=LightConfig(enable_shadows=False))

    def loss_fn(spec, shin, amb):
        s = scene.replace(obj_specular=spec, obj_shininess=shin,
                          obj_ambient=amb)
        rad, h = render_radiance(s, cfg, LIGHT)
        return jnp.sum(jnp.where(h[..., None], rad, 0.0) ** 2)

    args = (jnp.asarray(scene.obj_specular), jnp.asarray(scene.obj_shininess),
            jnp.asarray(scene.obj_ambient))
    f = jax.jit(loss_fn)
    grads = jax.jit(jax.grad(loss_fn, argnums=(0, 1, 2)))(*args)
    names = ("specular", "shininess", "ambient")
    eps = (1e-3, 1e-2, 1e-3)
    for k, (g, name) in enumerate(zip(grads, names)):
        g = np.asarray(g)
        assert np.abs(g).sum() > 0, f"zero grad for {name}"
        pert = [np.asarray(a).copy() for a in args]
        pert[k][0] += eps[k]
        hi = float(f(*map(jnp.asarray, pert)))
        pert[k][0] -= 2 * eps[k]
        lo = float(f(*map(jnp.asarray, pert)))
        fd = (hi - lo) / (2 * eps[k])
        np.testing.assert_allclose(g[0], fd, rtol=5e-2, atol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["bvh", "tiled"])
def test_soft_shadow_multisample_grads_match_bruteforce(mode):
    """Gradients through the S>1 soft-shadow path (batched occlusion,
    render/integrator.py): fast-path fixed-topology grads must equal
    brute-force AD grads.  The shadow predicate itself is boolean (zero
    gradient by construction in both paths — the documented visibility
    contract)."""
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
        mode=mode, kernel=INTERPRET, camera=CameraConfig(width=48, height=32),
        light=LightConfig(enable_shadows=True, num_samples=4))
    prep = prepare(scene, cfg)

    def loss(operand, cfgx, verts, light):
        if cfgx.mode == "bruteforce":
            operand = operand.replace(verts=verts)
        else:
            import dataclasses
            operand = dataclasses.replace(
                operand, scene=operand.scene.replace(verts=verts))
        rad, hit = render_radiance_diff(operand, cfgx, light)
        return jnp.sum(jnp.where(hit[..., None], rad, 0.0) ** 2)

    args = (prep.scene.verts, LIGHT)
    g_fast = jax.jit(jax.grad(
        lambda v, l: loss(prep, cfg, v, l), argnums=(0, 1)))(*args)
    cfg_bf = cfg.replace(mode="bruteforce")
    g_bf = jax.jit(jax.grad(
        lambda v, l: loss(prep.scene, cfg_bf, v, l), argnums=(0, 1)))(*args)
    for a, b, name in zip(g_fast, g_bf, ("verts", "light")):
        assert np.abs(np.asarray(b)).sum() > 0, f"zero grad for {name}"
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-5, err_msg=name)


def test_fit_texture_converges():
    """Seeded miniature of examples/fit_texture.py: Adam on atlas pixels must
    cut the image loss by >5x in 30 steps (the scatter-add VJP doing real
    optimization work, not just matching FD)."""
    optax = pytest.importorskip("optax")
    scene = _tree_scene()
    cfg = default_config().replace(
        camera=CameraConfig(width=48, height=36),
        light=LightConfig(enable_shadows=False))

    target, hit = render_radiance(scene, cfg, LIGHT)
    target = jnp.where(hit[..., None], target, 0.0)

    def loss_fn(tex):
        rad, h = render_radiance(scene.replace(tex_data=tex), cfg, LIGHT)
        return jnp.mean((jnp.where(h[..., None], rad, 0.0) - target) ** 2)

    tex = jnp.full_like(scene.tex_data, 0.5)
    opt = optax.adam(5e-2)
    state = opt.init(tex)

    @jax.jit
    def step(tex, state):
        loss, g = jax.value_and_grad(loss_fn)(tex)
        upd, state = opt.update(g, state, tex)
        return jnp.clip(optax.apply_updates(tex, upd), 0.0, 1.0), state, loss

    losses = []
    for _ in range(30):
        tex, state, loss = step(tex, state)
        losses.append(float(loss))
    assert losses[-1] < losses[0] / 5.0, (losses[0], losses[-1])
