"""Inverse rendering demo: recover a texture from rendered images.

Renders a target image of a sphere under the generated foliage texture,
re-initializes the texture atlas to gray, and gradient-descends the ATLAS
PIXELS until renders match — the texture-gather VJP (a scatter-add,
DESIGN.md) doing the work.  Renders with the differentiable jnp oracle
(mode "bruteforce") on whatever device JAX picks.  Outputs
before/after/target PNGs under examples/out/.

Run: python examples/fit_texture.py [--cpu]   (--cpu: pin the CPU)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
if __name__ == "__main__" and "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp
import optax

from simple_raytracer.config import default_config, CameraConfig, LightConfig
from simple_raytracer.render.renderer import render_radiance
from simple_raytracer.render import integrator
from simple_raytracer.scene.generated import (leaf_texture,
                                              set_planar_texture,
                                              uv_sphere_mesh)
from simple_raytracer.scene.scene import SceneManager
import simple_raytracer.scene.transforms as T
from simple_raytracer.io.image import save_image

OUT = os.path.join(os.path.dirname(__file__), "out")


def main():
    os.makedirs(OUT, exist_ok=True)
    sm = SceneManager()
    sm.add_mesh("tree", uv_sphere_mesh())
    set_planar_texture(sm, "tree", "leaves", leaf_texture(), axes=(0, 1))
    sm.transform_triangles("tree", T.translate((0.0, 2.0, 40.0))
                           @ T.scale(5.0, 5.0, 5.0))
    scene = jax.device_put(sm.build())
    cfg = default_config().replace(
        mode="bruteforce", camera=CameraConfig(width=96, height=72),
        light=LightConfig(enable_shadows=False))
    light = jnp.array([500.0, -300.0, -200.0], jnp.float32)

    target, hit = render_radiance(scene, cfg, light)
    target = jnp.where(hit[..., None], target, 0.0)

    def save(name, rad):
        img = integrator.finalize_image(rad, hit, cfg)
        save_image(os.path.join(OUT, name), np.asarray(img))

    save("target.png", target)

    tex0 = jnp.full_like(scene.tex_data, 0.5)     # forget the texture

    def loss_fn(tex):
        rad, h = render_radiance(scene.replace(tex_data=tex), cfg, light)
        return jnp.mean((jnp.where(h[..., None], rad, 0.0) - target) ** 2)

    opt = optax.adam(5e-2)
    state = opt.init(tex0)

    @jax.jit
    def step(tex, state):
        loss, g = jax.value_and_grad(loss_fn)(tex, )
        upd, state = opt.update(g, state, tex)
        tex = jnp.clip(optax.apply_updates(tex, upd), 0.0, 1.0)
        return tex, state, loss

    def masked(rad, h):
        return jnp.where(h[..., None], rad, 0.0)

    tex = tex0
    rad0, h0 = render_radiance(scene.replace(tex_data=tex), cfg, light)
    rad0 = masked(rad0, h0)
    save("before.png", rad0)
    for i in range(80):
        tex, state, loss = step(tex, state)
        if i % 20 == 0 or i == 79:
            print(f"step {i:3d}  loss {float(loss):.6f}", flush=True)
    rad1, h1 = render_radiance(scene.replace(tex_data=tex), cfg, light)
    rad1 = masked(rad1, h1)
    save("after.png", rad1)
    err0 = float(jnp.mean((rad0 - target) ** 2))
    err1 = float(jnp.mean((rad1 - target) ** 2))
    print(f"image MSE: before {err0:.6f} -> after {err1:.6f} "
          f"({err0 / max(err1, 1e-12):.0f}x lower)")
    assert err1 < err0 * 0.05


if __name__ == "__main__":
    main()
