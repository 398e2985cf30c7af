"""Distributed-path tests on the virtual 8-device CPU mesh (conftest forces
XLA_FLAGS=--xla_force_host_platform_device_count=8): DP ray sharding, ring
geometry sharding, and the sharded training step.  Identical code paths run on
a GPU mesh (python chip_smoke.py --cards 4)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from simple_raytracer.config import default_config
from simple_raytracer.dist import (make_mesh, render_sharded,
                                       make_train_step, extract_params)
from simple_raytracer.dist import ring as ring_mod
from simple_raytracer.render.renderer import render, render_flat
from simple_raytracer.scene.scene import SceneManager
from simple_raytracer.scene.generated import cube_mesh

from conftest import INTERPRET




def _cube_scene():
    sm = SceneManager()
    sm.add_mesh("cube", cube_mesh())
    sm.set_color("cube", (0.2, 0.8, 0.3))
    import simple_raytracer.scene.transforms as T
    m = T.translate((0.0, 0.0, 60.0)) @ T.scale(10.0, 10.0, 10.0)
    sm.transform_triangles("cube", m)
    return sm.build()


def test_dp_sharded_matches_single_device():
    scene = _cube_scene()
    cfg = default_config().replace(
        camera=default_config().camera.__class__(width=64, height=32))
    light = jnp.array([100.0, -100.0, -50.0])
    ref = np.asarray(render(scene, cfg, light))
    mesh = make_mesh(8, ("dp",))
    out = np.asarray(render_sharded(scene, cfg, light, mesh))
    np.testing.assert_array_equal(ref, out)


def test_dp_sharded_bvh_mode():
    scene = _cube_scene()
    cfg = default_config().replace(
        mode="bvh",
        camera=default_config().camera.__class__(width=64, height=32))
    light = jnp.array([100.0, -100.0, -50.0])
    ref = np.asarray(render(scene, cfg, light))
    mesh = make_mesh(8, ("dp",))
    out = np.asarray(render_sharded(scene, cfg, light, mesh))
    np.testing.assert_array_equal(ref, out)


def test_dp_sharded_tiled_mode():
    """The production configuration on a real slice: the Pallas kernel INSIDE
    shard_map (dist/sharding.py:90-93 routes mode='tiled')."""
    scene = _cube_scene()
    cfg = default_config().replace(
        mode="tiled", kernel=INTERPRET,
        camera=default_config().camera.__class__(width=64, height=48))
    light = jnp.array([100.0, -100.0, -50.0])
    ref = np.asarray(render(scene, cfg, light))
    mesh = make_mesh(8, ("dp",))
    out = np.asarray(render_sharded(scene, cfg, light, mesh))
    np.testing.assert_array_equal(ref, out)
    # and against the independent oracle (rare fp-tie edge flips allowed)
    bf = np.asarray(render(scene, cfg.replace(mode="bruteforce"), light))
    same = (out == bf).all(axis=-1)
    assert same.mean() > 0.995, same.mean()


def test_ring_geometry_sharded_matches_bruteforce():
    scene = _cube_scene()
    cfg = default_config().replace(
        camera=default_config().camera.__class__(width=32, height=16))
    light = jnp.array([100.0, -100.0, -50.0], jnp.float32)
    from simple_raytracer.ops.camera import primary_rays
    o, d = primary_rays(32, 16)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)

    ref_rad, ref_hit = jax.jit(
        lambda s, oo, dd, l: render_flat(s, cfg, oo, dd, l))(scene, o, d, light)

    n = 8
    mesh = make_mesh(n, ("gp",))
    shard = ring_mod.shard_geometry(scene, n)

    def body(scene, shard, o, d, light):
        shard = jax.tree.map(lambda a: a[0], shard)   # drop device axis
        return ring_mod.render_flat_ring(scene, shard, cfg, o, d, light)

    f = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P("gp"), P("gp"), P("gp"), P()),
        out_specs=(P("gp"), P("gp")),
        check_vma=False))   # culled ring runs pallas: see dist/sharding.py
    rad, hit = f(scene, shard, o, d, light)

    np.testing.assert_array_equal(np.asarray(ref_hit), np.asarray(hit))
    np.testing.assert_allclose(np.asarray(ref_rad)[np.asarray(ref_hit)],
                               np.asarray(rad)[np.asarray(hit)],
                               rtol=2e-5, atol=2e-6)


def test_train_step_sharded_matches_unsharded_and_descends():
    scene = _cube_scene()
    cfg = default_config().replace(
        camera=default_config().camera.__class__(width=32, height=16),
        light=default_config().light.__class__(enable_shadows=False))
    light = jnp.array([100.0, -100.0, -50.0], jnp.float32)

    from simple_raytracer.render.renderer import render_radiance
    target, hit = render_radiance(scene, cfg, light)
    target = jnp.where(hit[..., None], target, 0.0)

    params0 = extract_params(scene, light)
    # perturb the light + color and check the loss descends back
    params0 = jax.tree.map(lambda x: x, params0)
    params0.light_pos = params0.light_pos + 25.0
    params0.obj_color = params0.obj_color * 0.5

    mesh = make_mesh(8, ("dp",))
    step_sh = make_train_step(scene, cfg, mesh=mesh, lr=1e-6)
    step_un = make_train_step(scene, cfg, mesh=None, lr=1e-6)

    p_sh, l_sh = step_sh(params0, target)
    p_un, l_un = step_un(params0, target)
    np.testing.assert_allclose(float(l_sh), float(l_un), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p_sh.obj_color),
                               np.asarray(p_un.obj_color), rtol=1e-4, atol=1e-7)

    losses = [float(l_sh)]
    p = p_sh
    for _ in range(5):
        p, l = step_sh(p, target)
        losses.append(float(l))
    assert losses[-1] < losses[0], losses


def test_render_geometry_sharded_api_matches_single():
    scene = _cube_scene()
    cfg = default_config().replace(
        camera=default_config().camera.__class__(width=64, height=32))
    light = jnp.array([100.0, -100.0, -50.0])
    ref = np.asarray(render(scene, cfg, light))
    mesh = make_mesh(8, ("gp",))
    from simple_raytracer.dist.ring import render_geometry_sharded
    img = np.asarray(render_geometry_sharded(scene, cfg, light, mesh))
    same = (ref == img).all(axis=-1)
    assert same.mean() > 0.995, same.mean()


def test_render_composed_dp_gp_matches_single():
    scene = _cube_scene()
    cfg = default_config().replace(
        camera=default_config().camera.__class__(width=64, height=32))
    light = jnp.array([100.0, -100.0, -50.0])
    ref = np.asarray(render(scene, cfg, light))
    mesh = make_mesh(8, ("dp", "gp"), shape=(4, 2))
    from simple_raytracer.dist.ring import render_composed
    img = np.asarray(render_composed(scene, cfg, light, mesh))
    same = (ref == img).all(axis=-1)
    assert same.mean() > 0.995, same.mean()


def test_ring_overlap_schedule_bit_equal_to_plain():
    """The half-block double-buffered ring schedule (overlap=True, the
    default — ppermute issued before the independent half-block walk so
    ICI transfers hide behind compute) must be BIT-equal to the plain
    fold->rotate schedule: same folds at the same shards, only the issue
    order changes."""
    scene = _cube_scene()
    cfg = default_config()
    from simple_raytracer.ops.camera import primary_rays
    o, d = primary_rays(32, 16)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    light = jnp.array([100.0, -100.0, -50.0], jnp.float32)

    n = 8
    mesh = make_mesh(n, ("gp",))
    shard = ring_mod.shard_geometry(scene, n)

    def run(overlap):
        def body(shard, o, d):
            shard = jax.tree.map(lambda a: a[0], shard)
            t, rec = ring_mod.ring_nearest_hit(
                shard, o, d, eps=cfg.mt_eps, overlap=overlap)
            occ = ring_mod.ring_any_hit_other(
                shard, o, jnp.broadcast_to(light, o.shape) - o,
                rec["obj"], eps=cfg.mt_eps, overlap=overlap)
            return t, rec["obj"], occ

        f = jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(P("gp"), P("gp"), P("gp")),
            out_specs=(P("gp"), P("gp"), P("gp")),
            check_vma=False))
        return f(shard, o, d)

    t_o, obj_o, occ_o = run(True)
    t_p, obj_p, occ_p = run(False)
    np.testing.assert_array_equal(np.asarray(t_o), np.asarray(t_p))
    np.testing.assert_array_equal(np.asarray(obj_o), np.asarray(obj_p))
    np.testing.assert_array_equal(np.asarray(occ_o), np.asarray(occ_p))
    assert np.isfinite(np.asarray(t_o)).sum() > 50
