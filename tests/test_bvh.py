"""BVH build/flatten/traversal tests: structure invariants, hit equivalence
with brute force, and full-image equality between render modes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from simple_raytracer import RenderConfig, CameraConfig, SceneManager, render
from simple_raytracer.accel import bvh as bvh_mod
from simple_raytracer.accel import prepare, traverse
from simple_raytracer.render.renderer import brute_force_hits
from simple_raytracer.scene import transforms as T
from simple_raytracer.scene.generated import blob_mesh, uv_sphere_mesh



def _random_tris(rng, n, spread=10.0):
    centers = rng.normal(size=(n, 1, 3)).astype(np.float32) * spread
    return centers + rng.normal(size=(n, 3, 3)).astype(np.float32)


def test_build_structure_invariants(rng):
    verts = _random_tris(rng, 100)
    b = bvh_mod.build_bvh(verts, leaf_size=8)
    M = len(b.skip)
    # preorder skip pointers: strictly increasing targets within (i, M]
    assert np.all(b.skip > np.arange(M))
    assert np.all(b.skip <= M)
    # perm is a permutation
    assert sorted(b.perm.tolist()) == list(range(100))
    # every leaf has 1..8 triangles; leaf ranges tile perm exactly
    leaves = b.leaf_count > 0
    assert b.leaf_count[leaves].max() <= 8
    assert b.leaf_count.sum() == 100
    # node boxes contain their leaf triangles
    for i in np.where(leaves)[0]:
        tris = verts[b.perm[b.leaf_first[i]:b.leaf_first[i] + b.leaf_count[i]]]
        assert np.all(tris.reshape(-1, 3) >= b.node_min[i] - 1e-4)
        assert np.all(tris.reshape(-1, 3) <= b.node_max[i] + 1e-4)


def test_root_always_split():
    """The reference always splits the root once (Object.cpp:282), even for
    tiny objects."""
    rng = np.random.default_rng(1)
    verts = _random_tris(rng, 3)
    b = bvh_mod.build_bvh(verts, leaf_size=8)
    assert len(b.skip) == 3               # root + 2 leaves
    assert b.leaf_count[0] == 0           # root is interior


def test_single_triangle_object():
    rng = np.random.default_rng(2)
    verts = _random_tris(rng, 1)
    b = bvh_mod.build_bvh(verts, leaf_size=8)
    # left child empty (size/2 = 0) with inverted box — reference edge case
    assert b.leaf_count.sum() == 1
    empty = (b.leaf_count == 0) & (b.leaf_first >= 0)
    # structure stays traversable
    assert np.all(b.skip <= len(b.skip))


def _manager_from_tris(verts_list):
    """Build a SceneManager directly from per-object [n,3,3] triangle arrays."""
    from simple_raytracer.scene.obj_loader import MeshData
    from simple_raytracer.scene.scene import _ObjectEntry
    mgr = SceneManager()
    for k, v in enumerate(verts_list):
        n = v.shape[0]
        v4 = np.concatenate([v.astype(np.float32),
                             np.ones((n, 3, 1), np.float32)], axis=-1)
        mesh = MeshData(v4, np.zeros((n, 3, 3), np.float32),
                        np.zeros((n, 3, 2), np.float32),
                        np.ones((n, 3), np.float32),
                        np.full((n,), -1, np.int32), [])
        mgr.objects[f"obj{k}"] = _ObjectEntry(mesh, (1.0, 0.0, 0.0), 0.2, 0.5, 15.0)
        mgr._order.append(f"obj{k}")
    return mgr


def test_bvh_hits_match_bruteforce_random(rng):
    """Nearest hits through the stackless walk == brute force over all pairs,
    random rays, multi-object scene."""
    scene = _manager_from_tris([
        _random_tris(rng, 37), _random_tris(rng, 5), _random_tris(rng, 64),
    ]).build()
    cfg = RenderConfig(mode="bvh")
    prep = prepare(scene, cfg)

    R = 256
    o = jnp.asarray(rng.normal(size=(R, 3)).astype(np.float32) * 5)
    d = jnp.asarray(rng.normal(size=(R, 3)).astype(np.float32))
    t_bvh, idx_bvh = traverse.bvh_hits(prep, o, d)
    t_bf, idx_bf = brute_force_hits(prep.scene, o, d)

    np.testing.assert_allclose(np.asarray(t_bvh), np.asarray(t_bf),
                               rtol=1e-5, atol=1e-6)
    # hit identity must agree wherever t is finite (tie-break equal t allowed
    # to differ only if the t values match)
    both = np.isfinite(np.asarray(t_bvh))
    assert np.array_equal(both, np.isfinite(np.asarray(t_bf)))


def test_bvh_shadow_matches_bruteforce(rng):
    scene = _manager_from_tris(
        [_random_tris(rng, 16), _random_tris(rng, 16)]).build()
    cfg = RenderConfig(mode="bvh")
    prep = prepare(scene, cfg)
    from simple_raytracer.render.renderer import brute_force_shadow
    R = 128
    point = jnp.asarray(rng.normal(size=(R, 3)).astype(np.float32) * 5)
    light = jnp.asarray(rng.normal(size=(R, 3)).astype(np.float32) * 20)
    self_obj = jnp.asarray(rng.integers(0, 2, size=(R,)).astype(np.int32))
    got = traverse.bvh_shadow_fn(prep)(point, light, self_obj)
    want = brute_force_shadow(prep.scene)(point, light, self_obj)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_bvh_image_equals_bruteforce_sphere():
    mgr = SceneManager()
    mgr.add_mesh("sphere.obj", uv_sphere_mesh())
    mgr.transform_triangles("sphere.obj", T.translate([0.0, 6.0, 30.0])
                            @ T.scale(3.0, 3.0, 3.0))
    scene = mgr.build()
    cam = CameraConfig(width=64, height=64, focal=64.0)
    light = jnp.array([50.0, -30.0, -20.0])
    img_bf = np.asarray(render(scene, RenderConfig(camera=cam), light))
    img_bvh = np.asarray(render(scene, RenderConfig(camera=cam, mode="bvh"), light))
    assert np.array_equal(img_bf, img_bvh)


def test_bvh_bunny_small_render():
    """The bunny stand-in (81,920 triangles) renders through the BVH at a
    small resolution (CPU sanity)."""
    mgr = SceneManager()
    mgr.add_mesh("bunny", blob_mesh())
    mgr.set_color("bunny", (0.9, 0.9, 0.9))
    mgr.transform_triangles("bunny", T.scale(4.0, 4.0, 4.0))
    mgr.transform_triangles("bunny", T.rotate_x(np.radians(181.0)))
    mgr.transform_triangles("bunny", T.translate([0.0, 2.0, 30.0]))
    scene = mgr.build()
    cfg = RenderConfig(camera=CameraConfig(width=48, height=48, focal=48.0),
                       mode="bvh")
    cfg = cfg.replace(light=cfg.light)
    img = np.asarray(render(scene, cfg, jnp.array([50.0, -30.0, -20.0])))
    hit_frac = np.mean(np.any(img != np.array([173, 216, 230]), axis=-1))
    assert hit_frac > 0.02


def test_sah_split_hits_match_bruteforce(rng):
    """BVHConfig.split='sah' builds a different topology with the same
    candidate-completeness guarantee."""
    from simple_raytracer.accel.bvh import build_bvh
    verts = rng.standard_normal((300, 3, 3)).astype(np.float32) * 3.0
    b = build_bvh(verts, 8, split="sah")
    assert sorted(b.perm.tolist()) == list(range(300))
    assert (b.leaf_count[b.leaf_count > 0] <= 8).all()

    from simple_raytracer.config import default_config, BVHConfig
    from simple_raytracer.accel.prepared import prepare
    from simple_raytracer.accel.traverse import bvh_hits
    from simple_raytracer.render.renderer import brute_force_hits
    from simple_raytracer.scene.scene import SceneManager
    sm = SceneManager()
    sm.add_mesh("s", uv_sphere_mesh())
    import simple_raytracer.scene.transforms as T
    sm.transform_triangles("s", T.translate((0.0, 2.0, 25.0)))
    scene = sm.build()
    cfg = default_config().replace(mode="bvh", bvh=BVHConfig(split="sah"))
    prep = prepare(scene, cfg)
    from simple_raytracer.ops.camera import primary_rays
    o, d = primary_rays(32, 24)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t_ref, _ = jax.jit(lambda s, o, d: brute_force_hits(s, o, d))(
        prep.scene, o, d)
    t_sah, _ = jax.jit(lambda p, o, d: bvh_hits(p, o, d))(prep, o, d)
    np.testing.assert_allclose(
        np.where(np.isfinite(np.asarray(t_ref)), np.asarray(t_ref), 0),
        np.where(np.isfinite(np.asarray(t_sah)), np.asarray(t_sah), 0),
        rtol=1e-5)
