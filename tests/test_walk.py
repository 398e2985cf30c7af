"""The window walks (kernels/walk.py): the Triton kernels in interpret mode
against their plain jnp twins, the wrapper's shapes and backend rules, and
(marked gpu) the compiled kernels on a card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from simple_raytracer.accel.prepared import prepare
from simple_raytracer.config import KernelConfig, default_config
from simple_raytracer.kernels import tiled, walk
from simple_raytracer.ops.camera import primary_rays
from simple_raytracer.render.renderer import brute_force_hits
from simple_raytracer.scene.generated import blob_mesh, cube_mesh
from simple_raytracer.scene.scene import SceneManager
import simple_raytracer.scene.transforms as T

TILE, EPS = 128, 1e-12
WINDOW = KernelConfig().window_blocks * 32      # the plans' window width


def _prep(subdiv=2):
    sm = SceneManager()
    sm.add_mesh("blob", blob_mesh(seed=3, subdiv=subdiv))
    sm.transform_triangles("blob", T.translate((0.0, 0.0, 12.0))
                           @ T.scale(3.0, 3.0, 3.0))
    sm.add_mesh("ground", cube_mesh())
    sm.transform_triangles("ground", T.translate((0.0, 5.0, 12.0))
                           @ T.scale(10.0, 1.0, 10.0))
    return prepare(sm.build(), default_config())


def _walk_inputs(prep, W=40, H=24, maxv=248):
    o, d = primary_rays(W, H, 30.0)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    plan = tiled.cull(prep, o, d, TILE, maxv, apex=True)
    rays, R = walk.pack_rays(o, d, TILE)
    return o, d, plan, rays, R


@pytest.mark.parametrize("maxv", [248, 0])
def test_nearest_kernel_matches_plain_twin(maxv):
    prep = _prep()
    o, d, plan, rays, R = _walk_inputs(prep, maxv=maxv)
    t1, i1 = walk.nearest(plan, rays, prep.geom, tile=TILE, window=WINDOW,
                          chunk=16, eps=EPS, interpret=True)
    t2, i2 = walk.nearest_reference(plan, rays, prep.geom, tile=TILE,
                                    window=WINDOW, eps=EPS)
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    t0, i0 = brute_force_hits(prep.scene, o, d)
    assert np.isfinite(np.asarray(t0)).sum() > 300
    np.testing.assert_array_equal(np.asarray(i1)[:R], np.asarray(i0))


def test_anyhit_kernel_matches_plain_twin():
    prep = _prep()
    o, d, plan, rays, R = _walk_inputs(prep)
    t, idx = brute_force_hits(prep.scene, o, d)
    hit = np.isfinite(np.asarray(t))
    p = jnp.where(hit[:, None], o + jnp.where(hit, t, 0.0)[:, None] * d, 0.0)
    so = prep.scene.tri_obj[jnp.maximum(idx, 0)]
    dl = jnp.asarray([500.0, -300.0, -200.0]) - p
    splan = tiled.cull(prep, p, dl, TILE, 248)
    srays, _ = walk.pack_rays(p, dl, TILE, so)
    for no_max_t in (True, False):
        f1 = walk.anyhit(splan, srays, prep.geom, tile=TILE, window=WINDOW,
                         chunk=16, eps=EPS, no_max_t=no_max_t,
                         interpret=True)
        f2 = walk.anyhit_reference(splan, srays, prep.geom, tile=TILE,
                                   window=WINDOW, eps=EPS, no_max_t=no_max_t)
        np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    assert 0 < np.asarray(f1)[:R][hit].mean() < 1


def test_wrapper_pads_ragged_tiles_and_handles_empty_plans():
    """A ray count that is not a tile multiple pads the last tile with
    its last ray; an all-zero plan row walks nothing; a tile whose rays
    all miss returns +inf / -1 and found=False."""
    prep = _prep(subdiv=1)
    o, d = primary_rays(13, 11, 10.0)                 # 143 rays: 2 tiles
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    rays, R = walk.pack_rays(o, d, TILE)
    assert rays.shape == (walk.RAY_ROWS, 2 * TILE) and R == 143
    np.testing.assert_array_equal(np.asarray(rays[:3, R:]),
                                  np.broadcast_to(np.asarray(o[-1:]).T,
                                                  (3, 2 * TILE - R)))
    plan = tiled.cull(prep, o, d, TILE, 248, apex=True)
    assert plan.shape == (2, 256)
    empty = jnp.zeros_like(plan)
    t, i = walk.nearest(empty, rays, prep.geom, tile=TILE, window=WINDOW,
                        chunk=16, eps=EPS, interpret=True)
    assert np.isinf(np.asarray(t)).all() and (np.asarray(i) == -1).all()
    f = walk.anyhit(empty, rays, prep.geom, tile=TILE, window=WINDOW,
                    chunk=16, eps=EPS, interpret=True)
    assert not np.asarray(f).any()
    # rays pointing away from everything: every tile misses
    away = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0]), d.shape)
    rays2, _ = walk.pack_rays(o, away, TILE)
    t, i = walk.nearest(plan, rays2, prep.geom, tile=TILE, window=WINDOW,
                        chunk=16, eps=EPS, interpret=True)
    assert np.isinf(np.asarray(t)).all() and (np.asarray(i) == -1).all()
    t_h, i_h = tiled.hits(prep, o, d, TILE, EPS,
                          kernel=default_config().kernel.__class__(
                              interpret=True))
    assert t_h.shape == (R,) and i_h.shape == (R,)


def test_wrapper_refuses_interpret_on_gpu(monkeypatch):
    prep = _prep(subdiv=1)
    _, _, plan, rays, _ = _walk_inputs(prep, 16, 8)
    args = dict(tile=TILE, window=WINDOW, chunk=16, eps=EPS)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(ValueError, match="interpret"):
        walk.nearest(plan, rays, prep.geom, interpret=True, **args)
    with pytest.raises(ValueError, match="interpret"):
        walk.anyhit(plan, rays, prep.geom, interpret=True, **args)


def test_wrapper_refuses_to_compile_off_gpu():
    prep = _prep(subdiv=1)
    _, _, plan, rays, _ = _walk_inputs(prep, 16, 8)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        walk.nearest(plan, rays, prep.geom, tile=TILE, window=WINDOW,
                     chunk=16, eps=EPS)


def test_camera_rays_use_highest_precision():
    """A rotated view's ray directions are an f32 matrix product: at the
    default precision a GPU would run it in TF32 (~3 digits).  Both camera
    paths must match float64 to f32 rounding."""
    from simple_raytracer.ops.camera import (primary_rays_tiled,
                                                 primary_rays_world)
    from simple_raytracer.scene.catalog import orbit_view
    V = orbit_view(37.0, 50.0, -50.0, 30.0).astype(np.float32)
    W, H = 48, 32
    o, d = primary_rays_world(W, H, jnp.asarray(V), 400.0)
    i = np.arange(-(W // 2), W - W // 2, dtype=np.float64)
    j = np.arange(-(H // 2), H - H // 2, dtype=np.float64)
    ii, jj = np.meshgrid(i, j)
    base = np.stack([ii, jj, np.full_like(ii, 400.0)], -1)
    ref = base @ V[:3, :3].astype(np.float64).T
    np.testing.assert_allclose(np.asarray(d), ref, rtol=1e-6, atol=1e-4)
    o2, d2, _, _ = primary_rays_tiled(W, H, 16, 400.0,
                                      view_matrix=jnp.asarray(V))
    dt = np.asarray(d2).reshape(2, 3, 16, 16, 3).transpose(
        0, 2, 1, 3, 4).reshape(32, 48, 3)
    np.testing.assert_allclose(dt, ref, rtol=1e-6, atol=1e-4)


def test_compile_cache_location(monkeypatch, tmp_path):
    from simple_raytracer.utils import compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    saved = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path.endswith(".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


@pytest.mark.gpu
def test_compiled_walks_match_plain_twins(gpu):
    prep = _prep(subdiv=4)
    o, d, plan, rays, R = _walk_inputs(prep, 160, 96)
    t1, i1 = walk.nearest(plan, rays, prep.geom, tile=TILE, window=WINDOW,
                          chunk=16, eps=EPS)
    t2, i2 = walk.nearest_reference(plan, rays, prep.geom, tile=TILE,
                                    window=WINDOW, eps=EPS)
    assert (np.asarray(i1) == np.asarray(i2)).mean() > 0.999
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-5)
    so = prep.scene.tri_obj[jnp.maximum(i1[:R], 0)]
    f1 = walk.anyhit(plan, walk.pack_rays(o, d, TILE, so)[0], prep.geom,
                     tile=TILE, window=WINDOW, chunk=16, eps=EPS)
    f2 = walk.anyhit_reference(plan, walk.pack_rays(o, d, TILE, so)[0],
                               prep.geom, tile=TILE, window=WINDOW, eps=EPS)
    assert (np.asarray(f1) == np.asarray(f2)).mean() > 0.999


@pytest.mark.gpu
def test_gpu_render_default_mode_is_the_walk(gpu):
    from simple_raytracer.config import CameraConfig
    from simple_raytracer.render.renderer import render
    prep = _prep(subdiv=3)
    cfg = default_config().replace(camera=CameraConfig(width=96, height=64,
                                                       focal=60.0))
    assert cfg.mode == "tiled"
    light = jnp.asarray([500.0, -300.0, -200.0])
    img = np.asarray(render(prep, cfg, light))
    ref = np.asarray(render(prep.scene, cfg.replace(mode="bruteforce"),
                            light))
    assert (np.abs(img.astype(int) - ref.astype(int)).max(-1) <= 1
            ).mean() > 0.999
