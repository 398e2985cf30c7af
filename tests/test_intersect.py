"""Intersection op tests: Möller–Trumbore (direct + Gram/matmul form) and slab
AABB tests, against analytic cases and a numpy brute-force oracle."""

import numpy as np
import jax.numpy as jnp

from simple_raytracer.ops import intersect as isect


def _tri(p1, p2, p3):
    return jnp.asarray(np.array([p1, p2, p3], np.float32))[None]  # [1,3,3]


def test_mt_analytic_hit():
    tri = _tri([-1, -1, 5], [1, -1, 5], [0, 1, 5])
    o = jnp.zeros(3)
    d = jnp.array([0.0, 0.0, 1.0])
    t = isect.moller_trumbore(o, d, tri)[0]
    np.testing.assert_allclose(t, 5.0, rtol=1e-6)


def test_mt_unnormalized_direction_scales_t():
    """The reference never normalizes directions: t scales inversely."""
    tri = _tri([-1, -1, 5], [1, -1, 5], [0, 1, 5])
    d = jnp.array([0.0, 0.0, 2.0])
    t = isect.moller_trumbore(jnp.zeros(3), d, tri)[0]
    np.testing.assert_allclose(t, 2.5, rtol=1e-6)


def test_mt_miss_outside():
    tri = _tri([-1, -1, 5], [1, -1, 5], [0, 1, 5])
    t = isect.moller_trumbore(jnp.zeros(3), jnp.array([5.0, 0.0, 1.0]), tri)[0]
    assert np.isinf(t)


def test_mt_behind_ray_rejected():
    tri = _tri([-1, -1, -5], [1, -1, -5], [0, 1, -5])
    t = isect.moller_trumbore(jnp.zeros(3), jnp.array([0.0, 0.0, 1.0]), tri)[0]
    assert np.isinf(t)


def test_mt_parallel_ray_degenerate_det():
    tri = _tri([-1, -1, 5], [1, -1, 5], [0, 1, 5])
    t = isect.moller_trumbore(jnp.zeros(3), jnp.array([1.0, 0.0, 0.0]), tri)[0]
    assert np.isinf(t)


def test_mt_homogeneous_w_divide():
    """Vertices stored homogeneous; reference divides by w (cpp:45-47)."""
    from simple_raytracer.scene.scene import Scene
    v4 = np.zeros((1, 3, 4), np.float32)
    v4[0, :, :3] = np.array([[-2, -2, 10], [2, -2, 10], [0, 2, 10]])
    v4[0, :, 3] = 2.0   # w=2 halves everything
    cart = v4[..., :3] / v4[..., 3:4]
    t = isect.moller_trumbore(jnp.zeros(3), jnp.array([0.0, 0.0, 1.0]),
                              jnp.asarray(cart))[0]
    np.testing.assert_allclose(t, 5.0, rtol=1e-6)


def test_gram_matches_direct_random(rng):
    """The matmul (Gram) formulation must match direct MT on random rays/tris,
    for both origin-zero and general-origin rays."""
    T, R = 64, 128
    verts = jnp.asarray(rng.normal(size=(T, 3, 3)).astype(np.float32) * 3)
    for zero_origin in (True, False):
        if zero_origin:
            o = np.zeros((R, 3), np.float32)
        else:
            o = rng.normal(size=(R, 3)).astype(np.float32)
        d = rng.normal(size=(R, 3)).astype(np.float32)
        o, d = jnp.asarray(o), jnp.asarray(d)
        t_direct = isect.moller_trumbore(o[:, None], d[:, None], verts[None])
        G = isect.pack_mt_gram(verts)
        F = isect.ray_features(o, d)
        t_gram = isect.moller_trumbore_gram(F, G)
        hit_d = np.isfinite(t_direct)
        hit_g = np.isfinite(t_gram)
        # Hit decisions may differ only on razor-edge cases; none expected here
        assert np.mean(hit_d == hit_g) > 0.999
        both = hit_d & hit_g
        np.testing.assert_allclose(np.where(both, t_direct, 0),
                                   np.where(both, t_gram, 0), rtol=2e-3, atol=1e-4)


def test_slab_analytic():
    bmin = jnp.array([1.0, -1.0, -1.0])
    bmax = jnp.array([2.0, 1.0, 1.0])
    assert bool(isect.slab_test_origin(jnp.array([1.0, 0.0, 0.0]), bmin, bmax))
    assert not bool(isect.slab_test_origin(jnp.array([0.0, 1.0, 0.0]), bmin, bmax))
    # general-origin variant
    o = jnp.array([0.0, 5.0, 0.0])
    assert bool(isect.slab_test(o, jnp.array([0.5, -1.0, 0.0]), bmin, bmax))


def test_slab_no_t_clipping_quirk():
    """Like the reference, a box fully BEHIND the origin still reports a hit
    (no t >= 0 clipping in simple_raytracer.cpp:252-293)."""
    bmin = jnp.array([-3.0, -1.0, -1.0])
    bmax = jnp.array([-2.0, 1.0, 1.0])
    o = jnp.zeros(3)
    d = jnp.array([1.0, 0.0, 0.0])   # pointing AWAY from the box
    assert bool(isect.slab_test(o, d, bmin, bmax))


def test_slab_vs_bruteforce_random(rng):
    """Slab test must never cull a box that a dense t-interval check accepts."""
    N = 512
    lo = rng.normal(size=(N, 3)).astype(np.float32)
    hi = lo + rng.random(size=(N, 3)).astype(np.float32) * 2
    o = rng.normal(size=(3,)).astype(np.float32) * 2
    d = rng.normal(size=(3,)).astype(np.float32)
    got = np.asarray(isect.slab_test(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(lo), jnp.asarray(hi)))
    # oracle: interval overlap of (min over axes of entry, exit), same math
    t0 = (lo - o) / d
    t1 = (hi - o) / d
    tmin = np.minimum(t0, t1).max(axis=-1)
    tmax = np.maximum(t0, t1).min(axis=-1)
    want = tmin <= tmax
    assert np.array_equal(got, want)


def test_nearest_hit_picks_min_t():
    tris = jnp.asarray(np.array([
        [[-1, -1, 10], [1, -1, 10], [0, 1, 10]],
        [[-1, -1, 5], [1, -1, 5], [0, 1, 5]],     # nearer
        [[-1, -1, 7], [1, -1, 7], [0, 1, 7]],
    ], np.float32))
    t, idx = isect.nearest_hit(jnp.zeros(3), jnp.array([0.0, 0.0, 1.0]), tris)
    assert int(idx) == 1
    np.testing.assert_allclose(t, 5.0, rtol=1e-6)


def test_nearest_hit_miss():
    tris = jnp.asarray(np.array([[[-1, -1, 5], [1, -1, 5], [0, 1, 5]]], np.float32))
    t, idx = isect.nearest_hit(jnp.zeros(3), jnp.array([0.0, 0.0, -1.0]), tris)
    assert np.isinf(t) and int(idx) == -1
