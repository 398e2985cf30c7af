"""Intersection ops: Möller–Trumbore and slab AABB tests.

Pure-jnp reference implementations (the correctness oracle, differentiable,
CPU-runnable).  The window walk in ``kernels/walk.py`` runs the same
operations.

Conventions (from the reference):
* A missed triangle returns ``+inf`` (the reference uses a ``-INFINITY``
  sentinel with explicit checks, simple_raytracer.cpp:42-75; +inf composes
  directly with min-reductions for nearest-hit).
* ``t == 0`` counts as a hit (the reference rejects only ``t < 0``, :73).
* Determinant epsilon 1e-12 (:57).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INF = jnp.inf


def moller_trumbore(origin: jnp.ndarray, direction: jnp.ndarray,
                    verts_cart: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Ray/triangle intersection distance (simple_raytracer.cpp:42-75).

    Args:
      origin:    [..., 3] ray origin(s).
      direction: [..., 3] ray direction(s) (NOT normalized, as in the reference).
      verts_cart: [..., 3, 3] Cartesian triangle vertices (w-divide already
        applied, see Scene.verts_cart / simple_raytracer.cpp:45-47).
      eps: determinant cutoff (:57).

    Returns ``t`` with misses mapped to +inf; broadcasting over leading dims.
    """
    p1 = verts_cart[..., 0, :]
    p2 = verts_cart[..., 1, :]
    p3 = verts_cart[..., 2, :]
    e1 = p2 - p1
    e2 = p3 - p1
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / det
    tvec = origin - p1
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    valid = (jnp.abs(det) >= eps) & (u >= 0.0) & (u <= 1.0) & \
            (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    return jnp.where(valid, t, INF)


def pack_mt_gram(verts_cart: jnp.ndarray) -> jnp.ndarray:
    """Pack per-triangle Möller–Trumbore factor matrix G: [T, 10, 4].

    Matmul formulation: with ray features f = [d, o×d, o, 1] (10 values),
    all four MT scalars for every (ray, triangle) pair are ONE contraction

        [det, u_num, v_num, t_num][r, t] = F[r, :] @ G[t, :, :]

    which runs as one matrix product.  Derivation (triple-product
    identities applied to simple_raytracer.cpp:42-75):

        det   = d · n            with n = e2 × e1        (= -(e1 × e2))
        u_num = (o×d) · e2 − d · (e2 × p1)
        v_num = −(o×d) · e1 − d · (p1 × e1)
        t_num = −o · n − e2 · (p1 × e1)                  (constant + o-term)

    and u = u_num/det, v = v_num/det, t = t_num/det.
    """
    p1 = verts_cart[..., 0, :]
    e1 = verts_cart[..., 1, :] - p1
    e2 = verts_cart[..., 2, :] - p1
    n = jnp.cross(e2, e1)                     # so that det = d·n matches e1·(d×e2)
    e2xp1 = jnp.cross(e2, p1)
    p1xe1 = jnp.cross(p1, e1)
    c_t = -jnp.sum(e2 * p1xe1, axis=-1)       # t_num constant term

    T = verts_cart.shape[0]
    G = jnp.zeros((T, 10, 4), dtype=verts_cart.dtype)
    # rows 0..2: d ; rows 3..5: o×d ; rows 6..8: o ; row 9: 1
    G = G.at[:, 0:3, 0].set(n)                # det
    G = G.at[:, 0:3, 1].set(-e2xp1)           # u_num d-term
    G = G.at[:, 3:6, 1].set(e2)               # u_num (o×d)-term
    G = G.at[:, 0:3, 2].set(-p1xe1)           # v_num d-term
    G = G.at[:, 3:6, 2].set(-e1)              # v_num (o×d)-term
    G = G.at[:, 6:9, 3].set(-n)               # t_num o-term
    G = G.at[:, 9, 3].set(c_t)                # t_num constant
    return G


def ray_features(origin: jnp.ndarray, direction: jnp.ndarray) -> jnp.ndarray:
    """Ray feature vector [..., 10] = [d, o×d, o, 1] for the Gram formulation."""
    one = jnp.ones(origin.shape[:-1] + (1,), dtype=direction.dtype)
    return jnp.concatenate(
        [direction, jnp.cross(origin, direction), origin, one], axis=-1)


def moller_trumbore_gram(features: jnp.ndarray, G: jnp.ndarray,
                         eps: float = 1e-12) -> jnp.ndarray:
    """MT via the matmul formulation: features [R,10] x G [T,10,4] -> t [R,T].

    Matches :func:`moller_trumbore` exactly up to fp reassociation; this is the
    layout the geometry-sharded ring contracts (dist/ring.py).
    """
    T = G.shape[0]
    quad = jnp.einsum("rf,tfk->rtk", features, G,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    det, u_num, v_num, t_num = (quad[..., 0], quad[..., 1],
                                quad[..., 2], quad[..., 3])
    inv_det = 1.0 / det
    u = u_num * inv_det
    v = v_num * inv_det
    t = t_num * inv_det
    valid = (jnp.abs(det) >= eps) & (u >= 0.0) & (u <= 1.0) & \
            (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    return jnp.where(valid, t, INF)


def slab_test_origin(direction: jnp.ndarray, box_min: jnp.ndarray,
                     box_max: jnp.ndarray) -> jnp.ndarray:
    """Slab AABB test for rays at the view-space origin
    (simple_raytracer.cpp:204-248).  Returns bool, broadcasting."""
    t0 = box_min / direction
    t1 = box_max / direction
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    lo = jnp.max(tmin, axis=-1)
    hi = jnp.min(tmax, axis=-1)
    return lo <= hi


def slab_test(origin: jnp.ndarray, direction: jnp.ndarray,
              box_min: jnp.ndarray, box_max: jnp.ndarray) -> jnp.ndarray:
    """General-origin slab test (simple_raytracer.cpp:252-293); used for shadow
    rays and all BVH traversal.  Note: like the reference, there is no t-range
    clipping — a box fully behind the ray origin still reports a hit."""
    t0 = (box_min - origin) / direction
    t1 = (box_max - origin) / direction
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    lo = jnp.max(tmin, axis=-1)
    hi = jnp.min(tmax, axis=-1)
    return lo <= hi


def nearest_hit(origin: jnp.ndarray, direction: jnp.ndarray,
                verts_cart: jnp.ndarray, eps: float = 1e-12):
    """Brute-force nearest hit of one ray against all triangles.

    Returns (t, tri_idx); t = +inf and tri_idx = -1 on miss.  Ties break to the
    lowest triangle index (the reference keeps the first strict improvement in
    map-iteration order, simple_raytracer.cpp:428-431; only degenerate scenes
    differ).
    """
    ts = moller_trumbore(origin[None, :], direction[None, :], verts_cart, eps)
    idx = jnp.argmin(ts)
    t = ts[idx]
    return t, jnp.where(jnp.isinf(t), -1, idx.astype(jnp.int32))
