"""Stackless flattened-BVH traversal in pure jnp (lax.while_loop + vmap).

Replaces the reference's recursive, triangle-copying traversal
(simple_raytracer.cpp:296-317) with a skip-pointer walk that tracks a running
``min(t)`` instead of materializing candidate lists.  This is the mid-tier
renderer: correct on every backend, differentiable via the fixed-topology
recompute in ``diff/``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import intersect as isect
from ..render import integrator
from ..utils import match_vma
from .prepared import PreparedScene


def _leaf_ts(prep: PreparedScene, verts_cart, o, d, first, eps):
    """MT over one leaf's fixed-size window [max_leaf, ...]."""
    window = jax.lax.dynamic_slice(
        verts_cart, (first, 0, 0), (prep.max_leaf, 3, 3))
    return isect.moller_trumbore(o[None, :], d[None, :], window, eps)


def nearest_hit(prep: PreparedScene, o: jnp.ndarray, d: jnp.ndarray,
                eps: float = 1e-12) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Nearest hit for one ray via the stackless walk.  Returns (t, tri_idx)
    in REORDERED triangle indexing (PreparedScene.scene order)."""
    verts_cart = prep.scene.verts_cart()
    M = prep.num_nodes
    lane = jnp.arange(prep.max_leaf)

    def cond(state):
        i, _, _ = state
        return i < M

    def body(state):
        i, best_t, best_idx = state
        hit = isect.slab_test(o, d, prep.node_min[i], prep.node_max[i])
        count = prep.leaf_count[i]
        first = jnp.maximum(prep.leaf_first[i], 0)
        is_leaf = count > 0

        # Masked unconditional leaf test: under vmap a lax.cond lowers to
        # both-branches-select anyway, and inside shard_map cond branches
        # trip varying-axes typing — so the mask formulation is both the
        # faster and the portable one.
        ts = _leaf_ts(prep, verts_cart, o, d, first, eps)
        ts = jnp.where((lane < count) & hit & is_leaf, ts, jnp.inf)
        k = jnp.argmin(ts)
        t = ts[k]
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        best_idx = jnp.where(better, (first + k).astype(jnp.int32), best_idx)
        nxt = jnp.where(hit & ~is_leaf, i + 1, prep.skip[i])
        return nxt, best_t, best_idx

    _, t, idx = jax.lax.while_loop(
        cond, body, (match_vma(jnp.int32(0), o), match_vma(jnp.inf, o),
                     match_vma(jnp.int32(-1), o)))
    return t, idx


def any_hit_other(prep: PreparedScene, o: jnp.ndarray, d: jnp.ndarray,
                  self_obj: jnp.ndarray, eps: float = 1e-12,
                  no_max_t: bool = True) -> jnp.ndarray:
    """Shadow predicate: ANY intersection (t >= 0, no max-t — the reference
    quirk, simple_raytracer.cpp:321-342) with a triangle of a DIFFERENT
    object.  Early-exits once found.  ``no_max_t=False`` clips occluders
    beyond the light (t > 1 on the unnormalized segment)."""
    verts_cart = prep.scene.verts_cart()
    tri_obj = prep.scene.tri_obj
    M = prep.num_nodes
    lane = jnp.arange(prep.max_leaf)

    def cond(state):
        i, found = state
        return (i < M) & ~found

    def body(state):
        i, found = state
        hit = isect.slab_test(o, d, prep.node_min[i], prep.node_max[i])
        count = prep.leaf_count[i]
        first = jnp.maximum(prep.leaf_first[i], 0)
        is_leaf = count > 0

        ts = _leaf_ts(prep, verts_cart, o, d, first, eps)
        objs = jax.lax.dynamic_slice(tri_obj, (first,), (prep.max_leaf,))
        occ = jnp.isfinite(ts) & (lane < count) & (objs != self_obj) & \
            hit & is_leaf
        if not no_max_t:
            occ = occ & (ts <= 1.0)
        found = found | jnp.any(occ)
        nxt = jnp.where(hit & ~is_leaf, i + 1, prep.skip[i])
        return nxt, found

    _, found = jax.lax.while_loop(
        cond, body, (match_vma(jnp.int32(0), o), match_vma(jnp.bool_(False), o)))
    return found


def bvh_hits(prep: PreparedScene, origin, direction, eps: float = 1e-12):
    """Vmapped nearest-hit over flat rays [R, 3] -> (t [R], idx [R])."""
    return jax.vmap(lambda o, d: nearest_hit(prep, o, d, eps))(origin, direction)


def bvh_shadow_fn(prep: PreparedScene, eps: float = 1e-12,
                  no_max_t: bool = True):
    def shadow(point, light, self_obj, hit=None):
        d = light - point
        return jax.vmap(
            lambda o, dd, s: any_hit_other(prep, o, dd, s, eps, no_max_t))(
            point, d, self_obj)
    return shadow


def render_flat_bvh(prep: PreparedScene, cfg: RenderConfig, origin, direction,
                    light_pos):
    """BVH-mode renderer over flat rays -> (radiance [R,3], hit [R])."""
    t, tri_idx = bvh_hits(prep, origin, direction, cfg.mt_eps)
    shadow_fn = bvh_shadow_fn(prep, cfg.mt_eps, cfg.light.shadow_no_max_t) \
        if cfg.light.enable_shadows else None
    radiance = integrator.shade(prep.scene, cfg, origin, direction, t, tri_idx,
                                light_pos, shadow_fn)
    return radiance, jnp.isfinite(t)
