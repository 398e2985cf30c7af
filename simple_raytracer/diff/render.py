"""Differentiable rendering through the fast (BVH / Pallas) intersectors.

The data-dependent BVH walk and the tiled kernel have no useful VJP.  The
fixed-topology trick (SURVEY.md §7 "hard parts" #1): run the fast intersector
with gradients stopped to get the WINNING triangle id per ray, then recompute
t = MöllerTrumbore(verts[id]) differentiably at that fixed id.  The recomputed
t equals the kernel's t up to fp reassociation, and gradients flow from pixels
to vertices, rays, materials, lights and textures through the shading stack.

Limitation (inherent, documented): gradients w.r.t. *visibility* — silhouette
edges, occlusion flips, shadow boundaries — are zero, because the hit topology
is frozen.  This matches the north-star contract (pixel-grad allclose at fixed
topology).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import intersect as isect
from ..render import integrator


def differentiable_hits(hit_fn: Callable, verts_cart: jnp.ndarray,
                        origin: jnp.ndarray, direction: jnp.ndarray,
                        eps: float = 1e-12) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Make any nearest-hit intersector differentiable at fixed topology.

    Args:
      hit_fn: (o, d) -> (t, tri_idx); treated as non-differentiable.
      verts_cart: [T, 3, 3] — the DIFFERENTIABLE vertex array the recompute
        pulls gradients through (must be the same triangle ordering hit_fn
        reports indices in).

    Returns (t, tri_idx) with t differentiable w.r.t. verts_cart/origin/
    direction.
    """
    t_nd, idx = jax.lax.stop_gradient(
        hit_fn(jax.lax.stop_gradient(origin), jax.lax.stop_gradient(direction)))
    tri = verts_cart[jnp.maximum(idx, 0)]                  # [R, 3, 3]
    t = isect.moller_trumbore(origin, direction, tri, eps)
    # where the kernel found no hit (or the recompute disagrees at an edge),
    # keep the non-differentiable verdict
    t = jnp.where((idx >= 0) & jnp.isfinite(t), t, jnp.inf)
    return t, idx


def render_radiance_diff(prep_or_scene, cfg: RenderConfig, light_pos,
                         origin=None, direction=None, apex: bool = False):
    """Differentiable float render through the configured fast intersector.

    Same output contract as render.renderer.render_radiance ([H,W,3] radiance
    + [H,W] hit mask, or flat [R,...] when origin/direction are given), but
    every mode — including 'bvh' and 'tiled' — carries gradients to scene
    parameters via the fixed-topology recompute.

    ``apex``: assert the rays share ONE origin (primary-camera bundles —
    also true for every shard of one) so the tiled intersector may use the
    projective pixel-space cull; UNSOUND for mixed-origin rays.
    """
    from ..accel.prepared import PreparedScene
    from ..render.renderer import brute_force_hits, brute_force_shadow
    from ..ops.camera import primary_rays

    cam = cfg.camera
    flat = origin is not None
    if not flat:
        o, d = primary_rays(cam.width, cam.height, cam.focal,
                            cam.normalize_dirs)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    else:
        o, d = origin, direction
    light_pos = jnp.asarray(light_pos, dtype=d.dtype)

    is_prep = isinstance(prep_or_scene, PreparedScene)
    scene = prep_or_scene.scene if is_prep else prep_or_scene
    verts_cart = scene.verts_cart()

    if cfg.mode == "bruteforce":
        sc = scene
        hit_fn = lambda oo, dd: brute_force_hits(sc, oo, dd, cfg.mt_eps)
        shadow_fn = brute_force_shadow(
            sc, cfg.mt_eps, cfg.light.shadow_no_max_t) \
            if cfg.light.enable_shadows else None
    elif cfg.mode == "bvh":
        from ..accel import traverse
        # the fast intersector is non-differentiable: freeze its operand so
        # no JVP tracer reaches the while-loop/kernel internals
        prep = jax.lax.stop_gradient(prep_or_scene)
        hit_fn = lambda oo, dd: traverse.bvh_hits(prep, oo, dd, cfg.mt_eps)
        shadow_fn = traverse.bvh_shadow_fn(
            prep, cfg.mt_eps, cfg.light.shadow_no_max_t) \
            if cfg.light.enable_shadows else None
    elif cfg.mode == "tiled":
        from ..kernels import tiled
        prep = jax.lax.stop_gradient(prep_or_scene)
        tile = tiled._hit_tile(cfg, tiled.effective_tile_px(cfg) ** 2)
        apx = apex or not flat       # self-generated rays ARE primaries
        hit_fn = lambda oo, dd: tiled.hits(prep, oo, dd, tile, cfg.mt_eps,
                                           cfg.cull_maxv, apex=apx,
                                           kernel=cfg.kernel)
        shadow_fn = tiled.tiled_shadow_fn(
            prep, tile, cfg.mt_eps, cfg.cull_maxv,
            cfg.light.shadow_no_max_t, cfg.light.num_samples,
            kernel=cfg.kernel) if cfg.light.enable_shadows else None
    else:
        raise ValueError(f"unknown render mode: {cfg.mode}")

    if shadow_fn is not None:
        nd_shadow = shadow_fn
        shadow_fn = lambda p, l, s, hit=None: jax.lax.stop_gradient(
            nd_shadow(jax.lax.stop_gradient(p), jax.lax.stop_gradient(l), s,
                      hit=hit))
    lean = (not bool(scene.has_textures) and not cfg.shading.smooth_normals
            and scene.obj_color.shape[0] <= 8 and scene.verts.shape[0] > 0)
    if lean:
        # ONE-gather/ONE-scatter backward: the default path does a verts
        # gather (MT recompute) PLUS an [R, K] record gather whose material
        # columns are pre-expanded per triangle — in the backward each
        # gather transposes to an [R]->[T] scatter and the materials pay
        # scatter+reduce.  Here: one [T, 13] table (verts 9, flat normal 3, obj 1 — only
        # the verts columns carry gradients), one [R, 13] gather, and
        # materials resolved by the unrolled per-object select (grads flow
        # to obj_color/... through elementwise where + a reduce, no
        # triangle-sized scatter at all).
        t_nd, tri_idx = jax.lax.stop_gradient(
            hit_fn(jax.lax.stop_gradient(o), jax.lax.stop_gradient(d)))
        idxc = jnp.maximum(tri_idx, 0)
        table = jnp.concatenate(
            [verts_cart.reshape(-1, 9),
             jax.lax.stop_gradient(scene.tri_normal),
             jax.lax.stop_gradient(
                 scene.tri_obj.astype(jnp.float32))[:, None]], axis=1)
        packed = table[idxc]
        tri = packed[:, :9].reshape(-1, 3, 3)
        t = isect.moller_trumbore(o, d, tri, cfg.mt_eps)
        t = jnp.where((tri_idx >= 0) & jnp.isfinite(t), t, jnp.inf)
        obj = jnp.round(packed[:, 12]).astype(jnp.int32)
        record = {"obj": obj,
                  "tex_id": jnp.full(obj.shape, -1, jnp.int32),
                  "normal": packed[:, 9:12]}
        record.update(integrator.material_select(scene, obj))
        radiance = integrator.shade(scene, cfg, o, d, t, tri_idx,
                                    light_pos, shadow_fn, record=record)
    else:
        t, tri_idx = differentiable_hits(hit_fn, verts_cart, o, d,
                                         cfg.mt_eps)
        radiance = integrator.shade(scene, cfg, o, d, t, tri_idx, light_pos,
                                    shadow_fn)
    hit = jnp.isfinite(t)
    if flat:
        return radiance, hit
    H, W = cam.height, cam.width
    return radiance.reshape(H, W, 3), hit.reshape(H, W)
