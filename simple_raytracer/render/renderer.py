"""Renderer front-end: mode dispatch + the brute-force jnp oracle.

Modes (RenderConfig.mode):
  * 'bruteforce' — all ray x triangle pairs, pure jnp.  The correctness oracle
    and the differentiable path; fine for small scenes (config 1/2 class).
  * 'bvh'        — stackless flattened-BVH traversal in jnp (accel/).
  * 'tiled'      — the GPU path (kernels/): per-tile block culling + the
    Triton window walk.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import intersect as isect
from ..ops.camera import primary_rays
from . import integrator


def brute_force_hits(scene, origin: jnp.ndarray, direction: jnp.ndarray,
                     eps: float = 1e-12, chunk: int = 0):
    """Nearest hit of flat rays [R,3] against ALL triangles. Returns (t, idx)."""
    verts = scene.verts_cart()
    if verts.shape[0] == 0:
        # empty scene (missing-OBJ soft failure, Object.cpp:35-39): every ray
        # misses and the frame becomes pure background
        R = origin.shape[0]
        return (jnp.full((R,), jnp.inf, origin.dtype),
                jnp.full((R,), -1, jnp.int32))

    def hits(o, d):
        ts = isect.moller_trumbore(o[:, None, :], d[:, None, :],
                                   verts[None, :, :, :], eps)   # [r, T]
        idx = jnp.argmin(ts, axis=-1).astype(jnp.int32)
        t = jnp.take_along_axis(ts, idx[:, None], axis=-1)[:, 0]
        return t, jnp.where(jnp.isinf(t), -1, idx)

    if chunk and origin.shape[0] > chunk:
        n = origin.shape[0] // chunk
        o = origin[: n * chunk].reshape(n, chunk, 3)
        d = direction[: n * chunk].reshape(n, chunk, 3)
        t, i = jax.lax.map(lambda od: hits(od[0], od[1]), (o, d))
        t, i = t.reshape(-1), i.reshape(-1)
        if n * chunk < origin.shape[0]:
            t2, i2 = hits(origin[n * chunk:], direction[n * chunk:])
            t, i = jnp.concatenate([t, t2]), jnp.concatenate([i, i2])
        return t, i
    return hits(origin, direction)


def brute_force_shadow(scene, eps: float = 1e-12, no_max_t: bool = True):
    """Shadow predicate: any triangle of any OTHER object between... anywhere.

    Reference semantics (simple_raytracer.cpp:321-342): shadow ray origin =
    hit point, direction = lightPos - hitPoint (unnormalized); ANY valid MT hit
    (t >= 0, no max-t!) on a different object means shadow.
    ``no_max_t=False`` is the sane-physics toggle (LightConfig.shadow_no_max_t).
    """
    verts = scene.verts_cart()

    def shadow_fn(point, light, self_obj, hit=None):
        if verts.shape[0] == 0:
            return jnp.zeros(point.shape[:1], jnp.bool_)
        d = light - point
        ts = isect.moller_trumbore(point[:, None, :], d[:, None, :],
                                   verts[None, :, :, :], eps)   # [R, T]
        other = scene.tri_obj[None, :] != self_obj[:, None]
        occ = jnp.isfinite(ts) & other
        if not no_max_t:
            # non-reference mode: occluders BEYOND the light (t > 1 on the
            # unnormalized light-point segment) do not shadow
            occ = occ & (ts <= 1.0)
        return jnp.any(occ, axis=-1)

    return shadow_fn


def render_flat(scene, cfg: RenderConfig, origin, direction, light_pos,
                shadow_fn=None, hit_fn=None):
    """Render flat rays -> (radiance [R,3], hit [R])."""
    if hit_fn is None:
        hit_fn = functools.partial(brute_force_hits, eps=cfg.mt_eps)
    if shadow_fn is None and cfg.light.enable_shadows:
        shadow_fn = brute_force_shadow(scene, eps=cfg.mt_eps,
                                       no_max_t=cfg.light.shadow_no_max_t)
    t, tri_idx = hit_fn(scene, origin, direction)
    radiance = integrator.shade(scene, cfg, origin, direction, t, tri_idx,
                                light_pos, shadow_fn)
    return radiance, jnp.isfinite(t)


def _map_ray_chunks(body, o, d, chunk: int):
    """Serialize flat rays through ``body`` in fixed-size chunks (lax.map).

    Bounds the live per-ray scratch (leaf-window gathers are O(R * max_leaf *
    9) floats if unchunked — 34 GB at 1080p) while keeping each chunk large
    enough to saturate the chip.  Pads with the last ray; harmless dup work.
    """
    R = o.shape[0]
    if chunk <= 0 or R <= chunk:
        return body(o, d)
    from ..utils import pad_rays
    o, d, _ = pad_rays(o, d, chunk)
    n = o.shape[0] // chunk
    rad, hit = jax.lax.map(
        lambda od: body(od[0], od[1]),
        (o.reshape(n, chunk, 3), d.reshape(n, chunk, 3)))
    return rad.reshape(-1, 3)[:R], hit.reshape(-1)[:R]


@functools.lru_cache(maxsize=64)
def _render_jit(cfg: RenderConfig, with_view: bool):
    def f(scene, light_pos, view_matrix):
        radiance, hit = render_radiance(scene, cfg, light_pos, view_matrix)
        return integrator.finalize_image(radiance, hit, cfg)
    if with_view:
        return jax.jit(f)
    return jax.jit(lambda scene, light_pos: f(scene, light_pos, None))


def ensure_prepared(scene, cfg: RenderConfig):
    """Host step: build BVH/blocks when the mode needs them (idempotent)."""
    from ..accel.prepared import PreparedScene, prepare
    if cfg.mode == "bruteforce" or isinstance(scene, PreparedScene):
        return scene
    return prepare(scene, cfg)


def render(scene, cfg: RenderConfig, light_pos,
           view_matrix=None) -> jnp.ndarray:
    """Full-frame render -> [H, W, 3] uint8 (background-filled, quantized).

    Jitted and cached per config (RenderConfig is frozen/hashable); repeat
    frames with the same config recompile nothing.  Accepts a Scene or a
    PreparedScene; BVH modes auto-prepare (host-side) when given a raw Scene.
    With ``view_matrix`` (4x4, Transformation.cpp:84-90 convention) the camera
    moves in world space and the scene/BVH stays static (see
    ops/camera.primary_rays_world).
    """
    scene = ensure_prepared(scene, cfg)
    light = jnp.asarray(light_pos, dtype=jnp.float32)
    if view_matrix is None:
        return _render_jit(cfg, False)(scene, light)
    return _render_jit(cfg, True)(
        scene, light, jnp.asarray(view_matrix, jnp.float32))


def render_radiance(scene, cfg: RenderConfig, light_pos, view_matrix=None
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Float render -> (radiance [H, W, 3] in [0,1], hit [H, W]).

    The differentiable output: no quantization, no background fill.
    """
    cam = cfg.camera
    if cfg.mode == "tiled":
        # rays generated directly in 2D-tile-major order (iota math; the
        # output permutation is a reshape/transpose): square pixel tiles
        # give far tighter per-tile cull bounds than row slivers
        from ..kernels.tiled import effective_tile_px
        tpx = effective_tile_px(cfg)
        from ..ops.camera import primary_rays_tiled
        o, d, _tx, _ty = primary_rays_tiled(
            cam.width, cam.height, tpx, cam.focal,
            cam.normalize_dirs, view_matrix=view_matrix)
    elif view_matrix is None:
        o, d = primary_rays(cam.width, cam.height, cam.focal,
                            cam.normalize_dirs)
    else:
        from ..ops.camera import primary_rays_world
        o, d = primary_rays_world(cam.width, cam.height, view_matrix,
                                  cam.focal, cam.normalize_dirs)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    light_pos = jnp.asarray(light_pos, dtype=d.dtype)

    from ..accel.prepared import PreparedScene
    if cfg.mode == "bruteforce":
        if isinstance(scene, PreparedScene):
            scene = scene.scene
        body = lambda oo, dd: render_flat(scene, cfg, oo, dd, light_pos)
    elif cfg.mode in ("bvh", "tiled"):
        if not isinstance(scene, PreparedScene):
            raise TypeError(
                f"mode '{cfg.mode}' needs a PreparedScene inside jit; call "
                "accel.prepare(scene, cfg) (or the unjitted render()) first")
        if cfg.mode == "bvh":
            from ..accel import traverse
            body = lambda oo, dd: traverse.render_flat_bvh(
                scene, cfg, oo, dd, light_pos)
        else:
            from ..kernels import tiled
            body = lambda oo, dd: tiled.render_flat_tiled(
                scene, cfg, oo, dd, light_pos)
    else:
        raise ValueError(f"unknown render mode: {cfg.mode}")
    H, W = cam.height, cam.width
    if cfg.mode == "tiled":
        # no ray chunking: the walk's memory is O(rays); rays are already
        # tile-major (above) and the inverse permutation is a reshape
        from ..ops.camera import untile_image
        radiance_t, hit_t = body(o, d)
        radiance = untile_image(radiance_t.reshape(-1, 3), W, H,
                                tpx, _tx, _ty)
        hit = untile_image(hit_t.reshape(-1), W, H, tpx, _tx, _ty)
        return radiance, hit

    radiance, hit = _map_ray_chunks(body, o, d, cfg.ray_chunk)
    return radiance.reshape(H, W, 3), hit.reshape(H, W)
