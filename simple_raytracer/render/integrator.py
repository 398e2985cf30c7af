"""Shared shading integrator: hit records -> final pixel radiance.

Implements the reference's softShadow/phong/tonemap stack
(simple_raytracer.cpp:348-401) over flat ray arrays, parameterized by the
intersection backend (brute force / BVH / Pallas) through ``shadow_fn``.

Shade-on-improve note: the reference re-shades on every improved hit
(:428-445); the final written color is always the min-t winner, so shading once
at the argmin is output-equivalent, and shades each ray once.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import shading as sh


def light_sample_positions(light_pos, num_samples: int, jitter_step: float):
    """Soft-shadow light sample positions (simple_raytracer.cpp:362-383).

    The reference mutates the light cumulatively, +jitter on x, y, z in
    rotation AFTER each sample, so sample 0 is the base light.  Returns
    [S, 3].
    """
    offsets = np.zeros((num_samples, 3), dtype=np.float32)
    acc = np.zeros(3, dtype=np.float32)
    for s in range(num_samples):
        offsets[s] = acc
        acc[s % 3] += jitter_step
    return light_pos[None, :] + jnp.asarray(offsets)


def gather_hit_records(scene, tri_idx: jnp.ndarray, cfg=None) -> dict:
    """Gather per-ray triangle data from the scene by global triangle index.

    The record dict is the unit the shading core consumes; the ring
    geometry-sharded renderer (dist/ring.py) builds the same records by
    carrying them around the device ring instead of gathering.

    Two tricks keep this ray-sized stage cheap: (1) only what the config
    actually uses is fetched — flat-shaded untextured scenes (the common
    case) need just the precomputed 3-float normal and two id columns
    instead of 9 vertices + 9 vertex normals + 6 UVs; (2) all needed
    per-triangle columns are first PACKED into one [T, K] table
    (triangle-count-sized concat, trivial) so the ray-sized cost is ONE
    row gather instead of 2-5.  Ids ride as f32 lanes (exact below 2^24).
    """
    idx = jnp.maximum(tri_idx, 0)
    smooth = bool(cfg.shading.smooth_normals) if cfg is not None else True
    textured = scene.has_textures                   # static flag (Scene aux)
    tobj = scene.tri_obj
    cols = [tobj.astype(jnp.float32)[:, None],
            scene.tri_tex.astype(jnp.float32)[:, None],
            # per-OBJECT material tables pre-expanded per triangle
            # (triangle-count-sized gathers, trivial) so shading pays no
            # separate per-RAY material gathers
            scene.obj_color[tobj],
            scene.obj_ambient[tobj][:, None],
            scene.obj_specular[tobj][:, None],
            scene.obj_shininess[tobj][:, None]]
    if smooth or textured:
        cols.append(scene.verts_cart().reshape(-1, 9))
    if smooth:
        cols.append(scene.vnormals.reshape(-1, 9))
    else:
        cols.append(scene.tri_normal)
    if textured:
        cols.append(scene.uvs.reshape(-1, 6))
    packed = jnp.concatenate(cols, axis=1)[idx]     # ONE [R, K] gather
    rec = {
        "obj": packed[:, 0].astype(jnp.int32),      # [R]
        "tex_id": packed[:, 1].astype(jnp.int32),   # [R]
        "color": packed[:, 2:5],                    # [R, 3]
        "ambient": packed[:, 5],                    # [R]
        "specular": packed[:, 6],                   # [R]
        "shininess": packed[:, 7],                  # [R]
    }
    c = 8
    if smooth or textured:
        rec["tri_v"] = packed[:, c:c + 9].reshape(-1, 3, 3)
        c += 9
    if smooth:
        rec["vnormals"] = packed[:, c:c + 9].reshape(-1, 3, 3)
        c += 9
    else:
        rec["normal"] = packed[:, c:c + 3]
        c += 3
    if textured:
        rec["uvs"] = packed[:, c:c + 6].reshape(-1, 3, 2)
    return rec


def shade_records(scene, cfg: RenderConfig, record: dict, origin: jnp.ndarray,
                  direction: jnp.ndarray, t: jnp.ndarray,
                  light_pos: jnp.ndarray,
                  shadow_fn: Optional[Callable] = None) -> jnp.ndarray:
    """Shading core over explicit per-ray hit records.

    ``scene`` supplies only the small replicated tables (object materials +
    texture atlas); all triangle-indexed data comes from ``record``.
    """
    scfg, lcfg = cfg.shading, cfg.light
    obj = jnp.maximum(record["obj"], 0)
    tex_id = record["tex_id"]
    has_atlas = scene.has_textures                     # static flag

    # miss rays carry t = +inf; an inf FORWARD value poisons every gradient
    # that flows through its chain (inf * 0 = NaN in the VJP) even though
    # the shaded value is discarded by the hit mask downstream — pin t to 0
    # for misses (their radiance is garbage either way; hit gating below
    # keys off the ORIGINAL t)
    hit_mask = jnp.isfinite(t)
    t = jnp.where(hit_mask, t, 0.0)

    point = origin + t[..., None] * direction          # :156, :351

    bary = None
    if (has_atlas and "uvs" in record) or scfg.smooth_normals:
        bary = sh.barycentric(record["tri_v"], point)

    # Base color: object color, or texture fetch when textured (:348-361,
    # :437-443).  tri_color (vertex-0 sample) is only visible when a texture
    # name exists but the texel fetch is unavailable — reproduced via where.
    # material values ride the packed per-triangle record when present
    # (ONE ray-sized gather total — see gather_hit_records); records built
    # elsewhere (e.g. the ring renderer) fall back to per-ray obj gathers
    _ms = None
    if (("color" not in record) or ("ambient" not in record)) \
            and scene.obj_color.shape[0] <= 8:
        _ms = material_select(scene, obj)    # no per-ray gathers
    if "color" in record:
        base_color = record["color"]
    elif _ms is not None:
        base_color = _ms["color"]
    else:
        base_color = scene.obj_color[obj]
    if has_atlas and "uvs" in record:
        textured = tex_id >= 0
        texel = sh.interpolate_uv(record["uvs"], bary)
        tex_rgb = sh.texture_fetch(scene.tex_data, scene.tex_offset,
                                   scene.tex_width, scene.tex_height,
                                   tex_id, texel)
        color_in = jnp.where(textured[..., None], tex_rgb, base_color)
    else:
        color_in = base_color

    if scfg.smooth_normals:
        normal = sh.smooth_normal(record["vnormals"], bary)
    elif "normal" in record:
        normal = record["normal"]                      # precomputed flat
    else:
        normal = sh.flat_normal(record["tri_v"])

    if "ambient" in record:
        ambient = record["ambient"]
        specular = record["specular"]
        shininess = record["shininess"]
    elif _ms is not None:
        ambient, specular, shininess = (_ms["ambient"], _ms["specular"],
                                        _ms["shininess"])
    else:
        ambient = scene.obj_ambient[obj]
        specular = scene.obj_specular[obj]
        shininess = scene.obj_shininess[obj]
    light_color = jnp.asarray(lcfg.color, dtype=point.dtype)

    samples = light_sample_positions(light_pos, lcfg.num_samples, lcfg.jitter_step)
    S = lcfg.num_samples
    R = point.shape[0]

    # Reference shadow rule: the hit object's OWN triangles are skipped
    # entirely (simple_raytracer.cpp:331), so a single-object scene can never
    # be shadowed — drop the whole occlusion pass (exact, and worth a third
    # of the frame on single-mesh benchmarks).
    if scene.obj_color.shape[0] <= 1:
        shadow_fn = None

    shadowed_all = None
    if shadow_fn is not None and lcfg.enable_shadows:
        # ONE batched occlusion query for all S light samples (S separate
        # launches would re-cull and re-walk the scene per sample).
        # Miss rays shade at the camera origin (t pinned above); pin their
        # occlusion-query origin to 0 so the tiled backend's tile-level
        # cull bounds see the hit mask, not stray camera points.
        point_safe = jnp.where(hit_mask[..., None], point, 0.0)
        pts = jnp.broadcast_to(point_safe[None], (S, R, 3)).reshape(S * R, 3)
        lps = jnp.broadcast_to(samples[:, None, :], (S, R, 3)).reshape(S * R, 3)
        objs = jnp.broadcast_to(obj[None], (S, R)).reshape(S * R)
        hits = jnp.broadcast_to(hit_mask[None], (S, R)).reshape(S * R)
        # Explicit backend contract: shadow_fn(point, light, self_obj,
        # hit=None) -> bool [R].  ``hit`` marks rays whose origin is a real
        # surface point; backends may use it to skip/repair work for miss
        # rays (their occlusion result is discarded by the shader anyway).
        shadowed_all = shadow_fn(pts, lps, objs, hit=hits).reshape(S, R)

    accum = jnp.zeros_like(point)
    for s in range(S):
        lpos = jnp.broadcast_to(samples[s], point.shape)
        c = sh.phong(normal, point, direction, lpos, light_color, color_in,
                     ambient, specular, shininess,
                     double_sided=scfg.double_sided_diffuse,
                     specular_nl=scfg.specular_nl_factor)
        if shadowed_all is not None:
            c = jnp.where(shadowed_all[s][..., None], c / lcfg.shadow_dim,
                          c)                                          # :369
        accum = accum + c

    if scfg.tonemap_enabled:
        accum = sh.tonemap(accum, scfg.reinhard_offset, scfg.gamma)
    return accum


def material_select(scene, obj: jnp.ndarray) -> dict:
    """Per-ray material record via an UNROLLED small-table select (O is
    small in every reference scene).  Differentiable to the obj_* tables
    through elementwise where + reduces — no per-ray gather, so the
    backward has no serialized [R]->[T] scatter (the per-triangle
    pre-expansion of gather_hit_records costs one in AD's transpose)."""
    O = scene.obj_color.shape[0]
    R = obj.shape[0]
    color = jnp.zeros((R, 3), scene.obj_color.dtype)
    amb = jnp.zeros((R,), scene.obj_ambient.dtype)
    spec = jnp.zeros((R,), scene.obj_specular.dtype)
    shin = jnp.zeros((R,), scene.obj_shininess.dtype)
    for o in range(O):
        m = obj == o
        color = jnp.where(m[:, None], scene.obj_color[o], color)
        amb = jnp.where(m, scene.obj_ambient[o], amb)
        spec = jnp.where(m, scene.obj_specular[o], spec)
        shin = jnp.where(m, scene.obj_shininess[o], shin)
    return {"color": color, "ambient": amb, "specular": spec,
            "shininess": shin}


def shade(scene, cfg: RenderConfig, origin: jnp.ndarray, direction: jnp.ndarray,
          t: jnp.ndarray, tri_idx: jnp.ndarray, light_pos: jnp.ndarray,
          shadow_fn: Optional[Callable] = None,
          record: Optional[dict] = None) -> jnp.ndarray:
    """Shade flat rays given nearest-hit indices (gather + shading core).

    Args:
      origin/direction: [R, 3] rays (unnormalized directions).
      t: [R] hit distance (+inf = miss).
      tri_idx: [R] global triangle index (-1 = miss; clamped for gathers).
      light_pos: [3] base light position (already in view space, :776-778).
      shadow_fn: (point [R,3], light [R,3], self_obj [R]) -> bool [R] shadowed.
        None disables shadows (reference toggle :385-386).

    Returns [R, 3] tone-mapped radiance in [0,1] (pre-quantization); misses
    hold garbage — mask with ``t < inf`` downstream.
    """
    if scene.verts.shape[0] == 0 or scene.obj_color.shape[0] == 0:
        # empty scene (missing-OBJ soft failure): nothing to shade; the hit
        # mask is all-False so finalize_image paints pure background
        return jnp.zeros_like(origin)
    if record is None:
        record = gather_hit_records(scene, tri_idx, cfg)
    return shade_records(scene, cfg, record, origin, direction, t, light_pos,
                         shadow_fn)


def finalize_image(radiance: jnp.ndarray, hit: jnp.ndarray,
                   cfg: RenderConfig) -> jnp.ndarray:
    """Quantize + background fill -> [H, W, 3] uint8.

    Reproduces: int(c*255) truncation (:447-449); pixels that are missed OR
    shade to exactly (0,0,0) become light blue (173,216,230) (:476-487).
    """
    q = sh.quantize_255(radiance) if cfg.shading.quantize_truncate \
        else jnp.round(radiance * 255.0)
    q = jnp.where(hit[..., None], q, 0.0)
    is_black = jnp.all(q == 0.0, axis=-1)
    bg = jnp.asarray(cfg.background, dtype=q.dtype)
    out = jnp.where(is_black[..., None], bg, q)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)
