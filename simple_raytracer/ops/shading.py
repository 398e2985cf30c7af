"""Shading ops: barycentric coords, normals, Phong, texture fetch, tone map.

jnp reference implementations of the reference's shading stack
(simple_raytracer.cpp:79-200, :348-401).  All ops are elementwise over rays and
fully differentiable (texture fetch is a gather whose VJP is a scatter-add onto
the atlas).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INV_PI = 1.0 / jnp.pi


def barycentric(verts_cart: jnp.ndarray, point: jnp.ndarray) -> jnp.ndarray:
    """Dot-product (Ericson) barycentric coordinates
    (simple_raytracer.cpp:79-117).  Returns [..., 3] = (u, v, w) with
    ``point ≈ u*p1 + v*p2 + w*p3``."""
    p1 = verts_cart[..., 0, :]
    v0 = verts_cart[..., 1, :] - p1
    v1 = verts_cart[..., 2, :] - p1
    v2 = point - p1
    d00 = jnp.sum(v0 * v0, axis=-1)
    d01 = jnp.sum(v0 * v1, axis=-1)
    d11 = jnp.sum(v1 * v1, axis=-1)
    d20 = jnp.sum(v2 * v0, axis=-1)
    d21 = jnp.sum(v2 * v1, axis=-1)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    return jnp.stack([u, v, w], axis=-1)


def flat_normal(verts_cart: jnp.ndarray) -> jnp.ndarray:
    """Geometric normal: normalize(cross(p2-p1, p3-p1))
    (simple_raytracer.cpp:32-37).  This is the reference's ACTIVE normal path;
    it is NOT flipped toward the ray."""
    v1 = verts_cart[..., 1, :] - verts_cart[..., 0, :]
    v2 = verts_cart[..., 2, :] - verts_cart[..., 0, :]
    n = jnp.cross(v1, v2)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def smooth_normal(vnormals: jnp.ndarray, bary: jnp.ndarray) -> jnp.ndarray:
    """Vertex-normal interpolation (simple_raytracer.cpp:132-140; commented out
    in the reference at :162-163, exposed here behind
    ShadingConfig.smooth_normals)."""
    n = jnp.einsum("...v,...vk->...k", bary, vnormals,
                   precision=jax.lax.Precision.HIGHEST)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def reflect(incident: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """glm::reflect: I - 2*dot(N, I)*N."""
    return incident - 2.0 * jnp.sum(normal * incident, axis=-1, keepdims=True) * normal


def phong(normal: jnp.ndarray, point: jnp.ndarray, ray_dir: jnp.ndarray,
          light_pos: jnp.ndarray, light_color: jnp.ndarray,
          obj_color: jnp.ndarray, ambient_strength: jnp.ndarray,
          specular_strength: jnp.ndarray, shininess: jnp.ndarray,
          double_sided: bool = True,
          specular_nl: bool = True) -> jnp.ndarray:
    """Phong illumination (simple_raytracer.cpp:144-200).

    Reference quirks reproduced:
      * diffuse uses abs(n·l) — double-sided shading (:174-178)
      * ambient = (1/π)·ambientStrength·objColor·lightColor (:184)
      * specular carries an EXTRA abs(n·l) factor and no objColor (:196)
      * no distance falloff
    """
    l = light_pos - point
    l = l / jnp.linalg.norm(l, axis=-1, keepdims=True)
    nl = jnp.sum(normal * l, axis=-1, keepdims=True)
    nl = jnp.abs(nl) if double_sided else jnp.maximum(nl, 0.0)
    diffuse = INV_PI * obj_color * light_color * nl
    ambient = INV_PI * ambient_strength[..., None] * obj_color * light_color
    v = -ray_dir / jnp.linalg.norm(ray_dir, axis=-1, keepdims=True)
    r = reflect(-l, normal)
    rv = jnp.maximum(jnp.sum(r * v, axis=-1, keepdims=True), 0.0)
    nl_factor = nl if specular_nl else 1.0      # :196 quirk, toggleable
    specular = (light_color * specular_strength[..., None] * nl_factor *
                jnp.power(rv, shininess[..., None]))
    return diffuse + specular + ambient


def texture_fetch(tex_data: jnp.ndarray, tex_offset: jnp.ndarray,
                  tex_width: jnp.ndarray, tex_height: jnp.ndarray,
                  tex_id: jnp.ndarray, texel: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbor texel fetch from the flat atlas.

    ``texel`` [..., 2] holds interpolated texel-space coordinates; like the
    reference they are truncated to int with no shade-time wrap
    (simple_raytracer.cpp:350-361; wrap was baked per-vertex at load).  Indices
    are clamped to the texture rectangle for memory safety.
    """
    tid = jnp.maximum(tex_id, 0)
    w = tex_width[tid]
    h = tex_height[tid]
    x = jnp.clip(texel[..., 0].astype(jnp.int32), 0, w - 1)
    y = jnp.clip(texel[..., 1].astype(jnp.int32), 0, h - 1)
    idx = tex_offset[tid] + y * w + x
    return tex_data[idx]


def interpolate_uv(uvs: jnp.ndarray, bary: jnp.ndarray) -> jnp.ndarray:
    """Barycentric interpolation of baked texel coords
    (simple_raytracer.cpp:121-128)."""
    return jnp.einsum("...v,...vk->...k", bary, uvs,
                      precision=jax.lax.Precision.HIGHEST)


def tonemap(color: jnp.ndarray, reinhard_offset: float = 0.5,
            gamma: float = 1.1) -> jnp.ndarray:
    """Reinhard variant c/(c+offset) then gamma pow(c, gamma)
    (simple_raytracer.cpp:389-398).  Applied inside the shading of each hit,
    BEFORE quantization — matching the reference's ordering."""
    c = color / (color + reinhard_offset)
    return jnp.power(jnp.maximum(c, 0.0), gamma)


def quantize_255(color: jnp.ndarray) -> jnp.ndarray:
    """int(c*255) truncation (simple_raytracer.cpp:447-449), kept as float."""
    return jnp.trunc(color * 255.0)
