"""Primary-ray generation: pinhole camera at the view-space origin.

Reference (simple_raytracer.cpp:505-525): for pixel column i ∈ [-W/2, W/2) and
row j ∈ [-H/2, H/2), ray direction = (i, j, focal) with focal = 400
(= focal length in pixels, :506), origin (0,0,0), directions NOT normalized.
World→view is handled by pre-baking inverse(viewMatrix) into the geometry and
light (:558, :778), so the camera itself never moves.

Image convention: output[row, col] with row = j + H/2, col = i + W/2 (CImg
top-left origin, :517).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def primary_rays(width: int, height: int, focal: float = 400.0,
                 normalize: bool = False, dtype=jnp.float32):
    """Generate all primary rays for a W x H image.

    Returns (origins [H, W, 3], directions [H, W, 3]) with directions
    (i, j, focal); row-major image layout.
    """
    i = jnp.arange(-(width // 2), width - width // 2, dtype=dtype)     # columns
    j = jnp.arange(-(height // 2), height - height // 2, dtype=dtype)  # rows
    ii, jj = jnp.meshgrid(i, j)          # [H, W]
    d = jnp.stack([ii, jj, jnp.full_like(ii, focal)], axis=-1)
    if normalize:
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.zeros_like(d)
    return o, d


def primary_rays_tiled(width: int, height: int, tile_px: int,
                       focal: float = 400.0, normalize: bool = False,
                       dtype=jnp.float32, view_matrix=None):
    """Primary rays directly in 2D-TILE-MAJOR order (pure iota arithmetic).

    The tiled renderer needs rays grouped by square pixel tiles.  Gathering
    row-major rays through a permutation costs ~3 full-array gathers per
    frame (o, d in; radiance out); generating them tile-major is free, and
    the OUTPUT permutation becomes a reshape/transpose (sequential
    relayout, no gather) in the caller.

    Ragged sizes are padded UP to tile multiples with real out-of-frame
    rays (pixel coords beyond width/height; the caller slices the padded
    image back to [H, W]).  Pixel->direction mapping is identical to
    :func:`primary_rays` (direction (i - W//2, j - H//2, focal)).

    Returns (o [Rp, 3], d [Rp, 3], tx, ty) with Rp = tx*ty*tile_px^2 and
    flat index = ((tyi*tx + txi)*tile_px + y_in_tile)*tile_px + x_in_tile.
    """
    tx = -(-width // tile_px)
    ty = -(-height // tile_px)
    n = tx * ty * tile_px * tile_px
    idx = jnp.arange(n, dtype=jnp.int32)
    tp2 = tile_px * tile_px
    tile_id = idx // tp2
    r = idx % tp2
    py = (tile_id // tx) * tile_px + r // tile_px
    px = (tile_id % tx) * tile_px + r % tile_px
    i = px.astype(dtype) - (width // 2)
    j = py.astype(dtype) - (height // 2)
    d = jnp.stack([i, j, jnp.full_like(i, focal)], axis=-1)
    if view_matrix is not None:
        V = jnp.asarray(view_matrix, dtype=dtype)
        d = jnp.matmul(d, V[:3, :3].T, precision=jax.lax.Precision.HIGHEST)
        o = jnp.broadcast_to(V[:3, 3], d.shape)
    else:
        o = jnp.zeros_like(d)
    if normalize:
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, tx, ty


def untile_image(flat: jnp.ndarray, width: int, height: int, tile_px: int,
                 tx: int, ty: int) -> jnp.ndarray:
    """Tile-major flat results [Rp, ...] -> row-major [H, W, ...] (inverse
    of primary_rays_tiled's ordering; reshape/transpose, no gather)."""
    trail = flat.shape[1:]
    img = flat.reshape((ty, tx, tile_px, tile_px) + trail)
    img = jnp.moveaxis(img, 2, 1)            # [ty, tile_px, tx, tile_px, ...]
    img = img.reshape((ty * tile_px, tx * tile_px) + trail)
    return img[:height, :width]


def primary_rays_world(width: int, height: int, view_matrix: jnp.ndarray,
                       focal: float = 400.0, normalize: bool = False,
                       dtype=jnp.float32):
    """World-space primary rays for a camera described by ``view_matrix``
    (Transformation.cpp:84-90 convention: T(pos)*Rz*Ry*Rx; rigid).

    The reference moves the WORLD into view space every frame — it bakes
    inverse(viewMatrix) into all geometry and the light
    (simple_raytracer.cpp:558,778), forcing a full host rebuild + BVH rebuild
    per frame (SURVEY.md §3.1).  The inverse used here: geometry and its BVH
    stay static in world space, and the RAYS move —
    origin = V[:3,3], direction = V[:3,:3] @ (i, j, focal).  For a rigid V
    the hit parameters t and all shading dot products are identical, so
    images match the reference bit-for-near-bit while the per-frame cost
    becomes pure device compute.
    """
    o, d = primary_rays(width, height, focal, normalize=False, dtype=dtype)
    V = jnp.asarray(view_matrix, dtype=dtype)
    d = jnp.einsum("ij,hwj->hwi", V[:3, :3], d,
                   precision=jax.lax.Precision.HIGHEST)
    if normalize:
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(V[:3, 3], d.shape)
    return o, d
