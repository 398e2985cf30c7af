"""PreparedScene: Scene + flattened BVH + triangle blocks, ready for device.

``prepare`` is a HOST step (numpy BVH build; cannot run under jit).  The
result is a pytree, so it passes straight into jitted render functions; the
static geometry metadata (node count, block count, max leaf size) lives in
aux_data so tracing specializes on it.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..scene.scene import Scene
from .bvh import build_bvh, concat_bvhs, triangle_blocks


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PreparedScene:
    """Scene in BVH order + acceleration arrays (all device-resident)."""

    scene: Scene              # triangle arrays permuted leaf-contiguous, padded
    node_min: jnp.ndarray     # [M, 3]
    node_max: jnp.ndarray     # [M, 3]
    skip: jnp.ndarray         # [M]
    leaf_first: jnp.ndarray   # [M]
    leaf_count: jnp.ndarray   # [M]
    block_min: jnp.ndarray    # [NB, 3] — cull-granularity AABBs (block_size
                              # consecutive triangles each)
    block_max: jnp.ndarray    # [NB, 3]
    block_obj: jnp.ndarray    # [NB] i32 — the object id of the block's real
                              # triangles (blocks are single-object by
                              # construction).  Lets shadow culling drop a
                              # tile's own object wholesale (the reference
                              # rule: own-object triangles never occlude,
                              # simple_raytracer.cpp:331).
    geom: jnp.ndarray         # [GEOM_ROWS, T] f32 — the walk kernels'
                              # triangle rows (pack_geom_np)
    # --- static (aux) ---
    num_nodes: int = dataclasses.field(default=0)
    num_blocks: int = dataclasses.field(default=0)
    num_triangles: int = dataclasses.field(default=0)   # real (unpadded) count
    max_leaf: int = dataclasses.field(default=8)
    depth: int = dataclasses.field(default=0)
    block_size: int = dataclasses.field(default=32)

    _DYN = ("scene", "node_min", "node_max", "skip", "leaf_first",
            "leaf_count", "block_min", "block_max", "block_obj", "geom")
    _STATIC = ("num_nodes", "num_blocks", "num_triangles", "max_leaf",
               "depth", "block_size")

    def tree_flatten(self):
        return (tuple(getattr(self, n) for n in self._DYN),
                tuple(getattr(self, n) for n in self._STATIC))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def pack_geom_np(verts_cart, tri_obj) -> np.ndarray:
    """HOST packer for the walk kernels' triangle operand (kernels/walk.py):
    [T,3,3] + object ids [T] -> [GEOM_ROWS, T] f32 with rows p1 xyz,
    e1 = p2 - p1, e2 = p3 - p1, object id.  Row-major per quantity, so a
    window of consecutive triangles is one contiguous load per row; the
    edges are the f32 differences the oracle forms (ops/intersect.py)."""
    v = np.asarray(verts_cart, np.float32)
    p1 = v[:, 0]
    rows = np.concatenate([p1, v[:, 1] - p1, v[:, 2] - p1,
                           np.asarray(tri_obj, np.float32)[:, None]], axis=1)
    return np.ascontiguousarray(rows.T, dtype=np.float32)


def prepare(scene: Scene, cfg: RenderConfig) -> PreparedScene:
    """Build per-object BVHs (reference topology), chain them into one global
    stackless array, reorder+pad the scene, and compute triangle blocks."""
    verts_cart = np.asarray(scene.verts[..., :3] / scene.verts[..., 3:4])
    tri_obj = np.asarray(scene.tri_obj)
    T = verts_cart.shape[0]

    # object boundaries (SceneManager emits objects contiguously)
    if T and np.any(np.diff(tri_obj) < 0):
        order = np.argsort(tri_obj, kind="stable").astype(np.int32)
        scene = scene.reorder(order)
        verts_cart = verts_cart[order]
        tri_obj = tri_obj[order]

    bvhs, offsets = [], []
    start = 0
    while start < T:
        end = start
        while end < T and tri_obj[end] == tri_obj[start]:
            end += 1
        bvhs.append(build_bvh(verts_cart[start:end], cfg.bvh.leaf_size,
                              split=cfg.bvh.split))
        offsets.append(start)
        start = end
    if not bvhs:
        bvhs = [build_bvh(np.zeros((0, 3, 3), np.float32), cfg.bvh.leaf_size)]
        offsets = [0]

    # Pad each OBJECT's triangle range to a BLOCK multiple so every cull
    # block is single-object ("pure"): shadow-time self-object exclusion is
    # then exact at block level (kernels/tiled.py:_visibility).  Pad rows
    # are degenerate copies of a real vertex of the same object: zero area
    # (MT det = 0, never hits) and inside the object's last block AABB.
    # Cost: <= block_size-1 extra triangles per object.
    bs = cfg.bvh.block_size
    counts = [len(b.perm) for b in bvhs]
    pcounts = [-(-c // bs) * bs for c in counts]
    poffsets = [0]
    for pc in pcounts[:-1]:
        poffsets.append(poffsets[-1] + pc)
    flat = concat_bvhs(bvhs, poffsets)
    Tp = poffsets[-1] + pcounts[-1]

    # gather map new padded position -> original triangle row (pads repeat
    # the object's last real triangle; their rows are degenerated below)
    src = np.zeros(Tp, np.int32)
    pad_mask = np.ones(Tp, bool)
    for b, c, pc, po, ro in zip(bvhs, counts, pcounts, poffsets, offsets):
        if c:
            src[po:po + c] = b.perm + ro
            src[po + c:po + pc] = int(b.perm[-1]) + ro
            pad_mask[po:po + c] = False
    scene = scene.reorder(src)

    # tail slack: BVH leaf windows may read up to max_leaf rows past their
    # first triangle; keep the global array long enough (tri_obj = -1), and
    # a whole number of walk windows long (kernels/walk.py).
    win = bs * cfg.kernel.window_blocks
    pad_to = -(-max(Tp + flat.max_leaf, 1) // win) * win
    pad = pad_to - Tp
    scene_np = {name: np.asarray(getattr(scene, name))
                for name in Scene._ARRAY_FIELDS}
    if Tp and pad_mask.any():
        v0 = scene_np["verts"][pad_mask][:, 0:1, :]
        scene_np["verts"] = scene_np["verts"].copy()
        scene_np["verts"][pad_mask] = np.broadcast_to(
            v0, (int(pad_mask.sum()), 3, 4))
        for name, fill in (("vnormals", 0.0), ("tri_normal", 0.0),
                           ("uvs", 0.0), ("tri_color", 1.0)):
            scene_np[name] = scene_np[name].copy()
            scene_np[name][pad_mask] = fill
        scene_np["tri_tex"] = scene_np["tri_tex"].copy()
        scene_np["tri_tex"][pad_mask] = -1
        # tri_obj keeps the object id: block purity by construction
    if pad:
        last_v = (scene_np["verts"][-1, 0:1, :] if Tp
                  else np.array([[0, 0, 0, 1]], np.float32))
        scene_np["verts"] = np.concatenate(
            [scene_np["verts"],
             np.broadcast_to(last_v, (pad, 3, 4)).copy()], axis=0)
        for name, fill in (("vnormals", 0.0), ("tri_normal", 0.0),
                           ("uvs", 0.0), ("tri_color", 1.0)):
            a = scene_np[name]
            scene_np[name] = np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)
        for name in ("tri_tex", "tri_obj"):
            a = scene_np[name]
            scene_np[name] = np.concatenate(
                [a, np.full((pad,), -1, a.dtype)], axis=0)
    # All host math stays numpy; one device_put of the finished pytree at
    # the end.
    padded = Scene(**scene_np, has_textures=scene.has_textures)

    vc = padded.verts[..., :3] / padded.verts[..., 3:4]
    bmin, bmax, nb = triangle_blocks(vc, bs)

    # per-block object id (see PreparedScene.block_obj): max over the
    # block; padding (-1) never disqualifies purity.
    to = np.asarray(padded.tri_obj).reshape(nb, bs)
    mx = to.max(axis=1) if nb else np.zeros((0,), np.int32)
    pure = np.all((to == mx[:, None]) | (to == -1), axis=1)
    assert pure.all(), "impure cull block despite object padding"
    block_obj = mx.astype(np.int32)

    ps = PreparedScene(
        scene=padded,
        node_min=flat.node_min,
        node_max=flat.node_max,
        skip=flat.skip,
        leaf_first=flat.leaf_first,
        leaf_count=flat.leaf_count,
        block_min=bmin,
        block_max=bmax,
        block_obj=block_obj,
        geom=pack_geom_np(vc, np.asarray(padded.tri_obj)),
        num_nodes=int(len(flat.skip)),
        num_blocks=int(nb),
        num_triangles=int(T),
        max_leaf=int(flat.max_leaf),
        depth=int(flat.depth),
        block_size=int(bs),
    )
    return jax.device_put(ps)
