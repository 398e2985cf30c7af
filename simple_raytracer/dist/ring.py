"""Ring geometry-sharded intersection — the sequence-parallel analog.

For scenes too large to replicate per chip, the triangle axis is sharded over
a mesh axis ("gp").  Ray blocks then ring-rotate around the devices with
`lax.ppermute` (the same schedule as ring attention's KV rotation), each step
intersecting the resident geometry shard and folding the result into a running
min-t hit record carried WITH the ray block.  After `n` rotations every block
is home with the global nearest hit — no gather of remote triangle data ever
happens; the winning triangle's attributes ride along in the record.

Reference contrast: the reference loops objects per ray on one thread
(simple_raytracer.cpp:405-457); here the "loop over geometry" is a pipelined
collective between the devices.

All functions here run INSIDE shard_map (they use axis names).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..config import RenderConfig
from ..ops import intersect as isect
from ..render import integrator
from ..utils import match_vma, pad_rays


def _local_nearest(verts_local, o, d, eps, G_local=None):
    """Nearest hit of rays [R,3] against the LOCAL triangle shard.

    With ``G_local`` (precomputed Gram factors, [Tl,10,4]) the whole
    R x Tl Möller–Trumbore runs as ONE contraction at HIGHEST precision
    (ops/intersect.py:moller_trumbore_gram).  Returns (t [R], local_idx
    [R]).
    """
    if G_local is not None:
        F = isect.ray_features(o, d)                              # [R, 10]
        ts = isect.moller_trumbore_gram(F, G_local, eps)          # [R, Tl]
    else:
        ts = isect.moller_trumbore(o[:, None, :], d[:, None, :],
                                   verts_local[None, :, :, :], eps)
    idx = jnp.argmin(ts, axis=-1).astype(jnp.int32)
    t = jnp.take_along_axis(ts, idx[:, None], axis=-1)[:, 0]
    return t, idx


def _empty_record(R, dtype=jnp.float32):
    return {
        "tri_v": jnp.zeros((R, 3, 3), dtype),
        "vnormals": jnp.zeros((R, 3, 3), dtype),
        "uvs": jnp.zeros((R, 3, 2), dtype),
        "obj": jnp.full((R,), -1, jnp.int32),
        "tex_id": jnp.full((R,), -1, jnp.int32),
    }


def _shard_blocks(shard):
    """The culling view of a shard (kernels/tiled.py:cull reads these
    attributes); shards are not object-pure, so no self-object cull."""
    import types
    Tl = shard["verts_cart"].shape[0]
    nb = shard["block_min"].shape[0]
    return types.SimpleNamespace(
        block_min=shard["block_min"], block_max=shard["block_max"],
        block_size=Tl // nb, geom=shard["geom"], block_obj=None)


def _local_hit_fn(shard, eps: float, tile: int, maxv: int,
                  apex: bool = True, kernel=None):
    """Pick the per-rotation local intersector.

    With ``kernel`` (the tiled mode's KernelConfig), shards produced by
    :func:`shard_geometry` with ``culled=True`` run the SAME window-culled
    walk that powers single-device rendering, so per-step cost scales with
    the rays' visible blocks, not with shard size.  Otherwise the dense
    Gram contraction runs (O(R x Tl) per rotation).
    """
    if kernel is not None and "geom" in shard:
        from ..kernels import tiled
        blocks = _shard_blocks(shard)

        def local_hit(o, d):
            # the kernel has no VJP: freeze it; ring_nearest_hit restores
            # differentiability by the fixed-topology recompute afterwards.
            t, li = tiled.hits(blocks, lax.stop_gradient(o),
                               lax.stop_gradient(d), tile, eps, maxv,
                               apex=apex, kernel=kernel)
            return lax.stop_gradient(t), li
        return local_hit, True

    G_local = isect.pack_mt_gram(shard["verts_cart"])
    return (lambda o, d: _local_nearest(shard["verts_cart"], o, d, eps,
                                        G_local)), False


def _decode_pack(pk, lean: bool):
    """Packed per-ray record [R, 26|8] -> the shading-record dict
    (see shard_geometry's rec_pack/rec_flat layout)."""
    obj_col, tex_col = (3, 4) if lean else (24, 25)
    rec = {
        "obj": jnp.round(pk[:, obj_col]).astype(jnp.int32),
        "tex_id": jnp.round(pk[:, tex_col]).astype(jnp.int32),
    }
    if lean:
        rec["normal"] = pk[:, :3]
    else:
        rec["tri_v"] = pk[:, 0:9].reshape(-1, 3, 3)
        rec["vnormals"] = pk[:, 9:18].reshape(-1, 3, 3)
        rec["uvs"] = pk[:, 18:24].reshape(-1, 3, 2)
    return rec


def ring_nearest_hit(shard, o, d, axis: str = "gp", eps: float = 1e-12,
                     tile: int = 128, maxv: int = 248, lean: bool = False,
                     apex: bool = True, overlap: bool = True, kernel=None):
    """Global nearest hit with triangle-sharded geometry.

    Args:
      shard: dict with the LOCAL triangle shard —
        verts_cart [Tl,3,3], vnormals [Tl,3,3], uvs [Tl,3,2],
        tri_obj [Tl], tri_tex [Tl] (equal Tl per device; pad with degenerate
        triangles); optionally block_min/block_max/geom for the culled-walk
        path (shard_geometry(culled=True)).
      o, d: [R, 3] this device's home ray block.
      axis: mesh axis name the geometry is sharded over.
      apex: CONTRACT — True (the default) asserts every ray of every home
        block shares ONE origin (primary rays from one camera), which
        enables the projective pixel-space cull in the shard-local walks
        (kernels/tiled._visibility_px).  That cull is UNSOUND for
        secondary / mixed-origin rays (it would silently drop reachable
        blocks — missed hits); such callers must pass apex=False to fall
        back to the interval cull.

    Returns (t [R], record dict) — the hit record carries the winning
    triangle's attributes, so shading needs no remote gathers.

    ``overlap`` (default): the home block is split into two half-blocks
    scheduled ring-attention style — half A's ppermute is issued BEFORE
    half B's local walk and consumed after it (and vice versa), so each
    rotation's transfer has a full half-block walk of independent
    compute to hide behind.  XLA cannot software-pipeline a collective
    ACROSS scan iterations, so the plain schedule (walk -> ppermute ->
    next iteration) serializes compute and communication; the in-body
    interleave restores the overlap at identical semantics (bit-equal on
    the CPU mesh, tests/test_dist.py).
    """
    n = lax.axis_size(axis)
    R = o.shape[0]
    perm = [(i, (i + 1) % n) for i in range(n)]
    local_hit, used_kernel = _local_hit_fn(shard, eps, tile, maxv, apex,
                                           kernel)
    # Packed-record fast path (shard_geometry rec_pack/rec_flat): the
    # winner-attribute carry is ONE [R, K] gather + one where per rotation
    # instead of five.  ``lean`` (flat-untextured scenes): K=8 (flat
    # normal + ids), 3.25x fewer ppermute bytes than the 26-wide pack.
    pack_key = None
    if lean and "rec_flat" in shard:
        pack_key = "rec_flat"
    elif "rec_pack" in shard:
        pack_key = "rec_pack"

    def fold(blk):
        o, d, best_t, rec = blk
        t, li = local_hit(o, d)
        better = t < best_t
        if pack_key is not None:
            rec = jnp.where(better[:, None], shard[pack_key][li], rec)
        else:
            bv = better[:, None, None]
            rec = {
                "tri_v": jnp.where(bv, shard["verts_cart"][li],
                                   rec["tri_v"]),
                "vnormals": jnp.where(bv, shard["vnormals"][li],
                                      rec["vnormals"]),
                "uvs": jnp.where(bv, shard["uvs"][li], rec["uvs"]),
                "obj": jnp.where(better, shard["tri_obj"][li], rec["obj"]),
                "tex_id": jnp.where(better, shard["tri_tex"][li],
                                    rec["tex_id"]),
            }
        return o, d, jnp.minimum(best_t, t), rec

    def rec_init(Rh):
        if pack_key is not None:
            rec0 = jnp.zeros((Rh, shard[pack_key].shape[-1]), o.dtype)
            rec0 = rec0.at[:, 3 if pack_key == "rec_flat" else 24].set(-1.0)
            rec0 = rec0.at[:, 4 if pack_key == "rec_flat" else 25].set(-1.0)
            return rec0
        return _empty_record(Rh, o.dtype)

    def blk_init(o, d):
        Rh = o.shape[0]
        return jax.tree.map(
            lambda x: match_vma(x, o),
            (o, d, jnp.full((Rh,), jnp.inf, o.dtype), rec_init(Rh)))

    if overlap and n > 1:
        # half-block double buffer.  Invariant at body start: A is FOLDED
        # on this device and ready to send; B has ARRIVED but not folded.
        Rh = R // 2

        def step2(carry, _):
            A, B = carry
            A2 = lax.ppermute(A, axis, perm)   # A flies to the next ...
            Bf = fold(B)                       # ... while B walks locally
            B2 = lax.ppermute(Bf, axis, perm)  # B flies ...
            Af = fold(A2)                      # ... while arrived-A walks
            return (Af, B2), None

        A0 = fold(blk_init(o[:Rh], d[:Rh]))
        B0 = blk_init(o[Rh:], d[Rh:])
        (Af, B2), _ = lax.scan(step2, (A0, B0), None, length=n - 1)
        A_home = lax.ppermute(Af, axis, perm)
        B_home = lax.ppermute(fold(B2), axis, perm)
        o2, d2, t, rec = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), A_home, B_home)
    else:
        def step(carry, _):
            carry = fold(carry)
            # rotate the ray block + its running record to the next device
            return lax.ppermute(carry, axis, perm), None

        (o2, d2, t, rec), _ = lax.scan(step, blk_init(o, d), None, length=n)
    # n rotations of +1 bring every block back to its home device
    if pack_key is not None:
        rec = _decode_pack(rec, pack_key == "rec_flat")
    if used_kernel and "tri_v" in rec:
        # fixed-topology differentiable recompute (diff/render.py pattern):
        # the kernel's t was gradient-stopped, but the winning triangle's
        # vertices rode home in the record through differentiable gathers and
        # ppermutes — recomputing MT at the frozen winner restores d(t)/d(verts)
        # (the lean record has no vertices: render-only fast path)
        t_rec = isect.moller_trumbore(o, d, rec["tri_v"], eps)
        t = jnp.where(jnp.isfinite(t) & jnp.isfinite(t_rec), t_rec, t)
    return t, rec


def ring_any_hit_other(shard, o, d, self_obj, axis: str = "gp",
                       eps: float = 1e-12, no_max_t: bool = True,
                       hit=None, tile: int = 128, maxv: int = 248,
                       overlap: bool = True, kernel=None,
                       shared_light: bool = True):
    """Shadow predicate under geometry sharding: ANY hit (t >= 0, no max-t —
    the reference quirk, simple_raytracer.cpp:321-342) on a triangle of a
    DIFFERENT object, across all shards.  With ``kernel``, culled shards
    route through the any-hit walk (``shared_light``: every ray ends at
    one light, which enables the light-apex cull).
    ``overlap``: half-block double-buffered schedule (see
    ring_nearest_hit) hiding each rotation behind a half-block walk."""
    n = lax.axis_size(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]

    if kernel is not None and "geom" in shard:
        from ..kernels import tiled
        sh_fn = tiled.tiled_shadow_fn(_shard_blocks(shard), tile, eps, maxv,
                                      no_max_t, kernel=kernel,
                                      shared_light=shared_light)

        def local_occ(o, d, self_obj, hitm):
            return sh_fn(o, o + d, self_obj, hit=hitm)
    else:
        def local_occ(o, d, self_obj, hitm):
            ts = isect.moller_trumbore(o[:, None, :], d[:, None, :],
                                       shard["verts_cart"][None], eps)
            occ = jnp.isfinite(ts) & \
                (shard["tri_obj"][None, :] != self_obj[:, None])
            if not no_max_t:
                occ = occ & (ts <= 1.0)
            return jnp.any(occ, axis=-1)

    if hit is None:
        hit = jnp.ones(o.shape[:1], jnp.bool_)

    def fold(blk):
        o, d, self_obj, hitm, found = blk
        return (o, d, self_obj, hitm,
                found | local_occ(o, d, self_obj, hitm))

    def blk_init(o, d, self_obj, hitm):
        return (o, d, self_obj, match_vma(hitm, o),
                match_vma(jnp.zeros(o.shape[:1], jnp.bool_), o))

    if overlap and n > 1:
        Rh = o.shape[0] // 2

        def step2(carry, _):
            A, B = carry
            A2 = lax.ppermute(A, axis, perm)
            Bf = fold(B)
            B2 = lax.ppermute(Bf, axis, perm)
            Af = fold(A2)
            return (Af, B2), None

        A0 = fold(blk_init(o[:Rh], d[:Rh], self_obj[:Rh], hit[:Rh]))
        B0 = blk_init(o[Rh:], d[Rh:], self_obj[Rh:], hit[Rh:])
        (Af, B2), _ = lax.scan(step2, (A0, B0), None, length=n - 1)
        fA = lax.ppermute(Af, axis, perm)[4]
        fB = lax.ppermute(fold(B2), axis, perm)[4]
        return jnp.concatenate([fA, fB], axis=0)

    def step(carry, _):
        return lax.ppermute(fold(carry), axis, perm), None

    (_, _, _, _, found), _ = lax.scan(
        step, blk_init(o, d, self_obj, hit), None, length=n)
    return found


def render_flat_ring(scene, shard, cfg: RenderConfig, o, d, light_pos,
                     axis: str = "gp"):
    """Geometry-sharded renderer body (call inside shard_map).

    ``scene`` supplies only the small replicated tables (object materials,
    texture atlas); all triangle data lives in ``shard``.  Returns
    (radiance [R,3], hit [R]) for this device's home ray block.
    """
    lean = (not bool(scene.has_textures)
            and not cfg.shading.smooth_normals)
    kernel = cfg.kernel if cfg.mode == "tiled" else None
    t, rec = ring_nearest_hit(shard, o, d, axis, cfg.mt_eps,
                              tile=cfg.kernel.ray_tile, maxv=cfg.cull_maxv,
                              lean=lean, kernel=kernel)
    shadow_fn = None
    if cfg.light.enable_shadows:
        shadow_fn = lambda p, l, s, hit=None: ring_any_hit_other(
            shard, p, l - p, s, axis, cfg.mt_eps,
            cfg.light.shadow_no_max_t, hit=hit, tile=cfg.kernel.ray_tile,
            maxv=cfg.cull_maxv, kernel=kernel,
            shared_light=cfg.light.num_samples == 1)
    radiance = integrator.shade_records(scene, cfg, rec, o, d, t, light_pos,
                                        shadow_fn)
    return radiance, jnp.isfinite(t)


def strip_scene_tables(scene):
    """Scene with only the small replicated tables (materials + texture
    atlas); triangle arrays emptied so geometry-sharded renders don't
    replicate the big arrays."""
    import numpy as np
    return scene.replace(
        verts=np.zeros((0, 3, 4), np.float32),
        vnormals=np.zeros((0, 3, 3), np.float32),
        tri_normal=np.zeros((0, 3), np.float32),
        uvs=np.zeros((0, 3, 2), np.float32),
        tri_color=np.zeros((0, 3), np.float32),
        tri_tex=np.zeros((0,), np.int32),
        tri_obj=np.zeros((0,), np.int32))


def render_geometry_sharded(scene, cfg: RenderConfig, light_pos, mesh,
                            axis: str = "gp"):
    """Full-frame render with the TRIANGLE axis sharded over ``mesh[axis]``
    and ray blocks ring-rotating (the scene-too-big-to-replicate mode).

    Returns [H, W, 3] uint8.  Each device holds 1/n of the triangles; the
    small material/texture tables are replicated.
    """
    import jax
    from jax.sharding import PartitionSpec as P
    from ..ops.camera import primary_rays
    from ..render import integrator

    n = mesh.shape[axis]
    cam = cfg.camera
    o, d = primary_rays(cam.width, cam.height, cam.focal, cam.normalize_dirs)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    o, d, R = pad_rays(o, d, n)
    shard = shard_geometry(scene, n, block_size=cfg.bvh.block_size,
                           window_blocks=cfg.kernel.window_blocks)
    tables = strip_scene_tables(scene)

    def body(tables, shard, o, d, light):
        shard = jax.tree.map(lambda a: a[0], shard)   # drop device axis
        return render_flat_ring(tables, shard, cfg, o, d, light, axis=axis)

    f = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis)),
        check_vma=False))   # pallas in shard_map: see dist/sharding.py
    radiance, hit = f(tables, shard, o, d,
                      jnp.asarray(light_pos, jnp.float32))
    radiance, hit = radiance[:R], hit[:R]
    H, W = cam.height, cam.width
    img = integrator.finalize_image(radiance.reshape(H, W, 3),
                                    hit.reshape(H, W), cfg)
    return img


def render_composed(scene, cfg: RenderConfig, light_pos, mesh,
                    dp_axis: str = "dp", gp_axis: str = "gp"):
    """Full-frame render over a 2D mesh: rays sharded over BOTH axes, the
    triangle axis sharded over ``gp_axis`` (replicated over ``dp_axis``).
    Every device owns a home ray block and ring-rotates it around its gp
    ring; dp rows work on disjoint ray sets in parallel.  Returns
    [H, W, 3] uint8.
    """
    import jax
    from jax.sharding import PartitionSpec as P
    from ..ops.camera import primary_rays
    from ..render import integrator

    n_dp, n_gp = mesh.shape[dp_axis], mesh.shape[gp_axis]
    cam = cfg.camera
    o, d = primary_rays(cam.width, cam.height, cam.focal, cam.normalize_dirs)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    o, d, R = pad_rays(o, d, n_dp * n_gp)
    shard = shard_geometry(scene, n_gp, block_size=cfg.bvh.block_size,
                           window_blocks=cfg.kernel.window_blocks)
    tables = strip_scene_tables(scene)

    def body(tables, shard, o, d, light):
        shard = jax.tree.map(lambda a: a[0], shard)
        return render_flat_ring(tables, shard, cfg, o, d, light, axis=gp_axis)

    f = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(gp_axis), P((dp_axis, gp_axis)),
                  P((dp_axis, gp_axis)), P()),
        out_specs=(P((dp_axis, gp_axis)), P((dp_axis, gp_axis))),
        check_vma=False))   # pallas in shard_map: see dist/sharding.py
    radiance, hit = f(tables, shard, o, d,
                      jnp.asarray(light_pos, jnp.float32))
    radiance, hit = radiance[:R], hit[:R]
    H, W = cam.height, cam.width
    return integrator.finalize_image(radiance.reshape(H, W, 3),
                                     hit.reshape(H, W), cfg)


def shard_geometry(scene, n: int, culled: bool = True,
                   block_size: int = 32, window_blocks: int = None,
                   leaf_size: int = 8):
    """HOST helper: split the scene's triangle arrays into ``n`` equal shards
    (padded with degenerate triangles that never hit).  Returns arrays with a
    leading device axis [n, Tl, ...] suitable for shard_map in_specs P('gp').

    With ``culled=True`` (default) each shard is additionally BVH-preordered
    and equipped with triangle-block AABBs + the walk's geometry rows
    (block_min/block_max/geom keys), so the tiled mode's ring schedule runs
    the window-culled walk per rotation instead of a dense R x Tl
    contraction.
    """
    import numpy as np
    verts = np.asarray(scene.verts)
    T = verts.shape[0]
    Tl = -(-max(T, 1) // n)
    # pad each shard to a WINDOW multiple so windows never straddle shards
    if culled:
        from ..config import KernelConfig
        win = block_size * (window_blocks or KernelConfig().window_blocks)
        Tl = -(-Tl // win) * win
    pad = n * Tl - T

    def pad0(a, fill):
        if pad == 0 and T > 0:
            return np.asarray(a)
        out = np.full((n * Tl,) + a.shape[1:], fill, a.dtype)
        out[:T] = a
        return out

    vc = verts[..., :3] / verts[..., 3:4]
    if T:
        # degenerate pad: copies of the last vertex -> zero-area, never hits
        vpad = np.broadcast_to(vc[-1:, 0:1, :], (1, 3, 3))
    else:
        vpad = np.zeros((1, 3, 3), np.float32)
    vc_full = np.concatenate([vc, np.broadcast_to(vpad, (pad, 3, 3))], axis=0) \
        if pad else vc
    shard = {
        "verts_cart": vc_full.reshape(n, Tl, 3, 3).astype(np.float32),
        "vnormals": pad0(np.asarray(scene.vnormals), 0).reshape(n, Tl, 3, 3),
        "uvs": pad0(np.asarray(scene.uvs), 0).reshape(n, Tl, 3, 2),
        "tri_obj": pad0(np.asarray(scene.tri_obj), -1).reshape(n, Tl),
        "tri_tex": pad0(np.asarray(scene.tri_tex), -1).reshape(n, Tl),
    }
    if not culled:
        return shard

    # per-shard BVH preorder (spatial coherence -> tight blocks), block
    # AABBs and geometry rows — all host numpy, one device_put by the
    # caller's jit boundary
    from ..accel.bvh import build_bvh, triangle_blocks
    from ..accel.prepared import pack_geom_np
    from ..kernels.walk import GEOM_ROWS
    nb = Tl // block_size
    bmins = np.zeros((n, nb, 3), np.float32)
    bmaxs = np.zeros((n, nb, 3), np.float32)
    geom = np.zeros((n, GEOM_ROWS, Tl), np.float32)
    for s in range(n):
        vs = shard["verts_cart"][s]
        p = build_bvh(vs, leaf_size).perm
        for k in ("verts_cart", "vnormals", "uvs", "tri_obj", "tri_tex"):
            shard[k][s] = shard[k][s][p]
        vs = shard["verts_cart"][s]
        bmins[s], bmaxs[s], _ = triangle_blocks(vs, block_size)
        geom[s] = pack_geom_np(vs, shard["tri_obj"][s])
    shard["block_min"] = bmins
    shard["block_max"] = bmaxs
    shard["geom"] = geom
    # ONE-GATHER record table: the per-rotation winner-attribute fetch is
    # one ray-sized gather instead of five.  Layout [Tl, 26]: tri_v 9,
    # vnormals 9, uvs 6, obj 1, tex 1 (+2 pad); the flat-untextured fast
    # path slices a lean [Tl, 8] view: flat normal 3, obj 1, tex 1.
    tn = np.zeros((n, Tl, 3), np.float32)
    for s in range(n):
        vs = shard["verts_cart"][s]
        e1 = vs[:, 1] - vs[:, 0]
        e2 = vs[:, 2] - vs[:, 0]
        nrm = np.cross(e1, e2)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        tn[s] = (nrm / np.maximum(ln, 1e-30)).astype(np.float32)
    shard["rec_pack"] = np.concatenate([
        shard["verts_cart"].reshape(n, Tl, 9),
        shard["vnormals"].reshape(n, Tl, 9),
        shard["uvs"].reshape(n, Tl, 6),
        shard["tri_obj"][..., None].astype(np.float32),
        shard["tri_tex"][..., None].astype(np.float32),
    ], axis=-1).astype(np.float32)
    shard["rec_flat"] = np.concatenate([
        tn,
        shard["tri_obj"][..., None].astype(np.float32),
        shard["tri_tex"][..., None].astype(np.float32),
        np.zeros((n, Tl, 3), np.float32),
    ], axis=-1)
    return shard
