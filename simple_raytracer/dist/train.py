"""Distributed differentiable rendering: scene-parameter optimization.

The reference is forward-only (SURVEY.md §2, gradients row).  Here the whole
pipeline is differentiable, so scene parameters (vertex positions, materials,
light, textures) can be fit to target images by gradient descent:

    loss(params) = mean( (render(params) - target)^2 )

Compute is data-parallel: rays are sharded over the mesh with shard_map inside
the loss; scene parameters are replicated, so XLA's AD inserts the gradient
`psum` over the mesh axis automatically — the equivalent of the
NCCL all-reduce a torch trainer would hand-write.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..ops.camera import primary_rays
from ..render.renderer import render_flat


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DiffParams:
    """The differentiable subset of the scene (SURVEY.md §2 gradients row:
    vertices, materials, lights, textures)."""

    verts: jnp.ndarray        # [T, 3, 4]
    obj_color: jnp.ndarray    # [O, 3]
    obj_ambient: jnp.ndarray  # [O]
    obj_specular: jnp.ndarray # [O]
    obj_shininess: jnp.ndarray# [O]
    tex_data: jnp.ndarray     # [P, 3]
    light_pos: jnp.ndarray    # [3]

    def tree_flatten(self):
        return (tuple(getattr(self, f.name)
                      for f in dataclasses.fields(self)), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def extract_params(scene, light_pos) -> DiffParams:
    return DiffParams(
        verts=jnp.asarray(scene.verts), obj_color=jnp.asarray(scene.obj_color),
        obj_ambient=jnp.asarray(scene.obj_ambient),
        obj_specular=jnp.asarray(scene.obj_specular),
        obj_shininess=jnp.asarray(scene.obj_shininess),
        tex_data=jnp.asarray(scene.tex_data),
        light_pos=jnp.asarray(light_pos, jnp.float32))


def apply_params(scene, p: DiffParams):
    """Rebind differentiable params into the scene; returns (scene, light)."""
    return scene.replace(
        verts=p.verts, obj_color=p.obj_color, obj_ambient=p.obj_ambient,
        obj_specular=p.obj_specular, obj_shininess=p.obj_shininess,
        tex_data=p.tex_data), p.light_pos


def make_train_step(scene, cfg: RenderConfig, mesh: Optional[Mesh] = None,
                    axis: str = "dp", lr: float = 1e-3,
                    remat: bool = False, optimizer=None):
    """Build a jitted SGD step fitting DiffParams to a target radiance image.

    Returns step(params, target [H,W,3]) -> (params, loss).  With a mesh, the
    flat ray axis is sharded via shard_map (scene replicated per device); the
    gradient all-reduce over the mesh axis is inserted by AD.  ``remat``
    rematerializes the forward render in the backward pass (jax.checkpoint),
    trading FLOPs for the O(rays x triangles) intersection activations —
    needed when ray batches outgrow device memory.

    ``scene`` may be a plain Scene (bruteforce dense forward) or a
    PreparedScene — then the configured FAST intersector (cfg.mode bvh /
    tiled) runs inside the loss via the fixed-topology recompute
    (diff/render.py), which is what makes flagship-scale (bunny geometry,
    1080p-class ray counts) training steps feasible: the dense forward is
    O(rays x triangles).  The prepared operand's packed BVH/Gram arrays
    are frozen (stop_gradient) and thus STALE w.r.t. in-flight vertex
    updates — the usual fixed-topology approximation; re-prepare between
    epochs if vertices move materially.
    """
    from ..accel.prepared import PreparedScene
    prep = scene if isinstance(scene, PreparedScene) else None
    scene = jax.device_put(scene.scene if prep is not None else scene)
    cam = cfg.camera
    tile_layout = None
    if prep is not None and cfg.mode == "tiled":
        # Rays in 2D-TILE-MAJOR order, exactly like the forward renderer
        # (render/renderer.py): row-major rays give the tiled cull 256-ray
        # ROW SLIVERS with hopeless direction bounds.  The loss is a
        # permutation-invariant sum, so only the target must be reordered
        # to match (_tile_major_flat below; padded out-of-frame rays miss
        # -> pred 0 and pair with zero-padded target rows -> contribute 0).
        from ..kernels.tiled import effective_tile_px
        from ..ops.camera import primary_rays_tiled
        tpx = effective_tile_px(cfg, scene.verts.shape[0])
        o, d, tx, ty = primary_rays_tiled(cam.width, cam.height, tpx,
                                          cam.focal, cam.normalize_dirs)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        tile_layout = (tpx, tx, ty)
    else:
        o, d = primary_rays(cam.width, cam.height, cam.focal,
                            cam.normalize_dirs)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    R = o.shape[0]
    Rimg = cam.width * cam.height       # loss normalizer: real pixels
    if mesh is not None:
        n = mesh.shape[axis]
        assert R % n == 0, f"rays {R} not divisible by mesh axis {n}"

    def _flat_target(target):
        if tile_layout is None:
            return target.reshape(-1, 3)
        tpx, tx, ty = tile_layout
        pad_y = ty * tpx - cam.height
        pad_x = tx * tpx - cam.width
        tt = jnp.pad(target, ((0, pad_y), (0, pad_x), (0, 0)))
        return tt.reshape(ty, tpx, tx, tpx, 3).transpose(
            0, 2, 1, 3, 4).reshape(-1, 3)

    # Tile-major IN-FRAME mask: primary_rays_tiled pads ragged frames with
    # REAL rays past the frame edge (pixel coords beyond W/H) that can hit
    # geometry (ground planes, border-crossing meshes), while _flat_target
    # zero-pads — an unmasked pred there shifts the loss optimum and
    # contaminates every gradient whenever W/H are not tile multiples
    # (measured: loss 0.0061 at ground-truth params on a 32x20 frame).
    # A ones-image pushed through the same padding is exactly the mask.
    if tile_layout is None:
        mask = jnp.ones((R, 1), jnp.float32)
    else:
        mask = _flat_target(
            jnp.ones((cam.height, cam.width, 3), jnp.float32))[:, :1]

    def local_loss(params: DiffParams, oo, dd, tt, mm):
        s, light = apply_params(scene, params)
        if prep is not None and cfg.mode in ("bvh", "tiled"):
            from ..diff.render import render_radiance_diff
            operand = dataclasses.replace(prep, scene=s)
            fwd = lambda op, oo, dd, light: render_radiance_diff(
                op, cfg, light, origin=oo, direction=dd,
                apex=tile_layout is not None)   # primaries by construction
            if remat:
                fwd = jax.checkpoint(fwd, static_argnums=())
            radiance, hit = fwd(operand, oo, dd, light)
        else:
            fwd = lambda s, oo, dd, light: render_flat(s, cfg, oo, dd, light)
            if remat:
                fwd = jax.checkpoint(fwd, static_argnums=())
            radiance, hit = fwd(s, oo, dd, light)
        pred = jnp.where(hit[:, None], radiance, 0.0) * mm
        return jnp.sum((pred - tt) ** 2)

    if mesh is None:
        def loss_fn(params, target):
            return local_loss(params, o, d, _flat_target(target),
                              mask) / Rimg
    else:
        def loss_fn(params, target):
            def shard_body(params, oo, dd, tt, mm):
                # psum here so the scalar loss is replicated; param grads get
                # the matching psum from AD's transpose rule.
                return jax.lax.psum(local_loss(params, oo, dd, tt, mm), axis)
            # check_vma=False: the Pallas interpreter (CPU tests) mixes
            # varying and unvarying operands in its internal dynamic_slices
            # (same workaround as dist/sharding.py render_sharded)
            f = jax.shard_map(
                shard_body, mesh=mesh,
                in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
                out_specs=P(), check_vma=False)
            return f(params, o, d, _flat_target(target), mask) / Rimg

    if optimizer is not None:
        # optax path: step(params, opt_state, target) -> (params, opt_state,
        # loss); build opt_state with optimizer.init(params)
        @jax.jit
        def opt_step(params: DiffParams, opt_state, target):
            loss, grads = jax.value_and_grad(loss_fn)(params, target)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            import optax
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss
        return opt_step

    @jax.jit
    def step(params: DiffParams, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, target)
        params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return params, loss

    return step


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ReplicatedParams:
    """Differentiable params that stay replicated under geometry sharding
    (per-triangle params like verts are sharded over 'gp' instead and ride in
    the geometry shard)."""

    obj_color: jnp.ndarray
    obj_ambient: jnp.ndarray
    obj_specular: jnp.ndarray
    obj_shininess: jnp.ndarray
    tex_data: jnp.ndarray
    light_pos: jnp.ndarray

    def tree_flatten(self):
        return (tuple(getattr(self, f.name)
                      for f in dataclasses.fields(self)), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def make_train_step_composed(scene, cfg: RenderConfig, mesh: Mesh,
                             dp_axis: str = "dp", gp_axis: str = "gp",
                             lr: float = 1e-3):
    """Composed DP x geometry-parallel training step over a 2D mesh.

    Rays are sharded over BOTH axes (every device owns a home ray block);
    geometry is sharded over ``gp_axis`` (replicated over ``dp_axis``) and
    ring-rotates ray blocks per gp ring (dist/ring.py).  Materials/light/
    textures are replicated and their gradient all-reduce over both axes is
    inserted by AD; per-triangle data is non-differentiable here (vertex
    gradients are covered by the DP-only step, which keeps geometry
    replicated).

    Returns (step, params0, shard) with step(params, target [H,W,3]) ->
    (params, loss).
    """
    from . import ring as ring_mod

    scene = jax.device_put(scene)
    cam = cfg.camera
    o, d = primary_rays(cam.width, cam.height, cam.focal, cam.normalize_dirs)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    R = o.shape[0]
    n_total = mesh.shape[dp_axis] * mesh.shape[gp_axis]
    assert R % n_total == 0, f"rays {R} not divisible by {n_total} devices"
    shard = ring_mod.shard_geometry(scene, mesh.shape[gp_axis],
                                    block_size=cfg.bvh.block_size,
                                    window_blocks=cfg.kernel.window_blocks)

    def local_loss(params: ReplicatedParams, shard_local, oo, dd, tt):
        s = scene.replace(
            obj_color=params.obj_color, obj_ambient=params.obj_ambient,
            obj_specular=params.obj_specular,
            obj_shininess=params.obj_shininess, tex_data=params.tex_data)
        radiance, hit = ring_mod.render_flat_ring(
            s, shard_local, cfg, oo, dd, params.light_pos, axis=gp_axis)
        pred = jnp.where(hit[:, None], radiance, 0.0)
        return jnp.sum((pred - tt) ** 2)

    def shard_body(params, shard_arr, oo, dd, tt):
        shard_local = jax.tree.map(lambda a: a[0], shard_arr)
        return jax.lax.psum(local_loss(params, shard_local, oo, dd, tt),
                            (dp_axis, gp_axis))

    f = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(), P(gp_axis), P((dp_axis, gp_axis)),
                  P((dp_axis, gp_axis)), P((dp_axis, gp_axis))),
        out_specs=P(),
        check_vma=False)   # culled ring runs pallas: see dist/sharding.py

    def loss_fn(params, target):
        return f(params, shard, o, d, target.reshape(-1, 3)) / R

    @jax.jit
    def step(params: ReplicatedParams, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, target)
        params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return params, loss

    params0 = ReplicatedParams(
        obj_color=jnp.asarray(scene.obj_color),
        obj_ambient=jnp.asarray(scene.obj_ambient),
        obj_specular=jnp.asarray(scene.obj_specular),
        obj_shininess=jnp.asarray(scene.obj_shininess),
        tex_data=jnp.asarray(scene.tex_data),
        light_pos=jnp.zeros(3, jnp.float32))
    return step, params0, shard
