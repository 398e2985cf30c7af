"""Device-mesh setup + data-parallel (ray-sharded) rendering.

The reference is one thread on one CPU core (simple_raytracer.cpp:511-523).
The scaling story (SURVEY.md §2):

* **DP (primary)** — rays/pixels are embarrassingly parallel: shard the flat
  ray axis over the mesh with `shard_map`, scene replicated.  No collectives
  in the forward pass at all; gradients of replicated scene parameters are
  `psum`-reduced (dist/train.py).
* **GP (geometry-parallel, the TP/SP analog)** — for scenes too big to
  replicate, shard the triangle axis and ring-rotate ray blocks (dist/ring.py).

Multi-host: the same code runs under `jax.distributed.initialize()`; the mesh
spans all processes and XLA routes the collectives between devices and
hosts.  Tests exercise the identical code path on a virtual 8-device CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..ops.camera import primary_rays
from ..render import integrator


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("dp",),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """Build a device mesh over the first ``n_devices`` available devices.

    ``shape`` reshapes the device list for multi-axis meshes, e.g.
    ``make_mesh(8, ("dp", "gp"), (4, 2))``.
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(
            f"make_mesh: {n} devices requested but only {len(devs)} visible "
            "(for CPU tests set XLA_FLAGS=--xla_force_host_platform_device_"
            "count=N before importing jax)")
    devs = np.array(devs[:n])
    if shape is not None:
        devs = devs.reshape(shape)
    return Mesh(devs, axis_names)


from ..utils import pad_rays as _pad_rays


def render_radiance_sharded(prep_or_scene, cfg: RenderConfig, light_pos,
                            mesh: Mesh, axis: str = "dp"):
    """Full-frame float render, rays sharded over ``mesh[axis]``.

    Returns (radiance [H,W,3], hit [H,W]).  The scene/BVH is replicated; each
    device renders an equal contiguous slab of the flat ray array.  Must be
    called under jit for the shardings to stick (see ``render_sharded``).
    """
    from ..accel.prepared import PreparedScene
    from ..render.renderer import render_flat
    from ..accel import traverse

    cam = cfg.camera
    o, d = primary_rays(cam.width, cam.height, cam.focal, cam.normalize_dirs)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = mesh.shape[axis]
    o, d, R = _pad_rays(o, d, n)
    light_pos = jnp.asarray(light_pos, dtype=d.dtype)

    if cfg.mode == "bruteforce":
        scene = prep_or_scene.scene if isinstance(prep_or_scene, PreparedScene) \
            else prep_or_scene
        local = lambda s, oo, dd, lp: render_flat(s, cfg, oo, dd, lp)
        operand = scene
    elif cfg.mode in ("bvh", "tiled"):
        if not isinstance(prep_or_scene, PreparedScene):
            raise TypeError(f"mode '{cfg.mode}' needs a PreparedScene")
        if cfg.mode == "bvh":
            local = lambda p, oo, dd, lp: traverse.render_flat_bvh(
                p, cfg, oo, dd, lp)
        else:
            from ..kernels import tiled
            local = lambda p, oo, dd, lp: tiled.render_flat_tiled(
                p, cfg, oo, dd, lp)
        operand = prep_or_scene
    else:
        raise ValueError(f"unknown render mode: {cfg.mode}")

    # check_vma=False for the Pallas path: the kernels' outputs carry no
    # varying-manual-axes type (and the pallas interpreter used by the CPU
    # tests mixes varying and unvarying operands in its internal
    # dynamic_slices), which trips shard_map's vma checker.
    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis)),
        check_vma=cfg.mode != "tiled")
    radiance, hit = sharded(operand, o, d, light_pos)
    radiance, hit = radiance[:R], hit[:R]
    H, W = cam.height, cam.width
    return radiance.reshape(H, W, 3), hit.reshape(H, W)


@functools.lru_cache(maxsize=32)
def _render_sharded_jit(cfg: RenderConfig, mesh: Mesh, axis: str):
    def f(operand, light_pos):
        radiance, hit = render_radiance_sharded(operand, cfg, light_pos,
                                                mesh, axis)
        return integrator.finalize_image(radiance, hit, cfg)
    return jax.jit(f)


def render_sharded(prep_or_scene, cfg: RenderConfig, light_pos, mesh: Mesh,
                   axis: str = "dp") -> jnp.ndarray:
    """Jitted data-parallel full-frame render -> [H, W, 3] uint8."""
    from ..render.renderer import ensure_prepared
    operand = ensure_prepared(prep_or_scene, cfg)
    return _render_sharded_jit(cfg, mesh, axis)(
        operand, jnp.asarray(light_pos, dtype=jnp.float32))
