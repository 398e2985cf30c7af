"""Animation sweep driver — the reference's 36-frame turntable.

Reference behavior (simple_raytracer.cpp:530-796): for each angle in
0..350 step 10, rebuild the WHOLE scene from disk (OBJ parse included), bake
inverse(view) into geometry + light, rebuild every BVH, render, save
``output{angle}.bmp`` eagerly (crash keeps completed frames — the only
resume-like property, SURVEY.md §5).

This driver:
  * world mode (default): scene + BVH built ONCE; the camera ray transform
    is the only per-frame change, so every frame is pure device compute with
    one cached executable.
  * bake mode: reference-exact per-frame rebuild (for parity tests).
  * resume=True: frames whose output file exists are skipped (checkpoint /
    resume of a sweep).
  * frame-parallel: shard whole frames over a device mesh axis (the pipeline
    analog of SURVEY.md §2 — different frames on different devices).
  * per-frame metrics (ms, rays/s) to stdout + optional JSONL.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import AnimationConfig, RenderConfig
from ..io.image import save_image
from ..render import integrator
from ..render.renderer import ensure_prepared, render, render_radiance
from ..scene import catalog


def sweep_angles(anim: AnimationConfig) -> np.ndarray:
    return np.arange(anim.start_deg, anim.stop_deg, anim.step_deg,
                     dtype=np.float32)



def frame_filename(angle: float, fmt: str) -> str:
    """``output{angle}.{fmt}`` — integer angles match the reference's names
    (``output0.bmp`` ...); fractional angles (step_deg < 1) keep their
    fraction instead of colliding on int(angle)."""
    a = float(angle)
    label = str(int(a)) if a == int(a) else f"{a:g}"
    return f"output{label}.{fmt}"

def render_turntable(scene_name: str, cfg: RenderConfig,
                     anim: AnimationConfig = AnimationConfig(),
                     out_dir: str = "images/generation",
                     fmt: str = "bmp",
                     world_space: bool = True,
                     resume: bool = True,
                     metrics_path: Optional[str] = None,
                     mesh: Optional[Mesh] = None,
                     frame_axis: str = "pp") -> list:
    """Render the turntable sweep for a catalog scene.  Returns the list of
    written file paths."""
    from ..utils.metrics import Metrics
    builder = catalog.CATALOG[scene_name]
    angles = sweep_angles(anim)
    written = []
    metrics = Metrics(metrics_path)
    emit = lambda rec: metrics.emit(**rec)

    if world_space:
        sm, _, light = builder(0.0, bake_view=False)
        scene = sm.build()
        t0 = time.time()
        prep = ensure_prepared(scene, cfg)
        emit({"event": "prepare", "seconds": round(time.time() - t0, 3),
              "triangles": scene.num_triangles})
        views = np.stack([
            catalog.orbit_view(a, anim.orbit_radius, anim.camera_y,
                               anim.pitch_deg, anim.yaw_offset_deg)
            for a in angles])
        if mesh is not None:
            return _sweep_frame_parallel(
                prep, cfg, views, light, angles, out_dir, fmt, mesh,
                frame_axis, emit)
        todo = [(k, a) for k, a in enumerate(angles)
                if not (resume and os.path.exists(
                    os.path.join(out_dir, frame_filename(a, fmt))))]
        if todo:
            # one device program per chunk of pending frames: no
            # per-frame host round trip
            t0 = time.time()
            imgs = np.asarray(frames_batched(
                prep, cfg, views[[k for k, _ in todo]], light))
            dt = time.time() - t0
            rays = imgs.shape[1] * imgs.shape[2]
            emit({"event": "sweep", "frames": len(todo),
                  "ms_per_frame": round(dt * 1e3 / len(todo), 2),
                  "rays_per_s": round(rays * len(todo) / dt, 1)})
            for (k, a), img in zip(todo, imgs):
                save_image(os.path.join(out_dir, frame_filename(a, fmt)),
                           img)
        written = [os.path.join(out_dir, frame_filename(a, fmt))
                   for a in angles]
    else:
        # reference-parity mode: rebuild + rebake + re-BVH per frame
        for a in angles:
            path = os.path.join(out_dir, frame_filename(a, fmt))
            if resume and os.path.exists(path):
                written.append(path)
                continue
            sm, _, light = builder(float(a), bake_view=True)
            scene = sm.build()
            prep = ensure_prepared(scene, cfg)
            t0 = time.time()
            img = np.asarray(render(prep, cfg, light))
            dt = time.time() - t0
            save_image(path, img)
            written.append(path)
            emit({"event": "frame", "angle": float(a),
                  "ms": round(dt * 1e3, 2), "path": path})
    metrics.close()
    return written


FRAMES_PER_SWEEP = 24       # bounds the [F,H,W,3] device buffer (~100 MB
                            # at 1080p) while amortizing host round trips


def frames_batched(prep_or_scene, cfg: RenderConfig, views, light
                   ) -> "np.ndarray":
    """Render a BATCH of frames in few device programs (lax.map, chunked) —
    no per-frame host round trips.
    views [F,4,4]; returns [F, H, W, 3] uint8 (host array)."""
    operand = ensure_prepared(prep_or_scene, cfg)
    light = jnp.asarray(light, jnp.float32)

    @jax.jit
    def sweep(operand, Vs, light):
        def one(V):
            radiance, hit = render_radiance(operand, cfg, light,
                                            view_matrix=V)
            return integrator.finalize_image(radiance, hit, cfg)
        return jax.lax.map(one, Vs)

    views = np.asarray(views, np.float32)
    F = views.shape[0]
    C = FRAMES_PER_SWEEP
    if F <= C:
        return np.asarray(sweep(operand, jnp.asarray(views), light))
    # fixed chunk size => one compiled executable; pad the tail chunk
    pad = (-F) % C
    if pad:
        views = np.concatenate([views, np.repeat(views[-1:], pad, 0)], 0)
    out = [np.asarray(sweep(operand, jnp.asarray(views[i:i + C]), light))
           for i in range(0, views.shape[0], C)]
    return np.concatenate(out, axis=0)[:F]


def frames_parallel(prep_or_scene, cfg: RenderConfig, views: jnp.ndarray,
                    light, mesh: Mesh, axis: str = "pp") -> jnp.ndarray:
    """Render a BATCH of frames, whole frames sharded over ``mesh[axis]``
    (the pipeline-parallel analog: SURVEY.md §2).  views [F,4,4] with F a
    multiple of the axis size; returns [F, H, W, 3] uint8."""
    operand = ensure_prepared(prep_or_scene, cfg)
    light = jnp.asarray(light, jnp.float32)

    def one(operand, V, light):
        radiance, hit = render_radiance(operand, cfg, light, view_matrix=V)
        return integrator.finalize_image(radiance, hit, cfg)

    def local(operand, Vs, light):
        return jax.lax.map(lambda V: one(operand, V, light), Vs)

    f = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P(axis), P()), out_specs=P(axis),
        check_vma=cfg.mode != "tiled"))   # see dist/sharding.py note
    return f(operand, jnp.asarray(views, jnp.float32), light)


def _sweep_frame_parallel(prep, cfg, views, light, angles, out_dir, fmt,
                          mesh, axis, emit):
    n = mesh.shape[axis]
    F = len(angles)
    Fpad = -(-F // n) * n
    vpad = np.concatenate(
        [views, np.repeat(views[-1:], Fpad - F, axis=0)], axis=0)
    t0 = time.time()
    imgs = np.asarray(frames_parallel(prep, cfg, vpad, light, mesh, axis))
    dt = time.time() - t0
    emit({"event": "sweep", "frames": F, "devices": n,
          "ms_total": round(dt * 1e3, 2),
          "ms_per_frame": round(dt * 1e3 / F, 2)})
    written = []
    for k, a in enumerate(angles):
        path = os.path.join(out_dir, frame_filename(a, fmt))
        save_image(path, imgs[k])
        written.append(path)
    return written
