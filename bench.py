"""Benchmark: frame times of the raytracer's main paths on one GPU.

Prints ONE JSON line with the device it ran on and, per path, the steady
ms/frame (or ms/step) after warm-up:

  * flagship: the 81,920-triangle blob + ground (catalog "flagship"),
    1920x1080, hard shadows — the headline, reported as primary rays/s;
  * complex: the reference's active scene as a 36-frame turntable sweep at
    600x400 (simple_raytracer.cpp:530-796);
  * soft shadows: the flagship at 600x400 with S=16 light samples;
  * train: one fixed-topology train step (dist.make_train_step) at 960x540.

Every timed call ends in block_until_ready, and timed frames vary the view
by an epsilon so that no stage is loop-invariant.  A run that finds no GPU
exits non-zero and prints no result; a failing path fails the run.

vs_baseline: the speedup over the reference program's best published rate,
4.9k primary rays/s (complex scene, BVH, one CPU thread — BASELINE.md).

Usage: python bench.py [--mode tiled|bvh|bruteforce] [--width W]
                       [--height H] [--frames N] [--no-shadows]
"""

import argparse
import json
import sys
import time

REFERENCE_RAYS_PER_S = 4900.0   # BASELINE.md: complex scene + BVH


def _timed_frames(prep, cfg, light, view, frames):
    """(first call s, steady ms/frame) for `frames` view-varied frames run
    inside one device program."""
    import jax
    import jax.numpy as jnp
    from simple_raytracer.render import integrator
    from simple_raytracer.render.renderer import render_radiance

    @jax.jit
    def many(prep, light, V0):
        def one(i, acc):
            V = V0.at[0, 3].add(i.astype(jnp.float32) * 1e-5)
            rad, hit = render_radiance(prep, cfg, light, view_matrix=V)
            img = integrator.finalize_image(rad, hit, cfg)
            return acc + img.astype(jnp.int32).sum()
        return jax.lax.fori_loop(0, frames, one, jnp.int32(0))

    args = (prep, jnp.asarray(light, jnp.float32),
            jnp.asarray(view, jnp.float32))
    t0 = time.time()
    jax.block_until_ready(many(*args))
    first = time.time() - t0
    t0 = time.time()
    jax.block_until_ready(many(*args))
    return first, (time.time() - t0) * 1e3 / frames


def _cfg(mode, width, height, focal, **kw):
    from simple_raytracer.config import RenderConfig, CameraConfig
    cfg = RenderConfig(camera=CameraConfig(width=width, height=height,
                                           focal=focal), **kw)
    return cfg.replace(mode=mode) if mode else cfg


def run_flagship(mode, width, height, frames, shadows) -> dict:
    import numpy as np
    from simple_raytracer.accel.prepared import prepare
    from simple_raytracer.config import LightConfig
    from simple_raytracer.render.renderer import render
    from simple_raytracer.scene import catalog

    t0 = time.time()
    sm, view, light = catalog.flagship(0.0, bake_view=False)
    cfg = _cfg(mode, width, height, float(height),
               light=LightConfig(enable_shadows=shadows))
    prep = prepare(sm.build(), cfg)
    print(f"# scene+prepare {time.time() - t0:.2f} s, mode={cfg.mode}, "
          f"{width}x{height}, shadows={shadows}", file=sys.stderr)
    img = np.asarray(render(prep, cfg, light, view_matrix=view))
    frac = float((~np.all(img == np.array(cfg.background), -1)).mean())
    if not 0.05 < frac < 0.99:
        raise RuntimeError(f"implausible flagship coverage {frac}")
    first, ms = _timed_frames(prep, cfg, light, view, frames)
    print(f"# flagship: first call {first:.2f} s, {ms:.3f} ms/frame",
          file=sys.stderr)
    rays = width * height
    return {
        "metric": f"primary_rays_per_s_flagship_{width}x{height}_{cfg.mode}"
                  + ("" if shadows else "_noshadow"),
        "value": round(rays / (ms * 1e-3), 1),
        "unit": "rays/s",
        "flagship_ms_per_frame": round(ms, 3),
        "vs_baseline": round(rays / (ms * 1e-3) / REFERENCE_RAYS_PER_S, 2),
    }


def run_complex(mode, frames: int = 36) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from simple_raytracer.accel.prepared import prepare
    from simple_raytracer.config import AnimationConfig
    from simple_raytracer.driver.animation import sweep_angles
    from simple_raytracer.render.renderer import render_radiance
    from simple_raytracer.scene import catalog

    cfg = _cfg(mode, 600, 400, 400.0)
    anim = AnimationConfig(start_deg=0.0, stop_deg=frames * 10.0)
    sm, _, light = catalog.complex_scene(0.0, bake_view=False)
    prep = prepare(sm.build(), cfg)
    views = jnp.asarray(np.stack([
        catalog.orbit_view(a, anim.orbit_radius, anim.camera_y,
                           anim.pitch_deg, anim.yaw_offset_deg)
        for a in sweep_angles(anim)]), jnp.float32)

    @jax.jit
    def sweep(prep, Vs, light):
        def body(V):
            rad, hit = render_radiance(prep, cfg, light, view_matrix=V)
            return jnp.where(hit[..., None], rad, 0.0).sum()
        return jax.lax.map(body, Vs)

    light = jnp.asarray(light, jnp.float32)
    jax.block_until_ready(sweep(prep, views, light))
    t0 = time.time()
    jax.block_until_ready(sweep(prep, views, light))
    ms = (time.time() - t0) * 1e3 / views.shape[0]
    return {"complex_turntable_ms_per_frame": round(ms, 3),
            "complex_turntable_frames": int(views.shape[0])}


def run_soft_shadow(mode, frames: int = 16) -> dict:
    from simple_raytracer.accel.prepared import prepare
    from simple_raytracer.config import LightConfig
    from simple_raytracer.scene import catalog
    sm, view, light = catalog.flagship(0.0, bake_view=False)
    cfg = _cfg(mode, 600, 400, 400.0, light=LightConfig(num_samples=16))
    prep = prepare(sm.build(), cfg)
    _, ms = _timed_frames(prep, cfg, light, view, frames)
    return {"soft_shadow_s16_ms_per_frame": round(ms, 3)}


def run_train_step(mode, steps: int = 16) -> dict:
    import jax
    import jax.numpy as jnp
    from simple_raytracer.accel.prepared import prepare
    from simple_raytracer.dist import extract_params, make_train_step
    from simple_raytracer.render.renderer import render_radiance
    from simple_raytracer.scene import catalog
    sm, _, light = catalog.flagship(0.0, bake_view=True)
    cfg = _cfg(mode, 960, 540, 540.0)
    prep = prepare(sm.build(), cfg)
    light = jnp.asarray(light, jnp.float32)
    rad, hit = render_radiance(prep, cfg, light)
    target = jnp.where(hit[..., None], rad, 0.0)
    params = extract_params(prep.scene, light + 40.0)
    step = make_train_step(prep, cfg, lr=1e-3)

    @jax.jit
    def many(params, target):
        def one(i, st):
            pp, acc = st
            pp, loss = step(pp, target)
            return pp, acc + loss
        return jax.lax.fori_loop(0, steps, one,
                                 (params, jnp.float32(0)))[1]
    jax.block_until_ready(many(params, target))
    t0 = time.time()
    jax.block_until_ready(many(params, target))
    ms = (time.time() - t0) * 1e3 / steps
    return {"train_step_960x540_ms": round(ms, 3)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", default=None,
                   help="render mode (default: the platform's fast path)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--no-shadows", dest="shadows", action="store_false",
                   default=True)
    args = p.parse_args()

    import jax
    from simple_raytracer.utils.compile_cache import enable_compile_cache
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX found {dev.platform})", file=sys.stderr)
        return 2
    enable_compile_cache()
    print(f"# device_kind {dev.device_kind}, count {len(jax.devices())}",
          file=sys.stderr)
    result = run_flagship(args.mode, args.width, args.height, args.frames,
                          args.shadows)
    for fn in (run_complex, run_soft_shadow, run_train_step):
        result.update(fn(args.mode))
    result["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
