"""Chip check: drive the raytracer's main paths once on a CUDA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --cards 4  # the multi-card paths only, each
                                    # against the one-card result

One process does everything (a second JAX process could not get the card's
memory).  Phases, one card:

  1. flagship: the 81,920-triangle blob + ground (scene catalog "flagship"),
     1920x1080, hard shadows, through render() in the default mode, against
     the brute-force oracle; the bvh mode against the oracle; each walk
     kernel against its plain jnp twin on the frame's own plan;
  2. soft shadows (S=16) and the textured scene at 600x400 against the
     oracle;
  3. the `animate` command (4 frames at 600x400) in this process;
  4. five train steps (dist.make_train_step) at 960x540: loss finite and
     falling;
  5. timing after warm-up on view-varied frames: ms/frame of the default
     (Triton walk) path, of the same walk as plain jnp, and of bvh;
     compile time; peak device memory;
  6. the tests marked `gpu` (pytest, in this process).

Tolerances (oracle = mode "bruteforce", float32 at HIGHEST precision): hit
masks agree on >= 99.99 % of pixels, triangle ids on >= 99.9 % of hit
pixels, and the uint8 image within 1 level on >= 99.9 % of pixels.  The
walk runs Möller–Trumbore with the oracle's operations, but the two are
compiled differently (fused multiply-adds, division), so near-ties on
shared edges may pick the neighbouring triangle and a shading value may
round across a quantization step.

Exits non-zero, without the result line, when no GPU is found or any phase
fails.  The last line is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

BG = (173, 216, 230)
MASK_AGREE = 0.9999
ID_AGREE = 0.999
IMG_AGREE = 0.999
ORACLE_CHUNK = 4096        # [4096, 82k] f32 per oracle chunk


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _cfg(width, height, focal=None, **kw):
    from simple_raytracer.config import RenderConfig, CameraConfig
    cam = CameraConfig(width=width, height=height,
                       focal=float(height if focal is None else focal))
    return RenderConfig(camera=cam, **kw)


def _scene(name, bake_view=False):
    from simple_raytracer.scene import catalog
    sm, view, light = catalog.CATALOG[name](0.0, bake_view=bake_view)
    return sm.build(), view, light


def _render(scene, cfg, light, view=None):
    import numpy as np
    from simple_raytracer.render.renderer import render
    return np.asarray(render(scene, cfg, light, view_matrix=view))


def _image_agreement(img, ref, what):
    import numpy as np
    d = np.abs(img.astype(int) - ref.astype(int)).max(-1)
    close = float((d <= 1).mean())
    fg = ~np.all(ref == np.array(BG), -1)
    log(f"  {what}: within 1 level {close:.6f}, exact "
        f"{float((d == 0).mean()):.6f}, max diff {int(d.max())}, "
        f"foreground {float(fg.mean()):.4f}")
    assert close >= IMG_AGREE, f"{what}: {close} < {IMG_AGREE}"
    return close


def _oracle_cfg(cfg):
    return cfg.replace(mode="bruteforce", ray_chunk=ORACLE_CHUNK)


def _print_memory(fn, *args, what=""):
    import jax
    try:
        ma = jax.jit(fn).lower(*args).compile().memory_analysis()
        log(f"  memory_analysis({what}): temp "
            f"{getattr(ma, 'temp_size_in_bytes', '?')} B, args "
            f"{getattr(ma, 'argument_size_in_bytes', '?')} B, out "
            f"{getattr(ma, 'output_size_in_bytes', '?')} B")
    except Exception as e:                     # noqa: BLE001 - report only
        log(f"  memory_analysis({what}) unavailable: {e!r}")


@contextlib.contextmanager
def plain_walk():
    """Route the tiled path's walks to their plain jnp twins (the same walk
    over the same plan, compiled by XLA) — the baseline the kernels must
    beat."""
    import types
    from simple_raytracer.kernels import tiled, walk

    def nearest(plan, rays, geom, *, tile, window, eps, **_):
        return walk.nearest_reference(plan, rays, geom, tile=tile,
                                      window=window, eps=eps)

    def anyhit(plan, rays, geom, *, tile, window, eps, no_max_t=True, **_):
        return walk.anyhit_reference(plan, rays, geom, tile=tile,
                                     window=window, eps=eps,
                                     no_max_t=no_max_t)
    saved = tiled.walk
    tiled.walk = types.SimpleNamespace(pack_rays=walk.pack_rays,
                                       nearest=nearest, anyhit=anyhit)
    try:
        yield
    finally:
        tiled.walk = saved


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def phase_flagship(state):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from simple_raytracer.accel.prepared import prepare
    from simple_raytracer.kernels import tiled, walk
    from simple_raytracer.ops.camera import primary_rays_tiled
    from simple_raytracer.render.renderer import brute_force_hits

    scene, view, light = _scene("flagship")
    W, H = 1920, 1080
    cfg = _cfg(W, H)
    log(f"  default mode: {cfg.mode}; triangles {scene.num_triangles}")
    assert cfg.mode == "tiled", cfg.mode
    t0 = time.time()
    prep = prepare(scene, cfg)
    jax.block_until_ready(prep)
    log(f"  prepare (host BVH + blocks): {time.time() - t0:.2f} s, "
        f"native builder: {_native_used()}")
    state.update(flag_prep=prep, flag_cfg=cfg, flag_light=light,
                 flag_view=view)

    img = _render(prep, cfg, light, view)
    fg = float((~np.all(img == np.array(BG), -1)).mean())
    log(f"  foreground fraction {fg:.4f}")
    assert 0.05 < fg < 0.99, fg
    ocfg = _oracle_cfg(cfg)
    from simple_raytracer.render.renderer import render_radiance
    _print_memory(lambda s, l, v: render_radiance(s, ocfg, l, v),
                  scene, jnp.asarray(light), jnp.asarray(view, jnp.float32),
                  what="oracle frame")
    ref = _render(scene, ocfg, light, view)
    _image_agreement(img, ref, "tiled vs oracle image")
    img_bvh = _render(prep, cfg.replace(mode="bvh"), light, view)
    _image_agreement(img_bvh, ref, "bvh vs oracle image")

    # hit masks and triangle ids on the frame's own (tile-major) rays
    tile = tiled._hit_tile(cfg, tiled.effective_tile_px(cfg) ** 2)
    o, d, _, _ = primary_rays_tiled(W, H, tiled.effective_tile_px(cfg),
                                    cfg.camera.focal, view_matrix=view)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t_k, i_k = jax.jit(lambda p, o, d: tiled.hits(
        p, o, d, tile, cfg.mt_eps, cfg.cull_maxv, apex=True,
        kernel=cfg.kernel))(prep, o, d)
    t_o, i_o = jax.jit(lambda s, o, d: brute_force_hits(
        s, o, d, cfg.mt_eps, chunk=ORACLE_CHUNK))(prep.scene, o, d)
    t_k, i_k, t_o, i_o = map(np.asarray, (t_k, i_k, t_o, i_o))
    mk, mo = np.isfinite(t_k), np.isfinite(t_o)
    mask_agree = float((mk == mo).mean())
    both = mk & mo
    id_agree = float((i_k[both] == i_o[both]).mean())
    log(f"  hit mask agreement {mask_agree:.6f} (>= {MASK_AGREE}), "
        f"triangle ids {id_agree:.6f} on {int(both.sum())} hit rays "
        f"(>= {ID_AGREE})")
    assert mask_agree >= MASK_AGREE and id_agree >= ID_AGREE
    state.update(agree=dict(mask=mask_agree, ids=id_agree))

    # each kernel against its plain twin on the same plan
    plan = tiled.cull(prep, o, d, tile, cfg.cull_maxv,
                      wb=cfg.kernel.window_blocks, apex=True)
    rays, R = walk.pack_rays(o, d, tile)
    wargs = tiled._walk_args(prep, tile, cfg.mt_eps, cfg.kernel)
    t1, i1 = walk.nearest(plan, rays, prep.geom, **wargs)
    t2, i2 = walk.nearest_reference(plan, rays, prep.geom, tile=tile,
                                    window=wargs["window"], eps=cfg.mt_eps)
    t1, i1, t2, i2 = map(np.asarray, (t1, i1, t2, i2))
    same_t = np.isclose(t1, t2, rtol=1e-5, atol=0.0) | (t1 == t2)
    log(f"  nearest kernel vs plain twin: t {float(same_t.mean()):.6f}, "
        f"ids {float((i1 == i2).mean()):.6f}")
    assert same_t.mean() >= ID_AGREE and (i1 == i2).mean() >= ID_AGREE
    hitm = np.isfinite(t1)
    p = np.where(hitm[:, None], np.asarray(o) + np.where(
        hitm, t1, 0.0)[:, None] * np.asarray(d), 0.0)
    so = np.asarray(prep.scene.tri_obj)[np.maximum(i1, 0)]
    dl = np.asarray(light, np.float32)[None] - p
    splan = tiled.cull(prep, jnp.asarray(p), jnp.asarray(dl), tile,
                       cfg.cull_maxv, wb=cfg.kernel.window_blocks)
    srays, _ = walk.pack_rays(jnp.asarray(p), jnp.asarray(dl), tile,
                              jnp.asarray(so))
    f1 = np.asarray(walk.anyhit(splan, srays, prep.geom, **wargs))
    f2 = np.asarray(walk.anyhit_reference(splan, srays, prep.geom,
                                          tile=tile, window=wargs["window"],
                                          eps=cfg.mt_eps))
    agree = float((f1 == f2)[:R][hitm].mean())
    log(f"  any-hit kernel vs plain twin: {agree:.6f} of hit rays, "
        f"shadowed {float(f1[:R][hitm].mean()):.4f}")
    assert agree >= ID_AGREE


def _native_used() -> str:
    from simple_raytracer.native import native_available
    return "C++" if native_available() else "numpy"


def phase_soft_and_textured(state):
    from simple_raytracer.config import LightConfig
    scene, view, light = _scene("flagship")
    cfg = _cfg(600, 400, light=LightConfig(num_samples=16))
    img = _render(scene, cfg, light, view)
    ref = _render(scene, _oracle_cfg(cfg), light, view)
    _image_agreement(img, ref, "S=16 soft shadows vs oracle")
    scene, view, light = _scene("textured")
    assert scene.has_textures
    cfg = _cfg(600, 400)
    img = _render(scene, cfg, light, view)
    ref = _render(scene, _oracle_cfg(cfg), light, view)
    _image_agreement(img, ref, "textured scene vs oracle")


def phase_animate(state):
    from simple_raytracer.cli import main as cli_main
    out = tempfile.mkdtemp(prefix="srt_anim_")
    t0 = time.time()
    rc = cli_main(["animate", "--scene", "complex", "--width", "600",
                   "--height", "400", "--step-deg", "90", "--fmt", "png",
                   "--out-dir", out, "--no-resume"])
    files = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    sizes = [os.path.getsize(os.path.join(out, f)) for f in files]
    log(f"  animate rc={rc}: {len(files)} frames {files} "
        f"({min(sizes) if sizes else 0}..{max(sizes) if sizes else 0} B) "
        f"in {time.time() - t0:.1f} s")
    assert rc == 0 and len(files) == 4 and min(sizes) > 1000
    for f in files:
        with open(os.path.join(out, f), "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n", f


def phase_train(state):
    import numpy as np
    import jax.numpy as jnp
    from simple_raytracer.accel.prepared import prepare
    from simple_raytracer.dist import extract_params, make_train_step
    from simple_raytracer.render.renderer import render_radiance
    scene, _, light = _scene("flagship", bake_view=True)
    cfg = _cfg(960, 540)
    prep = prepare(scene, cfg)
    light = jnp.asarray(light, jnp.float32)
    rad, hit = render_radiance(prep, cfg, light)
    target = jnp.where(hit[..., None], rad, 0.0)
    params = extract_params(prep.scene, light)
    params.light_pos = params.light_pos + 40.0
    params.obj_color = params.obj_color * 0.6
    step = make_train_step(prep, cfg, lr=0.5)
    losses = []
    for _ in range(5):
        params, loss = step(params, target)
        losses.append(float(loss))
    log(f"  train losses {['%.6g' % x for x in losses]}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def _time_frames(prep, cfg, light, view, frames):
    """(compile+first s, steady ms/frame) of `frames` view-varied frames in
    one device program, each ending in block_until_ready."""
    import jax
    import jax.numpy as jnp
    from simple_raytracer.render import integrator
    from simple_raytracer.render.renderer import render_radiance

    @jax.jit
    def many(prep, light, V0):
        def one(i, acc):
            # an epsilon camera shift per frame: identical work, but no
            # stage is loop-invariant (XLA would hoist it otherwise)
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


def phase_timing(state):
    import jax
    prep, cfg = state["flag_prep"], state["flag_cfg"]
    light, view = state["flag_light"], state["flag_view"]
    res = {}
    for name, c, frames, ctx in (
            ("tiled (Triton walk)", cfg, 16, contextlib.nullcontext),
            ("tiled (plain jnp walk)", cfg, 2, plain_walk),
            ("bvh", cfg.replace(mode="bvh"), 2, contextlib.nullcontext)):
        with ctx():
            first, ms = _time_frames(prep, c, light, view, frames)
        res[name] = ms
        log(f"  {name}: {ms:.3f} ms/frame over {frames} frames; compile + "
            f"first call {first:.2f} s")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    state["timing"] = res
    fastest = min(res, key=res.get)
    log(f"  fastest end to end: {fastest}")
    assert fastest == "tiled (Triton walk)", res


def phase_gpu_tests(state):
    import pytest
    os.environ["SRT_TESTS_ON_GPU"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")])
    log(f"  pytest -m gpu rc={int(rc)}")
    assert int(rc) == 0, rc


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------

def phase_cards(state, n):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from simple_raytracer.accel.prepared import prepare
    from simple_raytracer.dist import (make_mesh, render_sharded,
                                           extract_params, make_train_step)
    from simple_raytracer.dist.ring import render_composed
    from simple_raytracer.driver.animation import (frames_batched,
                                                       frames_parallel)
    from simple_raytracer.render.renderer import render_radiance
    from simple_raytracer.scene.catalog import orbit_view

    assert len(jax.devices()) >= n, f"{len(jax.devices())} devices < {n}"
    scene, _, light = _scene("flagship", bake_view=True)
    cfg = _cfg(960, 544)
    prep = prepare(scene, cfg)
    one = _render(prep, cfg, light)
    mesh = make_mesh(n, ("dp",))
    dp = np.asarray(render_sharded(prep, cfg, light, mesh))
    # the same DP program on one card: identical per-device work
    dp1 = np.asarray(render_sharded(prep, cfg, light, make_mesh(1, ("dp",))))
    same = float((dp == dp1).all(-1).mean())
    log(f"  DP render on {n} cards vs the DP program on one card: "
        f"{same:.6f} pixels equal")
    assert same == 1.0
    # render() orders rays by pixel tile, DP by image row: XLA fuses the
    # shading differently, so the oracle's tolerance applies
    _image_agreement(dp, one, f"DP render on {n} cards vs render()")

    cscene, _, clight = _scene("complex", bake_view=False)
    ccfg = _cfg(600, 400, focal=400.0)
    cprep = prepare(cscene, ccfg)
    views = np.stack([orbit_view(a, 50.0, -50.0, 30.0)
                      for a in np.arange(0.0, 360.0, 360.0 / (2 * n))])
    fp = np.asarray(frames_parallel(cprep, ccfg, views, clight, mesh,
                                    axis="dp"))
    fp1 = np.asarray(frames_parallel(cprep, ccfg, views, clight,
                                     make_mesh(1, ("dp",)), axis="dp"))
    same = float((fp == fp1).all(-1).mean())
    log(f"  frame-parallel sweep ({len(views)} frames) on {n} cards vs one "
        f"card: {same:.6f} pixels equal")
    assert same == 1.0
    fb = np.asarray(frames_batched(cprep, ccfg, views, clight))
    _image_agreement(fp.reshape(-1, fp.shape[-2], 3),
                     fb.reshape(-1, fb.shape[-2], 3),
                     "frame-parallel vs the one-card sweep driver")

    gp = 2
    mesh2 = make_mesh(n, ("dp", "gp"), shape=(n // gp, gp))
    comp = np.asarray(render_composed(scene, cfg, light, mesh2))
    same = float((comp == one).all(-1).mean())
    log(f"  composed dp{n // gp} x gp{gp} ring render vs one card: "
        f"{same:.6f} pixels equal (>= 0.995)")
    assert same >= 0.995

    lj = jnp.asarray(light, jnp.float32)
    rad, hit = render_radiance(prep, cfg, lj)
    target = jnp.where(hit[..., None], rad, 0.0)
    p0 = extract_params(prep.scene, lj)
    p0.light_pos = p0.light_pos + 40.0
    p0.obj_color = p0.obj_color * 0.6
    losses = {}
    for name, m in (("one card", None), (f"DP {n} cards", mesh)):
        step = make_train_step(prep, cfg, mesh=m, lr=0.5)
        p, ls = p0, []
        for _ in range(3):
            p, loss = step(p, target)
            ls.append(float(loss))
        losses[name] = ls
        log(f"  train {name}: losses {['%.6g' % x for x in ls]}")
    a, b = losses["one card"], losses[f"DP {n} cards"]
    assert np.allclose(a, b, rtol=1e-4), losses


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the multi-card paths")
    args = ap.parse_args(argv)
    try:
        import jax
        from simple_raytracer.utils.compile_cache import (
            enable_compile_cache)
    except ImportError as e:
        print(f"chip_smoke: the raytracer package is missing ({e})",
              file=sys.stderr)
        return 2
    try:
        devs = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: no accelerator ({e})", file=sys.stderr)
        return 2
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 2
    log(f"device_kind {devs[0].device_kind}, count {len(devs)}")
    log(card_line())
    log(f"compile cache: {enable_compile_cache()}")

    if args.cards > 1:
        phases = [(f"cards x{args.cards}",
                   lambda s: phase_cards(s, args.cards))]
    else:
        phases = [("flagship 1920x1080", phase_flagship),
                  ("soft shadows + textured 600x400",
                   phase_soft_and_textured),
                  ("animate", phase_animate),
                  ("train 960x540", phase_train),
                  ("timing", phase_timing),
                  ("gpu tests", phase_gpu_tests)]
    state, failed = {}, []
    t_all = time.time()
    for name, fn in phases:
        log(f"== {name}")
        t0 = time.time()
        try:
            fn(state)
            log(f"   ok ({time.time() - t0:.1f} s)")
        except Exception:                      # noqa: BLE001 - report all
            traceback.print_exc()
            log(f"   FAILED ({time.time() - t0:.1f} s)")
            failed.append(name)
    log(f"total {time.time() - t_all:.1f} s; failed phases: {failed}")
    if failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
