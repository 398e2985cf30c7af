"""Command-line interface.

The reference has no CLI: scene choice = commenting blocks of main() in or
out, every knob a recompiled constant (SURVEY.md §5 lists them all).  This
CLI exposes each of those constants as a flag over the scene catalog.

  python -m simple_raytracer render  --scene complex --angle 0 --out f.png
  python -m simple_raytracer animate --scene complex --out-dir gen/
  python -m simple_raytracer train   --scene one_cube --steps 100
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .scene.catalog import CATALOG as _CATALOG

CATALOG_NAMES = tuple(_CATALOG)


def _add_render_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="complex",
                   choices=sorted(CATALOG_NAMES))
    p.add_argument("--width", type=int, default=600)       # :773
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--focal", type=float, default=400.0)   # :506
    # auto = the Triton walk on a GPU, the jnp oracle elsewhere (see
    # config.RenderConfig.mode); bvh is the portable jnp BVH walk
    p.add_argument("--mode", default="auto",
                   choices=["auto", "bruteforce", "bvh", "tiled"])
    p.add_argument("--light-samples", type=int, default=1)  # :445
    p.add_argument("--no-shadows", action="store_true")     # :385-386
    p.add_argument("--smooth-normals", action="store_true")  # :162-164
    p.add_argument("--reinhard", type=float, default=0.5)   # :391
    p.add_argument("--gamma", type=float, default=1.1)      # :396
    p.add_argument("--no-tonemap", action="store_true")
    p.add_argument("--leaf-size", type=int, default=8)      # Object.cpp:261
    p.add_argument("--bvh-split", default="median",
                   choices=["median", "sah"],
                   help="median = reference topology; sah = surface area")
    p.add_argument("--tile-px", type=int, default=0,
                   help="tiled-mode pixel tile edge (0 = 16)")
    p.add_argument("--jitter-step", type=float, default=3.0)  # :372-382
    p.add_argument("--shadow-dim", type=float, default=5.0)   # :369
    p.add_argument("--bake-view", action="store_true",
                   help="reference mode: bake inverse(view) into geometry")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--profile", default=None, help="jax.profiler trace dir")


def _config_from(args):
    from .config import (RenderConfig, CameraConfig, LightConfig,
                         ShadingConfig, BVHConfig)
    return RenderConfig(
        camera=CameraConfig(width=args.width, height=args.height,
                            focal=args.focal),
        light=LightConfig(num_samples=args.light_samples,
                          jitter_step=args.jitter_step,
                          shadow_dim=args.shadow_dim,
                          enable_shadows=not args.no_shadows),
        shading=ShadingConfig(smooth_normals=args.smooth_normals,
                              reinhard_offset=args.reinhard,
                              gamma=args.gamma,
                              tonemap_enabled=not args.no_tonemap),
        bvh=BVHConfig(leaf_size=args.leaf_size, split=args.bvh_split),
        mode=args.mode,
        tile_px=args.tile_px)


def cmd_render(args) -> int:
    from .scene import catalog
    from .render.renderer import render
    from .io.image import save_image
    from .utils.metrics import Metrics, profile_trace

    cfg = _config_from(args)
    m = Metrics(args.metrics)
    builder = catalog.CATALOG[args.scene]
    t0 = time.time()
    sm, view, light = builder(args.angle, bake_view=args.bake_view)
    scene = sm.build()
    m.emit(event="scene", triangles=scene.num_triangles,
           seconds=round(time.time() - t0, 3))
    with profile_trace(args.profile):
        t0 = time.time()
        img = np.asarray(render(scene, cfg, light, view_matrix=view))
        dt = time.time() - t0
    m.emit(event="render", ms=round(dt * 1e3, 2),
           rays_per_s=round(args.width * args.height / dt, 1))
    save_image(args.out, img)
    m.emit(event="saved", path=args.out)
    if args.show:
        # the reference pops a blocking CImg window per frame
        # (simple_raytracer.cpp:495-497); PIL's viewer is the analog
        from PIL import Image
        Image.fromarray(img).show(title=f"{args.scene} @ {args.angle}")
    return 0


def cmd_animate(args) -> int:
    from .config import AnimationConfig
    from .driver.animation import render_turntable
    from .dist.sharding import make_mesh

    cfg = _config_from(args)
    anim = AnimationConfig(step_deg=args.step_deg,
                           orbit_radius=args.orbit_radius,
                           camera_y=args.camera_y,
                           pitch_deg=args.pitch_deg)
    mesh = None
    if args.frame_parallel:
        import jax
        mesh = make_mesh(len(jax.devices()), ("pp",))
    render_turntable(args.scene, cfg, anim, out_dir=args.out_dir,
                     fmt=args.fmt, world_space=not args.bake_view,
                     resume=not args.no_resume, metrics_path=args.metrics,
                     mesh=mesh)
    return 0


def cmd_train(args) -> int:
    import jax.numpy as jnp
    from .scene import catalog
    from .render.renderer import render_radiance
    from .dist import make_mesh, extract_params, make_train_step
    from .utils.checkpoint import save_checkpoint, load_checkpoint
    from .utils.metrics import Metrics

    cfg = _config_from(args).replace(mode="bruteforce")
    m = Metrics(args.metrics)
    sm, view, light = catalog.CATALOG[args.scene](args.angle,
                                                  bake_view=True)
    scene = sm.build()

    target, hit = render_radiance(scene, cfg, light)
    target = jnp.where(hit[..., None], target, 0.0)

    params = extract_params(scene, jnp.asarray(light))
    params.light_pos = params.light_pos + args.perturb
    params.obj_color = params.obj_color * 0.5
    start = 0
    if args.checkpoint:
        restored = load_checkpoint(args.checkpoint, params)
        if restored:
            params, start = restored
            m.emit(event="resumed", step=start)

    mesh = None
    if args.data_parallel:
        import jax
        mesh = make_mesh(len(jax.devices()), ("dp",))
    step = make_train_step(scene, cfg, mesh=mesh, lr=args.lr)
    for i in range(start, args.steps):
        params, loss = step(params, target)
        if i % args.log_every == 0 or i == args.steps - 1:
            m.emit(event="train", step=i, loss=float(loss))
        if args.checkpoint and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.checkpoint, params, i + 1)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, args.steps)
    return 0


def main(argv=None) -> int:
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(prog="simple_raytracer")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render one frame of a catalog scene")
    _add_render_flags(pr)
    pr.add_argument("--angle", type=float, default=0.0)
    pr.add_argument("--out", default="output.png")
    pr.add_argument("--show", action="store_true",
                    help="open a viewer window (reference :495-497)")
    pr.set_defaults(fn=cmd_render)

    pa = sub.add_parser("animate", help="turntable sweep (reference main())")
    _add_render_flags(pa)
    pa.add_argument("--out-dir", default="images/generation")
    pa.add_argument("--fmt", default="bmp", choices=["bmp", "png"])
    pa.add_argument("--step-deg", type=float, default=10.0)   # :534
    pa.add_argument("--orbit-radius", type=float, default=50.0)
    pa.add_argument("--camera-y", type=float, default=-50.0)
    pa.add_argument("--pitch-deg", type=float, default=30.0)
    pa.add_argument("--frame-parallel", action="store_true")
    pa.add_argument("--no-resume", action="store_true")
    pa.set_defaults(fn=cmd_animate)

    pt = sub.add_parser("train", help="fit scene params to a rendered target")
    _add_render_flags(pt)
    pt.add_argument("--angle", type=float, default=0.0)
    pt.add_argument("--steps", type=int, default=50)
    pt.add_argument("--lr", type=float, default=1e-5)
    pt.add_argument("--perturb", type=float, default=20.0)
    pt.add_argument("--data-parallel", action="store_true")
    pt.add_argument("--checkpoint", default=None)
    pt.add_argument("--ckpt-every", type=int, default=20)
    pt.add_argument("--log-every", type=int, default=10)
    pt.set_defaults(fn=cmd_train)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
