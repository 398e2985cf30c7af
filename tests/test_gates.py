"""The tiled path's shape rules: pixel tile, walk tile, shadow tiles, the
soft-shadow cull, and where the defaults live (config.KernelConfig)."""

import types

import jax
import jax.numpy as jnp

from simple_raytracer.config import default_config, KernelConfig
from simple_raytracer.kernels import tiled
from simple_raytracer.scene.generated import cube_mesh, uv_sphere_mesh

from conftest import INTERPRET


def test_tile_px_gate():
    """Square 16px pixel tiles (256 rays) for every scene; an explicit
    tile_px wins."""
    cfg = default_config()
    assert cfg.tile_px == 0
    for tris in (12, 81_932, 1 << 22):
        assert tiled.effective_tile_px(cfg, tris) == 16
    assert tiled.effective_tile_px(cfg.replace(tile_px=8)) == 8


def test_shadow_tile_gate():
    """Hard shadows walk the nearest pass's tiles; the folded S-sample pass
    packs tile // S points x S samples into one walk tile, padded up to a
    power of two."""
    assert tiled._fold_shape(128, 16) == (8, 128, 128)
    assert tiled._fold_shape(128, 4) == (32, 128, 128)
    assert tiled._fold_shape(128, 3) == (42, 126, 128)
    assert tiled._fold_shape(128, 200) == (1, 200, 256)
    for tile in (64, 128, 256):
        for S in range(1, 40):
            ts, rows, kt = tiled._fold_shape(tile, S)
            assert rows == S * ts <= kt and kt & (kt - 1) == 0


def test_hourglass_gate(monkeypatch):
    """Hard shadows (one shared light) take the projective light-apex
    cull; soft shadows (S lights per point) take the apex-aware hourglass
    cull instead; neither ever drops an occluder (both match brute force
    in tests/test_tiled.py)."""
    from simple_raytracer.accel.prepared import prepare
    from simple_raytracer.scene.scene import SceneManager
    import simple_raytracer.scene.transforms as T
    sm = SceneManager()
    sm.add_mesh("cube", cube_mesh())
    sm.transform_triangles("cube", T.translate((0.0, 5.0, 60.0))
                           @ T.scale(5.0, 5.0, 5.0))
    sm.add_mesh("s", uv_sphere_mesh())
    sm.transform_triangles("s", T.translate((0.0, -4.0, 60.0)))
    prep = prepare(sm.build(), default_config())
    seen = []
    orig = tiled.cull

    def spy(*a, **k):
        seen.append((k.get("hourglass", False), k.get("apex_rev", False)))
        return orig(*a, **k)
    monkeypatch.setattr(tiled, "cull", spy)
    p = jnp.tile(jnp.asarray([[0.0, 0.0, 55.0]]), (512, 1))
    light = jnp.broadcast_to(jnp.asarray([500.0, -300.0, -200.0]), p.shape)
    so = jnp.zeros((512,), jnp.int32)
    tiled.tiled_shadow_fn(prep, 128, 1e-12, kernel=INTERPRET)(p, light, so)
    assert seen == [(False, True)]
    tiled.tiled_shadow_fn(prep, 128, 1e-12, num_samples=4,
                          kernel=INTERPRET)(p, light, so)
    assert seen[1] == (True, False)
    tiled.tiled_shadow_fn(prep, 128, 1e-12, kernel=INTERPRET,
                          shared_light=False)(p, light, so)
    assert seen[2] == (False, False)


def test_hit_tile_gate():
    """The walk tile is kernel.ray_tile consecutive rays of the tile-major
    stream, or the whole pixel tile when that is smaller."""
    cfg = default_config()
    assert cfg.kernel.ray_tile == 128
    assert tiled._hit_tile(cfg, 256) == 128
    assert tiled._hit_tile(cfg, 64) == 64
    cfg256 = cfg.replace(kernel=KernelConfig(ray_tile=256))
    assert tiled._hit_tile(cfg256, 1024) == 256


def test_kernel_config_is_the_source_of_tuning_defaults():
    """The walk's shape comes from KernelConfig alone: the wrapper
    arguments follow its fields, and no environment variable of the
    package changes them (the only one left selects the host BVH
    builder)."""
    import os
    import re
    prep = types.SimpleNamespace(block_size=32)
    kc = KernelConfig()
    assert tiled._walk_args(prep, 128, 1e-12, kc) == dict(
        tile=128, window=kc.window_blocks * 32, chunk=kc.chunk,
        eps=1e-12, num_warps=kc.num_warps, interpret=False)
    assert (kc.ray_tile, kc.window_blocks, kc.chunk, kc.num_warps) == \
        (128, 4, 32, 16)
    # a chunk wider than the window is clamped to the window
    narrow = tiled._walk_args(prep, 128, 1e-12,
                              KernelConfig(window_blocks=1, chunk=64))
    assert narrow["chunk"] == narrow["window"] == 32
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "simple_raytracer")
    knobs = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    knobs |= set(re.findall(r"SRT_[A-Z_]+", fh.read()))
    assert knobs == {"SRT_NO_NATIVE"}, knobs


def test_default_mode_follows_platform(monkeypatch):
    """mode='auto' (the default) is the Triton walk on a GPU and the jnp
    oracle elsewhere; an explicit mode is kept."""
    assert default_config().mode == "bruteforce"        # CPU test host
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert default_config().mode == "tiled"
    assert default_config().replace(mode="bvh").mode == "bvh"
