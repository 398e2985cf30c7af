"""Worker for the 2-process jax.distributed smoke test (test_multihost.py).

Runs as: python _multihost_worker.py <coordinator> <num_procs> <proc_id>
Each process exposes 2 virtual CPU devices -> a 4-device global mesh.
Prints one line ``CHECK <process_count> <device_count> <checksum>`` that the
parent compares across processes and against the single-process render.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from simple_raytracer.scene.generated import cube_mesh  # noqa: E402


def main():
    coordinator, num_procs, proc_id = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

    from simple_raytracer.dist.multihost import (init_distributed,
                                                     global_mesh)
    multi = init_distributed(coordinator=coordinator,
                             num_processes=num_procs, process_id=proc_id)
    assert multi, "init_distributed did not report multi-process"
    assert jax.process_count() == num_procs

    mesh = global_mesh(("dp",))

    from simple_raytracer.config import default_config, CameraConfig
    from simple_raytracer.render.renderer import render_flat
    from simple_raytracer.ops.camera import primary_rays
    from simple_raytracer.scene.scene import SceneManager
    import simple_raytracer.scene.transforms as T

    sm = SceneManager()
    sm.add_mesh("cube", cube_mesh())
    sm.set_color("cube", (0.2, 0.8, 0.3))
    sm.transform_triangles(
        "cube", T.translate((0.0, 0.0, 60.0)) @ T.scale(10.0, 10.0, 10.0))
    scene = jax.device_put(sm.build())
    cfg = default_config().replace(camera=CameraConfig(width=32, height=16))
    light = jnp.array([100.0, -100.0, -50.0], jnp.float32)

    def body(scene, light):
        # rays generated INSIDE the jitted body and sliced per device: no
        # host-sharded inputs needed across processes
        o, d = primary_rays(32, 16)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        n = jax.lax.axis_size("dp")
        i = jax.lax.axis_index("dp")
        chunk = o.shape[0] // n
        o = jax.lax.dynamic_slice_in_dim(o, i * chunk, chunk)
        d = jax.lax.dynamic_slice_in_dim(d, i * chunk, chunk)
        rad, hit = render_flat(scene, cfg, o, d, light)
        s = jnp.sum(jnp.where(hit[:, None], rad, 0.0))
        return jax.lax.psum(s, "dp")

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P()),
                              out_specs=P()))
    checksum = float(f(scene, light))
    print(f"CHECK {jax.process_count()} {jax.device_count()} {checksum:.6f}",
          flush=True)


if __name__ == "__main__":
    main()
