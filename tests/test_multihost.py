"""Executes the multi-process path for real: two CPU-backend processes join
through ``jax.distributed.initialize`` (dist/multihost.py) on a local
coordinator, build the global mesh, and render through shard_map with a psum
checksum.  This is the bootstrap code a multi-host run uses."""

import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest


from simple_raytracer.scene.generated import cube_mesh


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_init_and_render():
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)            # worker sets its own device count
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=os.path.dirname(worker))
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)

    checks = [line for out in outs for line in out.splitlines()
              if line.startswith("CHECK ")]
    assert len(checks) == 2, outs
    vals = [c.split() for c in checks]
    # both processes saw 2 processes x 2 devices = 4 global devices
    for v in vals:
        assert v[1] == "2" and v[2] == "4", checks
    # psum checksum identical across processes
    assert vals[0][3] == vals[1][3], checks

    # ... and equal to the single-process render of the same scene
    from simple_raytracer.config import default_config, CameraConfig
    from simple_raytracer.render.renderer import render_radiance
    from simple_raytracer.scene.scene import SceneManager
    import simple_raytracer.scene.transforms as T
    sm = SceneManager()
    sm.add_mesh("cube", cube_mesh())
    sm.set_color("cube", (0.2, 0.8, 0.3))
    sm.transform_triangles(
        "cube", T.translate((0.0, 0.0, 60.0)) @ T.scale(10.0, 10.0, 10.0))
    cfg = default_config().replace(camera=CameraConfig(width=32, height=16))
    rad, hit = render_radiance(sm.build(), cfg,
                               jnp.array([100.0, -100.0, -50.0]))
    expect = float(jnp.sum(jnp.where(hit[..., None], rad, 0.0)))
    np.testing.assert_allclose(float(vals[0][3]), expect, rtol=1e-4)
