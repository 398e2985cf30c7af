"""Test configuration: force an 8-device virtual CPU mesh.

Must run before jax is imported anywhere — pytest imports conftest first.
The CPU mesh is the stand-in backend for the multi-device sharding tests
(the same shard_map code runs on a GPU mesh).  Tests marked ``gpu`` need a
CUDA card: chip_smoke.py runs them on one (it sets SRT_TESTS_ON_GPU=1, and
then nothing here pins the CPU); here they skip.
"""

import os

ON_GPU = os.environ.get("SRT_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    # 8 virtual devices x multi-threaded Eigen ops spend most of the suite
    # in scheduler spin; single-threaded Eigen is faster here
    if "xla_cpu_multi_thread_eigen" not in flags:
        flags = (flags + " --xla_cpu_multi_thread_eigen=false").strip()
    os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from simple_raytracer.config import KernelConfig  # noqa: E402

# The walk kernels run in the Pallas interpreter on the CPU.
INTERPRET = KernelConfig(interpret=True)


@pytest.fixture
def gpu():
    """Skip unless the default backend is a CUDA GPU (decided when the test
    runs, never at import: every xdist worker must collect the same
    tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run: python chip_smoke.py)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def write_obj(path, mesh, normals=True, texture=None):
    """Write a generated MeshData as an OBJ file (per-corner v/vt/vn, one
    face per triangle) for the loader tests.  ``texture`` ([H, W, 3] uint8)
    adds an MTL + PNG pair and per-corner texture coordinates in [0, 1)."""
    import os as _os
    from simple_raytracer.io.image import write_png
    p = mesh.verts[..., :3].reshape(-1, 3)
    lines = []
    if texture is not None:
        base = _os.path.splitext(_os.path.basename(path))[0]
        d = _os.path.dirname(path)
        write_png(_os.path.join(d, base + ".png"), texture)
        with open(_os.path.join(d, base + ".mtl"), "w") as f:
            f.write(f"newmtl m0\nmap_Kd {base}.png\n")
        lines += [f"mtllib {base}.mtl", "usemtl m0"]
    lines += [f"v {x:.7g} {y:.7g} {z:.7g}" for x, y, z in p]
    if texture is not None:
        uv = (p[:, [0, 1]] - p[:, [0, 1]].min(0)) / np.maximum(
            np.ptp(p[:, [0, 1]], 0), 1e-20) * 0.999
        lines += [f"vt {u:.7g} {v:.7g}" for u, v in uv]
    if normals:
        lines += [f"vn {x:.7g} {y:.7g} {z:.7g}"
                  for x, y, z in mesh.normals.reshape(-1, 3)]
    for t in range(mesh.num_triangles):
        c = [3 * t + k + 1 for k in range(3)]
        if texture is not None and normals:
            lines.append("f " + " ".join(f"{i}/{i}/{i}" for i in c))
        elif texture is not None:
            lines.append("f " + " ".join(f"{i}/{i}" for i in c))
        elif normals:
            lines.append("f " + " ".join(f"{i}//{i}" for i in c))
        else:
            lines.append("f " + " ".join(str(i) for i in c))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def stand_in_obj(tmp_path, rel):
    """The generated stand-in for the reference asset ``rel`` as an OBJ
    file under tmp_path: cube.obj, sphere.obj, obj/stanford-bunny.obj
    (no normals, like the bunny) or obj/tree/tree.obj (textured)."""
    from simple_raytracer.scene import generated as G
    path = os.path.join(str(tmp_path), rel.replace("/", "_"))
    if rel == "cube.obj":
        return write_obj(path, G.cube_mesh())
    if rel == "sphere.obj":
        return write_obj(path, G.uv_sphere_mesh())
    if rel == "obj/stanford-bunny.obj":
        return write_obj(path, G.blob_mesh(), normals=False)
    if rel == "obj/tree/tree.obj":
        return write_obj(path, G.uv_sphere_mesh(), texture=G.leaf_texture())
    raise KeyError(rel)
