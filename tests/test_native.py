"""Native (C++) runtime components vs pure-Python reference paths."""

import os

import numpy as np
import pytest

from simple_raytracer.native import (bvh_build_native, native_available,
                                         obj_parse_native)
from simple_raytracer.accel.bvh import build_bvh
from simple_raytracer.scene.obj_loader import (_parse_obj_python,
                                                   load_obj, TextureRegistry)
from simple_raytracer.scene.generated import blob_mesh

from conftest import stand_in_obj


needs_native = pytest.mark.skipif(not native_available(),
                                  reason="native build unavailable")


@needs_native
def test_native_bvh_matches_python():
    rng = np.random.default_rng(7)
    for T in (0, 1, 5, 8, 9, 100, 1000):
        verts = rng.standard_normal((T, 3, 3)).astype(np.float32)
        py = build_bvh(verts, 8, use_native=False)
        nt = build_bvh(verts, 8, use_native=True)
        np.testing.assert_array_equal(py.node_min, nt.node_min, err_msg=f"T={T}")
        np.testing.assert_array_equal(py.node_max, nt.node_max)
        np.testing.assert_array_equal(py.skip, nt.skip)
        np.testing.assert_array_equal(py.leaf_first, nt.leaf_first)
        np.testing.assert_array_equal(py.leaf_count, nt.leaf_count)
        np.testing.assert_array_equal(py.perm, nt.perm)
        assert py.max_leaf == nt.max_leaf and py.depth == nt.depth


@needs_native
def test_native_bvh_bunny_matches_python():
    verts = blob_mesh().verts[..., :3]          # the 81,920-triangle stand-in
    py = build_bvh(verts, 8, use_native=False)
    nt = build_bvh(verts, 8, use_native=True)
    np.testing.assert_array_equal(py.skip, nt.skip)
    np.testing.assert_array_equal(py.perm, nt.perm)
    np.testing.assert_allclose(py.node_min, nt.node_min)


@needs_native
@pytest.mark.parametrize("rel", ["cube.obj", "sphere.obj",
                                 "obj/stanford-bunny.obj",
                                 "obj/tree/tree.obj"])
def test_native_obj_parse_matches_python(rel, tmp_path):
    path = stand_in_obj(tmp_path, rel)
    py = _parse_obj_python(path)
    nt = obj_parse_native(path)
    assert nt is not None
    for a, b, name in zip(py, nt, ("pos", "uv", "nrm", "faces", "fmtl")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{rel}:{name}")
    assert py[5] == nt[5]   # usemtl names


@needs_native
def test_load_obj_native_and_python_identical(tmp_path):
    path = stand_in_obj(tmp_path, "obj/tree/tree.obj")
    m_native = load_obj(path, textures=TextureRegistry(root=str(tmp_path)))
    os.environ["SRT_NO_NATIVE"] = "1"
    try:
        m_py = load_obj(path, textures=TextureRegistry(root=str(tmp_path)))
    finally:
        del os.environ["SRT_NO_NATIVE"]
    assert m_native.num_triangles == 960 and m_native.textures
    np.testing.assert_array_equal(m_native.verts, m_py.verts)
    np.testing.assert_array_equal(m_native.uvs, m_py.uvs)
    np.testing.assert_array_equal(m_native.tri_color, m_py.tri_color)
    np.testing.assert_array_equal(m_native.tri_tex, m_py.tri_tex)
    assert m_native.textures == m_py.textures
