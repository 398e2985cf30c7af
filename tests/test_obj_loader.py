"""OBJ/MTL/texture loader tests (reference: Object.cpp:25-170)."""

import os

import numpy as np
import pytest

from simple_raytracer.scene.obj_loader import (
    TextureRegistry, load_obj)

from conftest import stand_in_obj



def test_missing_file_soft_failure(capsys):
    """Missing OBJ prints to stderr and yields an empty mesh (Object.cpp:35-39)."""
    mesh = load_obj("/nonexistent/cat.obj")
    assert mesh.num_triangles == 0
    assert "cat.obj" in capsys.readouterr().err


def test_inline_obj(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n")
    mesh = load_obj(str(p))
    assert mesh.num_triangles == 1
    np.testing.assert_allclose(mesh.verts[0, :, 3], 1.0)          # homogeneous w
    np.testing.assert_allclose(mesh.verts[0, 1, :3], [1, 0, 0])
    np.testing.assert_allclose(mesh.normals[0, 0], [0, 0, 1])
    assert mesh.tri_tex[0] == -1


def test_quad_fan_triangulation(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    mesh = load_obj(str(p))
    assert mesh.num_triangles == 2


def test_negative_indices(tmp_path):
    p = tmp_path / "neg.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    mesh = load_obj(str(p))
    assert mesh.num_triangles == 1
    np.testing.assert_allclose(mesh.verts[0, 2, :3], [0, 1, 0])


def test_uv_bake_semantics(tmp_path):
    """UV bake: u = floor(tx*W) % W, v = floor((1-ty)*H) % H, positive mod,
    plus vertex-0 color sampling (Object.cpp:113-125)."""
    from PIL import Image
    img = np.zeros((4, 8, 3), np.uint8)
    img[3, 2] = (255, 0, 0)      # the texel vertex 0 should hit
    Image.fromarray(img).save(tmp_path / "tex.png")
    (tmp_path / "m.mtl").write_text("newmtl m0\nmap_Kd tex.png\n")
    # vertex 0: tx=0.25, ty=0.1 -> u=floor(0.25*8)%8=2, v=floor(0.9*4)%4=3
    (tmp_path / "t.obj").write_text(
        "mtllib m.mtl\nusemtl m0\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vt 0.25 0.1\nvt 0.5 0.5\nvt 0.75 0.9\n"
        "f 1/1 2/2 3/3\n")
    mesh = load_obj(str(tmp_path / "t.obj"))
    assert mesh.num_triangles == 1
    np.testing.assert_allclose(mesh.uvs[0, 0], [2, 3])
    np.testing.assert_allclose(mesh.tri_color[0], [1.0, 0.0, 0.0])
    assert mesh.tri_tex[0] == 0
    # negative-u wrap: floor stays negative, positive modulo fixes it
    (tmp_path / "t2.obj").write_text(
        "mtllib m.mtl\nusemtl m0\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vt -0.125 0.1\nvt 0.5 0.5\nvt 0.75 0.9\n"
        "f 1/1 2/2 3/3\n")
    mesh2 = load_obj(str(tmp_path / "t2.obj"))
    assert mesh2.uvs[0, 0, 0] == (int(np.floor(-0.125 * 8)) % 8 + 8) % 8 == 7


def test_reference_asset_counts(tmp_path):
    """Triangle counts of the generated stand-ins, through OBJ files (the
    reference's cube.obj has the same 12; its bunny has 69,451)."""
    assert load_obj(stand_in_obj(tmp_path, "cube.obj")).num_triangles == 12
    assert load_obj(stand_in_obj(tmp_path, "sphere.obj")).num_triangles \
        == 960
    bunny = load_obj(stand_in_obj(tmp_path, "obj/stanford-bunny.obj"))
    assert bunny.num_triangles == 81920
    # bunny has no normals or UVs
    assert np.all(bunny.normals == 0)
    assert np.all(bunny.tri_tex == -1)


def test_tree_texture_loads(tmp_path):
    reg = TextureRegistry(root=str(tmp_path))
    mesh = load_obj(stand_in_obj(tmp_path, "obj/tree/tree.obj"),
                    textures=reg)
    assert mesh.num_triangles > 0
    assert len(mesh.textures) == 1          # the foliage diffuse map
    assert np.any(mesh.tri_tex >= 0)
