"""Transform factory tests (reference: Transformation.cpp)."""

import numpy as np

from simple_raytracer.scene import transforms as T


def test_scale():
    m = T.scale(2.0, 3.0, 4.0)
    v = m @ np.array([1.0, 1.0, 1.0, 1.0], np.float32)
    np.testing.assert_allclose(v, [2, 3, 4, 1])


def test_translate():
    m = T.translate([1.0, 2.0, 3.0])
    v = m @ np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    np.testing.assert_allclose(v, [1, 2, 3, 1])


def test_rotations_are_transposed_glm():
    """The reference's GLM column-major factories equal the TRANSPOSE of
    standard rotations (i.e. rotate by -angle) — Transformation.cpp:15-47."""
    a = 0.7

    def std_rx(t):
        c, s = np.cos(t), np.sin(t)
        return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float32)

    def std_ry(t):
        c, s = np.cos(t), np.sin(t)
        return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float32)

    def std_rz(t):
        c, s = np.cos(t), np.sin(t)
        return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)

    np.testing.assert_allclose(T.rotate_x(a), std_rx(-a), atol=1e-6)
    np.testing.assert_allclose(T.rotate_y(a), std_ry(-a), atol=1e-6)
    np.testing.assert_allclose(T.rotate_z(a), std_rz(-a), atol=1e-6)


def test_rotation_orthonormal():
    for f in (T.rotate_x, T.rotate_y, T.rotate_z):
        m = f(1.2345)[:3, :3]
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-6)


def test_mirror_and_shear():
    m = T.mirror(mx=True)
    np.testing.assert_allclose(np.diag(m), [-1, 1, 1, 1])
    s = T.shear(shear_xy=0.5)
    v = s @ np.array([1.0, 2.0, 3.0, 1.0], np.float32)
    np.testing.assert_allclose(v, [1 + 0.5 * 2, 2, 3, 1])


def test_view_matrix_composition():
    """view = T(pos) @ Rz @ Ry @ Rx (Transformation.cpp:84-90)."""
    pos = np.array([1.0, 2.0, 3.0], np.float32)
    rot = (0.1, 0.2, 0.3)
    v = T.view_matrix(pos, rot)
    expect = T.translate(pos) @ T.rotate_z(0.3) @ T.rotate_y(0.2) @ T.rotate_x(0.1)
    np.testing.assert_allclose(v, expect, atol=1e-6)


def test_apply_transform_batched():
    verts = np.random.default_rng(0).normal(size=(5, 3, 4)).astype(np.float32)
    m = T.view_matrix([1, 2, 3], (0.1, 0.2, 0.3))
    out = T.apply_transform(m, verts)
    for t in range(5):
        for v in range(3):
            np.testing.assert_allclose(out[t, v], m @ verts[t, v], rtol=1e-5)
