"""Scenes generated from a seed: no asset files.

Stand-ins for the reference's assets (leonlang/simple_raytracer keeps them
under obj/ and as cube.obj / sphere.obj): an analytic cube with the same 12
triangles as ``cube.obj``, a UV sphere, and the flagship stand-in for the
Stanford bunny — a closed, seeded, radially displaced icosphere of 81,920
triangles (the bunny has 69,451).  Every mesh is a :class:`MeshData` in the
OBJ loader's layout (homogeneous vertices, vertex normals, baked integer
texel coordinates), so SceneManager treats it like a loaded file.
"""

from __future__ import annotations

import numpy as np

from .obj_loader import MeshData
from . import transforms as T


def _mesh(pos: np.ndarray, faces: np.ndarray,
          vnormals: np.ndarray = None) -> MeshData:
    """Indexed triangles -> the loader's per-triangle SoA layout."""
    tri = pos[faces].astype(np.float32)                   # [F, 3, 3]
    F = tri.shape[0]
    verts = np.ones((F, 3, 4), np.float32)
    verts[..., :3] = tri
    nrm = (np.zeros((F, 3, 3), np.float32) if vnormals is None
           else vnormals[faces].astype(np.float32))
    return MeshData(verts=verts, normals=nrm,
                    uvs=np.zeros((F, 3, 2), np.float32),
                    tri_color=np.ones((F, 3), np.float32),
                    tri_tex=np.full((F,), -1, np.int32), textures=[])


def cube_mesh() -> MeshData:
    """The unit cube [-1, 1]^3 as 12 outward-wound triangles (two per face),
    the geometry of the reference's cube.obj."""
    pos = np.array([[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0)
                    for z in (-1.0, 1.0)], np.float32)    # index = 4x+2y+z
    quads = [(0, 1, 3, 2), (4, 6, 7, 5),                  # -x, +x
             (0, 4, 5, 1), (2, 3, 7, 6),                  # -y, +y
             (0, 2, 6, 4), (1, 5, 7, 3)]                  # -z, +z
    faces = []
    normals = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
        n = np.cross(pos[b] - pos[a], pos[c] - pos[a])
        normals += [n / np.linalg.norm(n)] * 2
    mesh = _mesh(pos, np.array(faces, np.int32))
    mesh.normals[:] = np.asarray(normals, np.float32)[:, None, :]
    return mesh


def uv_sphere_mesh(n_lat: int = 16, n_lon: int = 32) -> MeshData:
    """Unit UV sphere: ``2 * n_lon * (n_lat - 1)`` triangles, smooth
    vertex normals.  The meridians start half a step off the axes, so no
    edge lies in a coordinate plane (a camera on an axis would otherwise
    hit a column of edges exactly, where two triangles tie)."""
    th = np.linspace(0.0, np.pi, n_lat + 1)
    ph = (np.arange(n_lon) + 0.5) * (2.0 * np.pi / n_lon)
    st, ct = np.sin(th), np.cos(th)
    pos = np.stack([st[:, None] * np.cos(ph)[None, :],
                    np.broadcast_to(ct[:, None], (n_lat + 1, n_lon)),
                    st[:, None] * np.sin(ph)[None, :]], -1).reshape(-1, 3)

    def vid(i, j):
        return i * n_lon + (j % n_lon)
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                faces.append((a, b, d))
            if i < n_lat - 1:
                faces.append((a, d, c))
    pos = pos.astype(np.float32)
    return _mesh(pos, np.array(faces, np.int32), vnormals=pos)


def _icosphere(subdiv: int):
    """Unit icosphere: 20 * 4**subdiv triangles over shared vertices."""
    g = (1.0 + 5.0 ** 0.5) / 2.0
    pos = np.array([(-1, g, 0), (1, g, 0), (-1, -g, 0), (1, -g, 0),
                    (0, -1, g), (0, 1, g), (0, -1, -g), (0, 1, -g),
                    (g, 0, -1), (g, 0, 1), (-g, 0, -1), (-g, 0, 1)],
                   np.float64)
    faces = np.array([(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10),
                      (0, 10, 11), (1, 5, 9), (5, 11, 4), (11, 10, 2),
                      (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
                      (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5),
                      (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
                     np.int64)
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    for _ in range(subdiv):
        F = faces.shape[0]
        edges = np.sort(np.stack([faces[:, [0, 1]], faces[:, [1, 2]],
                                  faces[:, [2, 0]]], 1).reshape(-1, 2), 1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = pos[uniq[:, 0]] + pos[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = (inv.reshape(F, 3) + pos.shape[0])            # ab, bc, ca
        pos = np.concatenate([pos, mid])
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        ab, bc, ca = m[:, 0], m[:, 1], m[:, 2]
        faces = np.concatenate([np.stack([a, ab, ca], 1),
                                np.stack([b, bc, ab], 1),
                                np.stack([c, ca, bc], 1),
                                np.stack([ab, bc, ca], 1)])
    return pos, faces


def blob_mesh(seed: int = 0, subdiv: int = 6) -> MeshData:
    """The flagship stand-in: a closed icosphere (81,920 triangles at
    subdiv 6) radially displaced by seeded Gaussian bumps and ripples, so
    it has the bunny's mix of silhouettes, concavities and self-occlusion.
    Radius ~1; smooth vertex normals from the area-weighted face normals."""
    rng = np.random.default_rng(seed)
    pos, faces = _icosphere(subdiv)
    K = 24
    centers = rng.normal(size=(K, 3))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    amp = rng.uniform(-0.12, 0.25, K)
    width = rng.uniform(0.02, 0.2, K)
    freq = rng.normal(size=(3, 3)) * 4.0
    phase = rng.uniform(0.0, 2.0 * np.pi, 3)
    cos = pos @ centers.T                                  # [V, K]
    r = 1.0 + (amp * np.exp((cos - 1.0) / width)).sum(1)
    r += 0.04 * np.sin(pos @ freq.T + phase).sum(1)
    pos = pos * np.clip(r, 0.5, None)[:, None]
    tri = pos[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(pos)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-30)
    return _mesh(pos.astype(np.float32), faces.astype(np.int32),
                 vnormals=vn.astype(np.float32))


def checker_texture(size: int = 64, squares: int = 8,
                    colors=((230, 230, 230), (40, 90, 200))) -> np.ndarray:
    """[size, size, 3] uint8 checkerboard."""
    cell = (np.arange(size) * squares // size) % 2
    pick = (cell[:, None] + cell[None, :]) % 2
    return np.asarray(colors, np.uint8)[pick]


def leaf_texture(size: int = 64, seed: int = 0) -> np.ndarray:
    """[size, size, 3] uint8 seeded foliage: per-texel greens and browns."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, (size, size, 1))
    dark = np.array([30, 80, 25], np.float64)
    light = np.array([120, 190, 70], np.float64)
    img = dark + g * (light - dark)
    bark = rng.uniform(0.0, 1.0, (size, size)) < 0.08
    img[bark] = np.array([90, 60, 30])
    return img.astype(np.uint8)


def set_planar_texture(sm, key: str, name: str, img: np.ndarray,
                       axes=(0, 2)) -> None:
    """Give object ``key`` the texture ``img`` under ``name``, mapped by a
    planar projection of its vertices onto ``axes`` (baked to integer
    texel coordinates like the loader, Object.cpp:113-125)."""
    h, w = img.shape[:2]
    sm.textures.data[name] = img
    mesh = sm.get_triangles(key)
    p = mesh.verts[..., :3] / mesh.verts[..., 3:4]
    lo = p.reshape(-1, 3).min(0)
    span = np.maximum(p.reshape(-1, 3).max(0) - lo, 1e-20)
    u = np.floor((p[..., axes[0]] - lo[axes[0]]) / span[axes[0]]
                 * (w - 1))
    v = np.floor((p[..., axes[1]] - lo[axes[1]]) / span[axes[1]]
                 * (h - 1))
    mesh.uvs = np.stack([u, v], -1).astype(np.float32)
    mesh.textures = [name]
    mesh.tri_tex = np.zeros((mesh.num_triangles,), np.int32)
    mesh.tri_color = img[v[:, 0].astype(int),
                         u[:, 0].astype(int)].astype(np.float32) / 255.0


def place_flagship(sm, seed: int = 0, ground: bool = True) -> None:
    """The flagship frame's geometry: the blob (key "blob", ~4.3 units
    across, centred at z=60 in front of a focal-6000*H/1080 camera, the
    placement bench.py gave the bunny) over a green ground slab (key
    "ground") so the occlusion pass has a second object to shadow."""
    key = sm.add_mesh("blob", blob_mesh(seed))
    sm.set_color(key, (0.8, 0.7, 0.6))
    sm.transform_triangles(key, T.translate((0.0, 1.5, 60.0))
                           @ T.scale(4.3, 4.3, 4.3))
    if ground:
        g = sm.add_mesh("ground", cube_mesh())
        sm.set_color(g, (0.0, 1.0, 0.0))
        sm.transform_triangles(g, T.translate((0.0, 9.0, 60.0))
                               @ T.scale(30.0, 2.0, 30.0))
