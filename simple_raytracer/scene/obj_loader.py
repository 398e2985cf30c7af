"""Pure-Python OBJ/MTL/texture loader with reference-equivalent semantics.

Replaces the reference's vendored tinyobjloader + stb_image path
(Object.cpp:25-170).  Behavioural parity points:

* default object color red (1,0,0) and material (ambient 0.2, specular 0.5,
  shininess 15)  — Object.cpp:29-34
* missing OBJ/MTL/texture => warning + empty mesh / default material, never an
  exception — Object.cpp:35-39, :63-65
* UVs are baked to INTEGER texel coordinates at load time with a V flip and a
  positive modulo wrap:  u = floor(tx*W) % W,  v = floor((1-ty)*H) % H
  — Object.cpp:113-119
* per-triangle diffuse color sampled from the texture at vertex 0's texel
  — Object.cpp:121-125, :147
* vertices stored homogeneous (x, y, z, 1) — Object.cpp:82
* texture decoding forced to 3 channels (RGB) — Object.cpp:57

Output is SoA numpy (not AoS Triangle objects): the natural layout for
device arrays.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_COLOR = (1.0, 0.0, 0.0)          # Object.cpp:29
DEFAULT_AMBIENT = 0.2                    # Object.cpp:31
DEFAULT_SPECULAR = 0.5                   # Object.cpp:32
DEFAULT_SHININESS = 15.0                 # Object.cpp:33


@dataclasses.dataclass
class MeshData:
    """SoA triangle soup for one OBJ file (reference: vector<Triangle>)."""

    verts: np.ndarray        # [T, 3, 4] f32 homogeneous (Object.h:17-19)
    normals: np.ndarray      # [T, 3, 3] f32 vertex normals (0 if absent)
    uvs: np.ndarray          # [T, 3, 2] f32 baked texel coords (Object.h:23-25)
    tri_color: np.ndarray    # [T, 3] f32 per-tri color sampled at vertex 0
    tri_tex: np.ndarray      # [T] i32 texture id into `textures`, -1 = none
    textures: List[str]      # texture names (raw diffuse_texname strings)

    @property
    def num_triangles(self) -> int:
        return int(self.verts.shape[0])

    def copy(self) -> "MeshData":
        return MeshData(self.verts.copy(), self.normals.copy(), self.uvs.copy(),
                        self.tri_color.copy(), self.tri_tex.copy(), list(self.textures))


def _parse_index(tok: str, count: int) -> Tuple[int, int, int]:
    """Parse an OBJ face vertex token 'v', 'v/t', 'v//n', 'v/t/n'.

    Returns 0-based (vertex, texcoord, normal); -1 where absent.  Handles
    negative (relative) indices per the OBJ spec.
    """
    parts = tok.split("/")
    out = []
    counts = count
    for k in range(3):
        if k < len(parts) and parts[k]:
            i = int(parts[k])
            out.append(i - 1 if i > 0 else counts[k] + i)
        else:
            out.append(-1)
    return out[0], out[1], out[2]


def load_texture(path: str) -> Optional[np.ndarray]:
    """Decode an image to RGB uint8 [H, W, 3] (stbi_load with 3 forced channels,
    Object.cpp:57).  Returns None on failure (Object.cpp:63-65)."""
    try:
        from PIL import Image
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except Exception as e:  # missing file, bad format — mirror stb's soft failure
        print(f"Failed to load texture: {path} ({e})", file=sys.stderr)
        return None


def _parse_mtl(path: str) -> Dict[str, Dict[str, str]]:
    """Minimal MTL parser: material name -> {'map_Kd': texname, ...}."""
    materials: Dict[str, Dict[str, str]] = {}
    cur: Optional[str] = None
    try:
        with open(path, "r", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                toks = line.split(None, 1)
                key = toks[0]
                rest = toks[1].strip() if len(toks) > 1 else ""
                if key == "newmtl":
                    cur = rest
                    materials[cur] = {}
                elif cur is not None:
                    materials[cur][key] = rest
    except OSError as e:
        # tinyobjloader: "Material file not found ... Use default material"
        print(f"Material file [{os.path.basename(path)}] not found: {e}. "
              f"Use default material.", file=sys.stderr)
    return materials


class TextureRegistry:
    """Loaded textures keyed by their raw diffuse_texname string
    (reference: ObjectManager::textureData / textureDimensions, Object.h:70-71)."""

    def __init__(self, root: str = "."):
        self.root = root
        self.data: Dict[str, np.ndarray] = {}

    def load(self, texname: str, obj_dir: str) -> bool:
        if texname in self.data:
            return True
        # reference resolves relative to process CWD (stbi_load on the raw
        # string, Object.cpp:57); also try relative to the OBJ's directory.
        for cand in (texname,
                     os.path.join(self.root, texname),
                     os.path.join(obj_dir, texname),
                     os.path.join(obj_dir, os.path.basename(texname))):
            if os.path.isfile(cand):
                img = load_texture(cand)
                if img is not None:
                    self.data[texname] = img
                    return True
        print(f"Failed to load texture: {texname}", file=sys.stderr)
        return False

    def get(self, texname: str) -> Optional[np.ndarray]:
        return self.data.get(texname)


def _scan_mtllibs(path: str, obj_dir: str) -> Dict[str, Dict[str, str]]:
    """Collect materials from every mtllib line (cheap single pass)."""
    materials: Dict[str, Dict[str, str]] = {}
    try:
        with open(path, "r", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line.startswith("mtllib"):
                    mtl_path = os.path.join(obj_dir,
                                            line.split(None, 1)[1].strip())
                    materials.update(_parse_mtl(mtl_path))
    except OSError:
        pass
    return materials


def _parse_obj_python(path: str):
    """Pure-Python OBJ core parse; same output contract as
    native.api.obj_parse_native."""
    positions: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    faces: List[Tuple[int, ...]] = []
    face_mtl: List[int] = []
    usemtl: List[str] = []
    cur_mtl = -1
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            tag = toks[0]

            def num(i):
                # pad missing components with 0.0 — the same soft-failure
                # contract as the native parser (native.cpp::obj_parse), so a
                # malformed file loads identically with SRT_NO_NATIVE=1
                return float(toks[i]) if i < len(toks) else 0.0

            if tag == "v":
                positions.append((num(1), num(2), num(3)))
            elif tag == "vt":
                texcoords.append((num(1), num(2)))
            elif tag == "vn":
                normals.append((num(1), num(2), num(3)))
            elif tag == "f":
                counts = (len(positions), len(texcoords), len(normals))
                idxs = [_parse_index(t, counts) for t in toks[1:]]
                # fan triangulation (tinyobjloader triangulates by default;
                # for the convex quads in these assets a fan is equivalent)
                for k in range(1, len(idxs) - 1):
                    faces.append(idxs[0] + idxs[k] + idxs[k + 1])
                    face_mtl.append(cur_mtl)
            elif tag == "usemtl" and len(toks) > 1:
                usemtl.append(toks[1])
                cur_mtl = len(usemtl) - 1

    def arr(a, shape, dtype=np.float32):
        return np.asarray(a, dtype) if a else np.zeros(shape, dtype)

    return (arr(positions, (0, 3)), arr(texcoords, (0, 2)),
            arr(normals, (0, 3)),
            arr(faces, (0, 9), np.int32).reshape(-1, 3, 3),
            arr(face_mtl, (0,), np.int32), usemtl)


def load_obj(path: str, textures: Optional[TextureRegistry] = None,
             root: Optional[str] = None) -> MeshData:
    """Load an OBJ file into SoA arrays with reference-equivalent semantics
    (Object.cpp:25-170).  Missing file => empty mesh + stderr message.

    The line scan runs in the native C++ parser when available
    (native/native.cpp::obj_parse); assembly is vectorized numpy either way.
    """
    if root is None:
        root = os.path.dirname(path) or "."
    if textures is None:
        textures = TextureRegistry(root=root)
    obj_dir = os.path.dirname(path) or "."

    if not os.path.isfile(path):
        print(f"ObjReader: Cannot open file [{path}]", file=sys.stderr)
        return _empty_mesh()

    parsed = None
    if not os.environ.get("SRT_NO_NATIVE"):
        from ..native import obj_parse_native
        parsed = obj_parse_native(path)
    if parsed is None:
        parsed = _parse_obj_python(path)
    pos_a, uv_a, nrm_a, faces, face_mtl, usemtl = parsed
    materials = _scan_mtllibs(path, obj_dir)

    # Pre-load diffuse textures (Object.cpp:52-68)
    tex_names: List[str] = []
    tex_ids: Dict[str, int] = {}
    for mname, props in materials.items():
        texname = props.get("map_Kd", "")
        if texname and texname not in tex_ids:
            if textures.load(texname, obj_dir):
                tex_ids[texname] = len(tex_names)
                tex_names.append(texname)

    T = int(faces.shape[0])
    verts = np.zeros((T, 3, 4), dtype=np.float32)
    verts[..., 3] = 1.0
    vnorm = np.zeros((T, 3, 3), dtype=np.float32)
    uvs = np.zeros((T, 3, 2), dtype=np.float32)
    tri_color = np.ones((T, 3), dtype=np.float32)   # default white (Object.cpp:84)
    tri_tex = np.full((T,), -1, dtype=np.int32)
    if T == 0:
        return MeshData(verts, vnorm, uvs, tri_color, tri_tex, tex_names)

    vi = faces[:, :, 0]                               # [T, 3]
    verts[..., :3] = pos_a[vi]
    ni = faces[:, :, 2]
    has_n = ni >= 0
    if nrm_a.shape[0]:
        vnorm = np.where(has_n[..., None], nrm_a[np.maximum(ni, 0)], 0.0)
    vnorm = vnorm.astype(np.float32)

    # per-face texture: usemtl occurrence -> material -> map_Kd
    occ_tex = np.full((max(len(usemtl), 1),), -1, np.int32)
    for k, mname in enumerate(usemtl):
        texname = materials.get(mname, {}).get("map_Kd", "")
        occ_tex[k] = tex_ids.get(texname, -1) if texname else -1
    face_tex = np.where(face_mtl >= 0, occ_tex[np.maximum(face_mtl, 0)], -1)

    ti = faces[:, :, 1]
    for gid, texname in enumerate(tex_names):
        img = textures.get(texname)
        th, tw = img.shape[0], img.shape[1]
        fmask = face_tex == gid                       # [T]
        cmask = fmask[:, None] & (ti >= 0)            # [T, 3]
        if not cmask.any():
            continue
        tx = uv_a[np.maximum(ti, 0), 0]
        ty = uv_a[np.maximum(ti, 0), 1]
        # UV bake: floor + positive modulo + V flip (Object.cpp:113-119)
        u = np.floor(tx * tw).astype(np.int64) % tw
        vv = np.floor((1.0 - ty) * th).astype(np.int64) % th
        uvs[..., 0] = np.where(cmask, u, uvs[..., 0])
        uvs[..., 1] = np.where(cmask, vv, uvs[..., 1])
        # per-triangle color sampled at vertex 0 (Object.cpp:121-125, :147)
        v0 = cmask[:, 0]
        tri_color[v0] = img[vv[v0, 0], u[v0, 0]].astype(np.float32) / 255.0
        tri_tex[v0] = gid
    return MeshData(verts, vnorm, uvs, tri_color, tri_tex, tex_names)


def _empty_mesh() -> MeshData:
    return MeshData(
        verts=np.zeros((0, 3, 4), np.float32),
        normals=np.zeros((0, 3, 3), np.float32),
        uvs=np.zeros((0, 3, 2), np.float32),
        tri_color=np.ones((0, 3), np.float32),
        tri_tex=np.zeros((0,), np.int32),
        textures=[],
    )
