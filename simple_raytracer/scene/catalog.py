"""Scene catalog: the reference's driver scenes and the flagship, generated.

The reference selects scenes by commenting code blocks in `main()` in or out
(simple_raytracer.cpp:553-769).  Each builder here reproduces one block's
layout, colors, materials and camera (constants cited) over the generated
stand-ins of scene/generated.py (no asset files), plus two scenes of this
repository: ``flagship`` (the 81,920-triangle blob over a ground slab, the
frame the benchmark and chip check render) and ``textured`` (a
checker-textured ground under a cube and a sphere).

``bake_view`` picks between the reference's strategy (multiply
inverse(viewMatrix) into all geometry + light per frame —
simple_raytracer.cpp:558,778 — forcing per-frame host rebuilds) and the
world-space strategy (geometry static, camera rays transformed per frame via
ops/camera.primary_rays_world; the BVH is built ONCE for the whole sweep).

Builders take (angle_deg=0.0, bake_view=True) and return (scene_manager,
view_matrix [4,4] np or None, light [3] np).  In bake mode the returned
light is already view-space and view_matrix is None; in world mode pass the
view matrix to render(..., view_matrix=V).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import generated as G
from . import transforms as T
from .scene import SceneManager

LIGHT_WORLD = np.array([500.0, -300.0, -200.0], np.float32)   # :776


def _rad(deg: float) -> float:
    return float(np.radians(deg))


def orbit_view(angle_deg: float, radius: float, y: float, pitch_deg: float,
               yaw_offset_deg: float = 90.0) -> np.ndarray:
    """Turntable camera (simple_raytracer.cpp:546-551): position on a circle
    of ``radius`` at height ``y``, rotation (pitch, angle+yaw_offset, 0)."""
    rad = _rad(angle_deg)
    pos = (radius * np.cos(rad), y, radius * np.sin(rad))
    return T.view_matrix(pos, (_rad(pitch_deg), _rad(angle_deg + yaw_offset_deg), 0.0))


def _finalize(sm: SceneManager, view: Optional[np.ndarray], bake_view: bool,
              transform_light: bool = True):
    """Apply the inverse-view bake (reference mode) or return the view for
    ray-space transformation (world mode)."""
    if view is None:
        return sm, None, LIGHT_WORLD.copy()
    if bake_view:
        inv = np.linalg.inv(view).astype(np.float32)
        for key in list(sm.objects.keys()):
            sm.transform_triangles(key, inv)
        if transform_light:
            light_h = inv @ np.array([*LIGHT_WORLD, 1.0], np.float32)  # :778
            return sm, None, light_h[:3]
        return sm, None, LIGHT_WORLD.copy()
    return sm, view, LIGHT_WORLD.copy()


def complex_scene(angle_deg: float = 0.0, bake_view: bool = True):
    """The ACTIVE scene (simple_raytracer.cpp:553-618): green ground cube,
    white bunny, 3 oak trees; camera orbit r=50, y=-50, pitch 30.  The
    bunny is the flagship blob at the bunny's place and size; each tree is
    a textured canopy sphere on a brown trunk.  (The reference's two cats
    load from a file it never committed, so they render as nothing there
    too.)"""
    sm = SceneManager()
    view = orbit_view(angle_deg, radius=50.0, y=-50.0, pitch_deg=30.0)

    cube = sm.add_mesh("ground", G.cube_mesh())
    sm.set_color(cube, (0.0, 1.0, 0.0))                              # :564
    sm.transform_triangles(cube, T.scale(35.0, 35.0, 35.0))          # :565
    sm.transform_triangles(cube, T.translate((0.0, 10.0, 0.0)))      # :566

    bunny = sm.add_mesh("bunny", G.blob_mesh(seed=0))
    sm.set_color(bunny, (0.9, 0.9, 0.9))                             # :591
    sm.transform_triangles(bunny, T.translate((25.0, -28.5, 0.0))
                           @ T.scale(3.9, 3.9, 3.9))                 # :592-596

    trunk = sm.add_mesh("trunk0", G.cube_mesh())
    sm.set_color(trunk, (0.45, 0.3, 0.15))
    sm.transform_triangles(trunk, T.translate((0.0, -2.5, 0.0))
                           @ T.scale(0.8, 2.5, 0.8))
    tree = sm.add_mesh("tree0", G.uv_sphere_mesh())
    sm.set_properties(tree, specular=0.0)                            # :602
    sm.transform_triangles(tree, T.translate((0.0, -12.0, 0.0))
                           @ T.scale(9.0, 8.0, 9.0))
    G.set_planar_texture(sm, tree, "leaves", G.leaf_texture(), axes=(0, 1))
    for k, pos in ((0, (-6.0, -25.0, -25.0)), (1, (-6.0, -25.0, 0.0)),
                   (2, (-6.0, -25.0, 25.0))):                        # :609-622
        if k:
            sm.instance("trunk0", f"trunk{k}", copy_color=True)
            sm.instance("tree0", f"tree{k}")                         # :604-607
        for key in (f"trunk{k}", f"tree{k}"):
            sm.transform_triangles(key, T.translate(pos))
    return _finalize(sm, view, bake_view)


def six_spheres(angle_deg: float = 0.0, bake_view: bool = True):
    """Commented scene 1 (simple_raytracer.cpp:622-673): 6 spheres, STATIC
    camera at the origin (no view matrix, light untransformed)."""
    sm = SceneManager()
    s0 = sm.add_mesh("sphere0", G.uv_sphere_mesh())
    sm.transform_triangles(s0, T.translate((0.0, 6.0, 30.0))
                           @ T.scale(2.5, 2.5, 2.5))                 # :640
    offsets = [(6.0, 0.0, 0.0), (-6.0, 0.0, 0.0), (0.0, -12.0, 0.0),
               (6.0, -12.0, 0.0), (-6.0, -12.0, 0.0)]                # :645-665
    for k, off in enumerate(offsets):
        key = sm.instance(s0, f"sphere{k + 1}")
        sm.set_color(key, (1.0, 0.0, 0.0))                           # :645
        sm.transform_triangles(key, T.translate(off))
    return _finalize(sm, None, bake_view)


def one_cube(angle_deg: float = 0.0, bake_view: bool = True):
    """Commented scene 3 (simple_raytracer.cpp:703-722): default-red cube at
    20x rotated 25 deg; camera orbit r=100, y=0, pitch 0."""
    sm = SceneManager()
    view = orbit_view(angle_deg, radius=100.0, y=0.0, pitch_deg=0.0)
    cube = sm.add_mesh("cube", G.cube_mesh())
    sm.transform_triangles(cube, T.scale(20.0, 20.0, 20.0))          # :715
    sm.transform_triangles(cube, T.rotate_y(_rad(25.0)))             # :716
    return _finalize(sm, view, bake_view)


def four_cubes(angle_deg: float = 0.0, bake_view: bool = True):
    """Commented scene 4 (simple_raytracer.cpp:726-769): 4 colored cubes;
    camera orbit r=100, y=0, pitch 0."""
    sm = SceneManager()
    view = orbit_view(angle_deg, radius=100.0, y=0.0, pitch_deg=0.0)
    c0 = sm.add_mesh("cube0", G.cube_mesh())
    sm.set_color(c0, (1.0, 1.0, 0.0))                                # :738
    sm.transform_triangles(c0, T.scale(10.0, 10.0, 10.0))            # :739
    placements = [((1.0, 0.0, 1.0), (0.0, -15.0, -15.0)),            # :742-744
                  ((1.0, 0.0, 0.0), (0.0, -15.0, 15.0)),             # :746-748
                  ((0.0, 1.0, 0.0), (0.0, 15.0, 15.0))]              # :750-752
    for k, (color, pos) in enumerate(placements):
        key = sm.instance(c0, f"cube{k + 1}")
        sm.set_color(key, color)
        sm.transform_triangles(key, T.translate(pos))
    sm.transform_triangles(c0, T.translate((0.0, 15.0, -15.0)))      # :755
    return _finalize(sm, view, bake_view)


# The flagship camera: 11.6 units in front of the blob, so that with
# focal = image height the blob spans ~3/4 of the frame's height.
FLAGSHIP_VIEW = T.translate((0.0, 0.0, 48.4))


def flagship(angle_deg: float = 0.0, bake_view: bool = True):
    """The flagship frame: the seeded 81,920-triangle blob over a green
    ground slab (scene/generated.py:place_flagship), seen from
    FLAGSHIP_VIEW; render it with focal = height (e.g. 1920x1080, focal
    1080).  ``angle_deg`` is ignored: the camera is fixed."""
    sm = SceneManager()
    G.place_flagship(sm)
    return _finalize(sm, FLAGSHIP_VIEW, bake_view)


def textured(angle_deg: float = 0.0, bake_view: bool = True):
    """A checker-textured ground slab under a red cube and a yellow sphere,
    seen like the flagship (focal = height): the texture path's scene."""
    sm = SceneManager()
    g = sm.add_mesh("ground", G.cube_mesh())
    sm.transform_triangles(g, T.translate((0.0, 6.0, 60.0))
                           @ T.scale(12.0, 1.0, 12.0))
    G.set_planar_texture(sm, g, "checker", G.checker_texture())
    c = sm.add_mesh("cube", G.cube_mesh())
    sm.transform_triangles(c, T.translate((-2.5, 3.0, 60.0))
                           @ T.rotate_y(_rad(30.0)) @ T.scale(2.0, 2.0, 2.0))
    s = sm.add_mesh("sphere", G.uv_sphere_mesh())
    sm.set_color(s, (0.9, 0.8, 0.2))
    sm.transform_triangles(s, T.translate((3.0, 2.5, 58.0))
                           @ T.scale(2.5, 2.5, 2.5))
    return _finalize(sm, FLAGSHIP_VIEW, bake_view)


CATALOG = {
    "complex": complex_scene,
    "six_spheres": six_spheres,
    "one_cube": one_cube,
    "four_cubes": four_cubes,
    "flagship": flagship,
    "textured": textured,
}
