"""Configuration system for the raytracer.

The reference (leonlang/simple_raytracer) has no config system: every knob is a
hardcoded constant or a comment-toggled code block (see SURVEY.md §5).  This module
exposes each of those constants as a field, citing where the value lives in the
reference (`simple_raytracer.cpp` / `Object.cpp`), so renders can reproduce the
reference's behaviour exactly while remaining fully parameterisable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera at the view-space origin.

    Reference: primary ray dir = (i, j, focal) for i in [-W/2, W/2),
    j in [-H/2, H/2); directions NOT normalized (simple_raytracer.cpp:505-525).
    """

    width: int = 600            # simple_raytracer.cpp:773
    height: int = 400           # simple_raytracer.cpp:773
    focal: float = 400.0        # simple_raytracer.cpp:506
    normalize_dirs: bool = False  # reference never normalizes primary dirs


@dataclasses.dataclass(frozen=True)
class LightConfig:
    """Point light + soft-shadow sampling parameters."""

    position: Tuple[float, float, float] = (500.0, -300.0, -200.0)  # :776
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)             # :433
    # Number of jittered light samples; reference main() uses 1 (:445) but the
    # code comments call out "36 Shadows are a good value" (:444); the published
    # experiments used 8/16/32 (images/soft_shadows/).
    num_samples: int = 1
    # Cumulative per-sample jitter: +3.0 added to x, y, z in rotation (:372-382).
    jitter_step: float = 3.0
    # Shadowed samples are dimmed by /5, NOT zeroed (:369).
    shadow_dim: float = 5.0
    # Reference shadow rays have no max-t: occluders BEYOND the light still
    # cast shadow (simple_raytracer.cpp:321-342).  True reproduces that quirk.
    shadow_no_max_t: bool = True
    enable_shadows: bool = True   # :385-386 comment toggle


@dataclasses.dataclass(frozen=True)
class ShadingConfig:
    """Phong illumination + tone-mapping parameters (simple_raytracer.cpp:144-200,
    :389-398)."""

    # Diffuse uses abs(n.l): double-sided shading (:174-178).
    double_sided_diffuse: bool = True
    # The reference multiplies the specular term by an extra max(n.l, 0) factor
    # (after the abs fold) (:196).
    specular_nl_factor: bool = True
    # 1/pi scaling on diffuse and ambient (:153, :184).
    # Flat geometric normals are the active path; smooth vertex-normal
    # interpolation exists but is commented out (:162-164).
    smooth_normals: bool = False
    # Reinhard variant: c / (c + reinhard_offset); 0.5 active, 0.1/1.0/4.0
    # commented (:390-393).
    reinhard_offset: float = 0.5
    gamma: float = 1.1            # :396-398 (2.2 commented out)
    tonemap_enabled: bool = True
    # The reference quantizes shaded color with int(c*255) (truncation) (:447-449).
    quantize_truncate: bool = True


@dataclasses.dataclass(frozen=True)
class BVHConfig:
    """BVH build parameters (Object.cpp:225-284)."""

    leaf_size: int = 8            # triangleSizeStop, Object.cpp:261
    # 'median' reproduces the reference's sort-by-pointOne median split
    # (Object.cpp:240-255).  'sah' is the surface-area-heuristic improvement.
    split: str = "median"
    # Cull granularity of the tiled renderer: leaf triangles are reordered
    # contiguously and grouped into fixed-size blocks with AABBs; each ray
    # tile's plan lists the blocks (grouped into walk windows) its rays can
    # reach.
    block_size: int = 32


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Shape of the tiled path's walk kernels (kernels/walk.py), chosen on
    an H100 on the flagship frame (PERF.md: 16.8 ms/frame at 128/2/16/4,
    6.4 ms/frame at these values; 256-ray tiles and 2 warps spill)."""

    # Rays per kernel program (a power of two; it must divide the pixel
    # tile, tile_px**2).
    ray_tile: int = 128
    # Cull blocks per plan entry: one entry = one window of
    # window_blocks * block_size consecutive triangles.
    window_blocks: int = 4
    # Triangles per [ray_tile, chunk] block of Möller–Trumbore pairs
    # inside a window (bounds the kernel's live registers).
    chunk: int = 32
    num_warps: int = 16
    # Tests only: run the kernels in the Pallas interpreter on the CPU.
    interpret: bool = False


def _default_mode() -> str:
    """The fast path where it compiles (the Triton walk on a CUDA GPU),
    the jnp oracle elsewhere (the CPU runs the tests)."""
    import jax
    return "tiled" if jax.default_backend() == "gpu" else "bruteforce"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level render configuration."""

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    light: LightConfig = dataclasses.field(default_factory=LightConfig)
    shading: ShadingConfig = dataclasses.field(default_factory=ShadingConfig)
    bvh: BVHConfig = dataclasses.field(default_factory=BVHConfig)
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)

    # 'bruteforce' — all ray×triangle pairs (jnp oracle, differentiable)
    # 'bvh'        — stackless flattened-BVH traversal in jnp (lax.while_loop)
    # 'tiled'      — per-tile block culling + the Triton window walk
    # 'auto'       — resolved at construction: 'tiled' on a GPU, else
    #                'bruteforce'
    mode: str = "auto"

    # Pixel tile edge of the tiled path's ray order (tile = tile_px**2
    # rays, cut into kernel.ray_tile-ray walk tiles).  0 = 16.
    tile_px: int = 0

    # Tiled-path plan capacity: tiles with <= cull_maxv visible windows get
    # an exact front-to-back list (early break); heavier tiles walk the
    # covering contiguous window range (no early break).  0 = ranges only.
    cull_maxv: int = 248

    # Rays per lax.map chunk in the bvh/bruteforce paths.  Bounds the live
    # per-ray scratch: bruteforce holds [ray_chunk, T] f32 values per chunk
    # (131072 x 69k triangles would be 36 GB), so large scenes take a
    # smaller chunk.  0 = single chunk.
    ray_chunk: int = 131072

    # Background for pixels with no hit OR hits shading to exactly (0,0,0):
    # light blue 173,216,230 (simple_raytracer.cpp:476-487).
    background: Tuple[int, int, int] = (173, 216, 230)

    # Möller–Trumbore determinant epsilon (simple_raytracer.cpp:57).
    mt_eps: float = 1e-12

    def __post_init__(self):
        if self.mode == "auto":
            object.__setattr__(self, "mode", _default_mode())

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class AnimationConfig:
    """Turntable animation driver (simple_raytracer.cpp:530-551)."""

    start_deg: float = 0.0
    stop_deg: float = 360.0
    step_deg: float = 10.0         # 36 frames
    orbit_radius: float = 50.0     # :546
    camera_y: float = -50.0        # :551
    pitch_deg: float = 30.0        # :551
    yaw_offset_deg: float = 90.0   # :551 (angle + 90)


def default_config() -> RenderConfig:
    return RenderConfig()
