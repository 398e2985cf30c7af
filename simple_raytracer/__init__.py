"""simple_raytracer — a differentiable raytracer in JAX.

A from-scratch framework with the capabilities of leonlang/simple_raytracer
(see SURVEY.md), redesigned for accelerators: SoA scene pytrees, flattened stackless
BVHs, per-tile culled Möller–Trumbore walks (a Pallas kernel on GPUs), shard_map
pixel-tile data parallelism, and full differentiability down to vertices,
materials, lights, and textures.
"""

from .config import (AnimationConfig, BVHConfig, CameraConfig, LightConfig,
                     RenderConfig, ShadingConfig, default_config)
from .scene.scene import Scene, SceneManager
from .render.renderer import render, render_radiance

__version__ = "0.1.0"

__all__ = [
    "AnimationConfig", "BVHConfig", "CameraConfig", "LightConfig",
    "RenderConfig", "ShadingConfig", "default_config",
    "Scene", "SceneManager", "render", "render_radiance",
]
