from . import tiled, walk

__all__ = ["tiled", "walk"]
