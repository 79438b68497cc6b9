from .raymarch import (RenderParams, render_panorama, horizon_profile,
                       march_tanel)
from .texture import AtlasParams, sample_atlas_bgr, tile_xy_from_latlon
from .crossing import (CrossingScene, pack_scene, march_crossing,
                       horizon_crossing, k_cross_for)
from .window import march_window
from .lod import build_pyramid, lod_plan, march_lod, LevelSpec
from .mesh import render_mesh

__all__ = [
    "RenderParams", "render_panorama", "horizon_profile", "march_tanel",
    "AtlasParams", "sample_atlas_bgr", "tile_xy_from_latlon",
    "CrossingScene", "pack_scene", "march_crossing", "horizon_crossing",
    "k_cross_for", "march_window",
    "build_pyramid", "lod_plan", "march_lod", "LevelSpec", "render_mesh",
]
