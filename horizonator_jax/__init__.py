"""horizonator_jax: a JAX terrain-panorama rendering framework.

A from-scratch JAX/XLA rebuild of the capabilities of dkogan/horizonator
(SRTM terrain panoramas with range images, peak annotation, map texturing,
picking) for an accelerator: pure functions over device arrays, one jitted
render call, vmap/shard_map scale-out over viewpoints and azimuth wedges.
"""

from . import dem, geometry, render
from .api import horizonator, ZNEAR_DEFAULT, ZFAR_DEFAULT

__version__ = "0.1.0"
__all__ = ["dem", "geometry", "render", "horizonator",
           "ZNEAR_DEFAULT", "ZFAR_DEFAULT", "__version__"]
