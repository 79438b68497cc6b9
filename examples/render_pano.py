"""Minimal end-to-end render: synthetic SRTM tile -> panorama PNG.

Runs on JAX's default backend (set JAX_PLATFORMS=cpu to run it on the
CPU); with real `.hgt` tiles in
~/.horizonator/DEMs_SRTM3 drop the synthetic block and point `dir_dems`
at your data (or omit it). Usage:

    python examples/render_pano.py [out.png]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from horizonator_jax import horizonator
from horizonator_jax.dem import hgt


def synthetic_tile(path):
    """One 1-degree SRTM3 tile with a 2200 m Gaussian peak."""
    edge = hgt.SRTM3_EDGE
    lat = 35.0 - np.arange(edge) / (edge - 1)
    lon = -118.0 + np.arange(edge) / (edge - 1)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    z = 200 + 2200 * np.exp(-((la - 34.55) ** 2 + (lo + 117.45) ** 2)
                            / (2 * 0.03 ** 2))
    hgt.write_hgt(os.path.join(path, "N34W118.hgt"),
                  np.round(z).astype(np.int16))


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "pano.png"
    demdir = tempfile.mkdtemp(prefix="horizonator_demo_dems_")
    synthetic_tile(demdir)

    # ctor = slow path (DEM load + device upload + first compile);
    # render() = fast repeatable path with a movable camera
    h = horizonator(34.40, -117.45, 800, 300,
                    dir_dems=demdir, render_radius_m=25000.0)
    image, ranges = h.render(-40.0, 40.0, zfar=25000.0)

    from PIL import Image
    Image.fromarray(image[:, :, ::-1]).save(out)      # BGR -> RGB
    vis = ranges > 0
    print(f"wrote {out}: {vis.mean():.0%} terrain, "
          f"nearest {ranges[vis].min():.0f} m, "
          f"farthest {ranges[vis].max():.0f} m")


if __name__ == "__main__":
    main()
