"""Hillshade rendering + batched viewpoints in one dispatch.

Demonstrates two beyond-reference features on a synthetic scene:
sun-shaded terrain computed from the DEM itself (no tile downloads) and
`render_batch` — many camera positions rendered by a single compiled
dispatch. Usage:

    python examples/hillshade_and_batch.py [out_prefix]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from horizonator_jax import horizonator
from horizonator_jax.dem import hgt


def synthetic_tile(path):
    edge = hgt.SRTM3_EDGE
    lat = 35.0 - np.arange(edge) / (edge - 1)
    lon = -118.0 + np.arange(edge) / (edge - 1)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    z = 200 + 2200 * np.exp(-((la - 34.55) ** 2 + (lo + 117.45) ** 2)
                            / (2 * 0.03 ** 2))
    hgt.write_hgt(os.path.join(path, "N34W118.hgt"),
                  np.round(z).astype(np.int16))


def main():
    prefix = sys.argv[1] if len(sys.argv) > 1 else "shaded"
    demdir = tempfile.mkdtemp(prefix="horizonator_demo_dems_")
    synthetic_tile(demdir)

    # (sun_time="2026-08-18T15:00" would place the sun astronomically)
    h = horizonator(34.40, -117.45, 600, 220,
                    dir_dems=demdir, render_radius_m=25000.0,
                    hillshade=True, sun_az_deg=120.0, sun_alt_deg=35.0)
    image, _ = h.render(-40.0, 40.0, zfar=25000.0)
    from PIL import Image
    Image.fromarray(image[:, :, ::-1]).save(f"{prefix}.png")
    print(f"wrote {prefix}.png (hillshade, sun az 120 alt 35)")

    # cast shadows: same scene, low sun -- terrain west of the peak falls
    # in its shadow (shadows=True multiplies the hillshade's direct term
    # by ops.shadows.shadow_light; ambient keeps relief visible)
    hs = horizonator(34.40, -117.45, 600, 220,
                     dir_dems=demdir, render_radius_m=25000.0,
                     hillshade=True, shadows=True,
                     sun_az_deg=90.0, sun_alt_deg=10.0)
    image, _ = hs.render(-40.0, 40.0, zfar=25000.0)
    Image.fromarray(image[:, :, ::-1]).save(f"{prefix}_shadows.png")
    print(f"wrote {prefix}_shadows.png (cast shadows, sun az 90 alt 10)")

    # insolation raster: hours of direct sun per DEM cell over one day
    from horizonator_jax.ops import sun_hours
    hours = np.asarray(sun_hours(
        h.mosaic.grid, cells_per_deg=h.mosaic.cells_per_deg,
        lat_deg=34.55, lon_deg=-117.45, date="2026-12-21", samples=12))
    Image.fromarray(np.uint8(np.clip(hours / hours.max(), 0, 1) * 255)
                    ).save(f"{prefix}_sunhours.png")
    print(f"wrote {prefix}_sunhours.png (winter-solstice sun hours, "
          f"max {hours.max():.1f} h)")

    # a 4-viewpoint walk toward the peak, ONE dispatch
    lats = [34.40, 34.43, 34.46, 34.49]
    lons = [-117.45] * 4
    imgs, ranges = h.render_batch(-40.0, 40.0, lats, lons, zfar=25000.0)
    for i, im in enumerate(imgs):
        Image.fromarray(np.asarray(im)[:, :, ::-1]).save(f"{prefix}_{i}.png")
    print(f"wrote {prefix}_0..{len(imgs)-1}.png "
          f"(batched: {imgs.shape[0]} viewpoints, one dispatch)")


if __name__ == "__main__":
    main()
