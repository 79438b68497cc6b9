"""GIS analysis ops: line of sight, viewshed raster, GeoTIFF export.

Writes a synthetic SRTM tile, then answers "can A see B?" for a batch of
point pairs, computes a full-circle viewshed raster around a summit, and
saves it as a georeferenced WGS84 GeoTIFF that QGIS/GDAL open directly.
Runs on JAX's default backend (set JAX_PLATFORMS=cpu for the CPU).
Usage:

    python examples/gis_analysis.py [viewshed.tif]
"""

import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from horizonator_jax import horizonator
from horizonator_jax.dem import hgt
from horizonator_jax.geotiff import write_geotiff
from horizonator_jax.ops import viewshed_grid
from horizonator_jax.render import RenderParams


def synthetic_tile(path):
    """One 1-degree SRTM3 tile: a 2400 m peak on a 200 m plain."""
    edge = hgt.SRTM3_EDGE
    lat = 35.0 - np.arange(edge) / (edge - 1)
    lon = -118.0 + np.arange(edge) / (edge - 1)
    LA, LO = np.meshgrid(lat, lon, indexing="ij")
    z = 200 + 2200 * np.exp(-((LA - 34.55) ** 2 + (LO + 117.45) ** 2)
                            / (2 * 0.03 ** 2))
    hgt.write_hgt(path, np.round(z).astype(np.int16))


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "viewshed.tif"
    dems = tempfile.mkdtemp(prefix="horizonator_demo_")
    synthetic_tile(os.path.join(dems, "N34W118.hgt"))

    h = horizonator(34.55, -117.45, 512, 192, dir_dems=dems,
                    render_radius_m=30000.0)

    # -- line of sight: one dispatch answers a whole batch of pairs --------
    # Observers on a ring around the peak; can each see the one opposite?
    ring = [(34.55 + 0.12 * math.cos(a), -117.45 + 0.12 * math.sin(a))
            for a in np.linspace(0, 2 * np.pi, 8, endpoint=False)]
    lats = np.array([p[0] for p in ring])
    lons = np.array([p[1] for p in ring])
    across = h.intervisible(lats, lons, np.roll(lats, 4), np.roll(lons, 4),
                            target_height_m=2.0)
    neighbor = h.intervisible(lats, lons, np.roll(lats, 1), np.roll(lons, 1),
                              target_height_m=2.0)
    print("across the peak (expect all blocked):", across.tolist())
    print("to the next ring point (expect all clear):", neighbor.tolist())

    # ... and the full clearance profile of one blocked sightline
    prof = h.sightline(ring[0][0], ring[0][1], ring[4][0], ring[4][1])
    print(f"worst obstruction at {float(prof.block_d) / 1000:.1f} km, "
          f"terrain peaks at {float(prof.z.max()):.0f} m, "
          f"visible={bool(prof.visible)}")

    # -- viewshed raster -> GeoTIFF ------------------------------------------
    # From a tower on the plain SW of the peak: the classic pattern —
    # everything visible up to the peak, a long occlusion shadow behind it.
    # (A viewer 1 m above the SUMMIT of a smooth dome sees almost nothing:
    # the convex near flank occludes the whole plain — try it.)
    import jax.numpy as jnp
    vlat, vlon = 34.43, -117.57
    ci, cj = h.mosaic.viewer_cell(vlat, vlon)
    hw = 256
    f = jnp.float32
    p = RenderParams(
        viewer_cell_i=f(ci), viewer_cell_j=f(cj),
        viewer_z=f(h.mosaic.auto_viewer_z(vlat, vlon) + 20.0),
        cos_viewer_lat=f(math.cos(math.radians(34.55))),
        az_rad0=f(-math.pi), az_rad1=f(math.pi),
        znear=f(100.0), zfar=f(25000.0),
        znear_color=f(100.0), zfar_color=f(25000.0))
    vis = np.asarray(viewshed_grid(
        jnp.asarray(h.mosaic.grid.astype(np.float32)), p, width=1024,
        nsteps=512, cells_per_deg=h.mosaic.cells_per_deg, out_halfwidth=hw))

    # the raster covers cells viewer +- hw; georeference its outer edges
    cpd = h.mosaic.cells_per_deg
    olon, olat = h.mosaic.origin_dem_lon_lat
    oi, oj = h.mosaic.origin_dem_cellij
    bounds = (olat + (oj + cj - hw) / cpd, olon + (oi + ci - hw) / cpd,
              olat + (oj + cj + hw) / cpd, olon + (oi + ci + hw) / cpd)
    write_geotiff(out, vis, bounds=bounds, row0="south")
    print(f"viewshed: {vis.mean():.1%} of {2 * hw}x{2 * hw} cells visible "
          f"-> {out} (WGS84 GeoTIFF, drag into QGIS)")


if __name__ == "__main__":
    main()
