"""Multi-device sharding demo through the public API.

Uses every visible device: the cards of a multi-GPU host, or a virtual CPU
mesh when run as

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/multichip_sweep.py

Shows the two public multi-device entry points:

- `render_batch(mesh=...)`: viewpoint-batch x azimuth-wedge sharding;
- `viewshed_sweep(mesh=...)`: many-viewpoint horizon sweeps.

Usage:  python examples/multichip_sweep.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile

import numpy as np
import jax

from jax.sharding import Mesh

from horizonator_jax import horizonator
from horizonator_jax.dem import hgt
from horizonator_jax.ops import viewshed_sweep


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
    print(f"devices: {len(jax.devices())} x {jax.devices()[0].platform}")
    demdir = tempfile.mkdtemp(prefix="horizonator_demo_dems_")
    synthetic_tile(demdir)

    h = horizonator(34.40, -117.45, 256, 96,
                    dir_dems=demdir, render_radius_m=15000.0)

    # 8 viewpoints sharded over every device: an azimuth-wedge axis of 2
    # when the device count is even, the rest on the batch axis
    n_dev = len(jax.devices())
    n_az = 2 if n_dev % 2 == 0 else 1
    mesh = Mesh(np.array(jax.devices()).reshape(n_dev // n_az, n_az),
                ("batch", "az"))
    lats = list(np.linspace(34.38, 34.52, 8))
    lons = [-117.45] * 8
    imgs, ranges = h.render_batch(-180.0, 180.0, lats, lons,
                                  zfar=15000.0, mesh=mesh)
    print(f"sharded render_batch: {imgs.shape} images, "
          f"{(ranges > 0).mean():.0%} terrain")

    # 64-viewpoint full-circle horizon sweep on the same mesh ("batch"
    # axis shards each dispatch). Viewpoints are DEM cell coordinates.
    grid = np.linspace(34.40, 34.50, 8)
    glats, glons = np.meshgrid(grid, -117.50 + (grid - 34.40))
    cells = np.stack([h.mosaic.viewer_cell(la, lo)
                      for la, lo in zip(glats.ravel(), glons.ravel())])
    tan_el = viewshed_sweep(h.mosaic.grid.astype(np.float32), cells,
                            width=128, zfar=15000.0,
                            cells_per_deg=h.mosaic.cells_per_deg,
                            sampler="window", lat_deg=34.45,  # sets cos too
                            batch=64, mesh=mesh)
    print(f"viewshed_sweep: tan_el {tan_el.shape}, "
          f"median horizon elevation "
          f"{np.degrees(np.arctan(float(np.median(tan_el)))):.2f} deg")


if __name__ == "__main__":
    main()
