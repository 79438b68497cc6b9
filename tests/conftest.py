"""Test harness config: run everything on a virtual 8-device CPU mesh.

The standard way to test sharding without a multi-card host (SURVEY.md
§4e). Must run before jax is imported anywhere. Tests that need the GPU
carry the ``gpu`` marker and skip here (see the ``gpu`` fixture).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax
# Persistent compilation cache across test runs/processes, HARDENED:
# atomic entry publishes (jax's unlocked put tears under the suite's
# concurrent CLI subprocesses or when a writer is killed mid-put) + zlib
# compression (see compile_cache.py). The CLI subprocess tests pass the
# same directory (compile_cache.cache_dir()) in their environment.
from horizonator_jax.compile_cache import use_persistent_cache
use_persistent_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(20260816)


def make_synthetic_dem_dir(tmp_path, tiles, srtm1=False):
    """Write synthetic .hgt tiles. ``tiles`` maps (tile_lat, tile_lon) ->
    either an (edge, edge) array (row 0 = NORTH) or a callable
    f(lat_deg_grid, lon_deg_grid) -> elevations."""
    from horizonator_jax.dem import hgt

    edge = hgt.SRTM1_EDGE if srtm1 else hgt.SRTM3_EDGE
    d = tmp_path / "dems"
    d.mkdir(exist_ok=True)
    for (tlat, tlon), spec in tiles.items():
        if callable(spec):
            lat = tlat + 1.0 - np.arange(edge) / (edge - 1)  # row 0 = north
            lon = tlon + np.arange(edge) / (edge - 1)
            grid = spec(lat[:, None], lon[None, :])
        else:
            grid = spec
        hgt.write_hgt(d / hgt.hgt_filename(tlat, tlon), grid)
    return str(d)


@pytest.fixture
def synthetic_dem_dir(tmp_path):
    def make(tiles, srtm1=False):
        return make_synthetic_dem_dir(tmp_path, tiles, srtm1)
    return make
