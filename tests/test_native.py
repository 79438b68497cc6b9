"""Native C++ DEM loader: build, parity with the numpy path, speed sanity."""

import os
import time

import numpy as np
import pytest

from horizonator_jax import _native
from horizonator_jax.dem import hgt, load_mosaic


@pytest.fixture(scope="module")
def lib():
    lib = _native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_native_decode_matches_numpy(tmp_path, lib):
    edge = hgt.SRTM3_EDGE
    rng = np.random.default_rng(3)
    grid = rng.integers(-500, 4000, (edge, edge), dtype=np.int16)
    p = tmp_path / "N10E020.hgt"
    hgt.write_hgt(p, grid)

    out = np.zeros((edge, edge), np.int16)
    rc = lib.hgt_decode(str(p).encode(), edge,
                        out.ctypes.data_as(__import__("ctypes").c_void_p))
    assert rc == 0
    np.testing.assert_array_equal(out, grid)


def test_mosaic_native_vs_numpy_paths(tmp_path, monkeypatch):
    if _native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    edge = hgt.SRTM3_EDGE

    def f(lat, lon):
        return np.round(800 + 600 * np.sin(lat * 5) * np.cos(lon * 3)
                        - 400 * np.sin(lon * 7)).astype(np.int16)

    d = tmp_path / "dems"
    for t in [(34, -118), (34, -117), (35, -118), (35, -117)]:
        lat = t[0] + 1.0 - np.arange(edge) / (edge - 1)
        lon = t[1] + np.arange(edge) / (edge - 1)
        hgt.write_hgt(d / hgt.hgt_filename(*t),
                      f(lat[:, None], lon[None, :]))

    m_native = load_mosaic(35.0, -117.0, render_radius_cells=300,
                           datadir=str(d))
    monkeypatch.setenv("HORIZONATOR_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_tried", False)
    monkeypatch.setattr(_native, "_lib", None)
    m_numpy = load_mosaic(35.0, -117.0, render_radius_cells=300,
                          datadir=str(d))
    np.testing.assert_array_equal(m_native.grid, m_numpy.grid)
    assert m_native.origin_dem_lon_lat == m_numpy.origin_dem_lon_lat
    assert m_native.origin_dem_cellij == m_numpy.origin_dem_cellij


def test_native_missing_and_empty(tmp_path):
    if _native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    # empty file -> silent sea; missing -> warning path handled in python
    d = tmp_path / "dems"
    d.mkdir()
    (d / "N34W118.hgt").touch()
    m = load_mosaic(34.5, -117.5, render_radius_cells=100, datadir=str(d))
    assert m.grid.max() == 0
    assert len(m.missing_tiles) == 0   # empty file is not "missing"


def test_native_open_failure_distinct_from_empty(tmp_path):
    # rc=4 (open failure) vs rc=1 (zero-size): a dangling symlink passes
    # neither the exists() check nor open(); calling the blit directly must
    # report the distinct open-failure code, not "empty -> silent sea".
    if _native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    edge = hgt.SRTM3_EDGE
    grid = np.zeros((64, 64), np.int16)
    dangling = tmp_path / "N34W118.hgt"
    dangling.symlink_to(tmp_path / "nonexistent-target.hgt")
    rc = _native.blit_window(dangling, edge, grid, 0, 0)
    assert rc == 4
    empty = tmp_path / "N34W117.hgt"
    empty.touch()
    assert _native.blit_window(empty, edge, grid, 0, 0) == 1


def test_mosaic_unreadable_tile_warns_as_sea(tmp_path, monkeypatch, capsys):
    # An existing-but-unreadable tile (rc=4 from the native blit) must WARN
    # and render as sea, like the reference's couldn't-open path
    # (dem.c:199-208) -- not silently like a zero-size file.
    if _native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    d = tmp_path / "dems"
    d.mkdir()
    (d / "N34W118.hgt").touch()   # exists() passes

    real = _native.blit_window
    monkeypatch.setattr(_native, "blit_window",
                        lambda *a, **k: 4)
    try:
        m = load_mosaic(34.5, -117.5, render_radius_cells=100, datadir=str(d))
    finally:
        monkeypatch.setattr(_native, "blit_window", real)
    assert m.grid.max() == 0
    assert len(m.missing_tiles) == 1
    assert "couldn't open DEM file" in capsys.readouterr().err


def test_native_negative_clamp(tmp_path):
    if _native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    edge = hgt.SRTM3_EDGE
    grid = np.full((edge, edge), -100, np.int16)   # Death Valley everywhere
    d = tmp_path / "dems"
    hgt.write_hgt(d / "N34W118.hgt", grid)
    m = load_mosaic(34.5, -117.5, render_radius_cells=50, datadir=str(d))
    assert m.grid.min() == 0 and m.grid.max() == 0
