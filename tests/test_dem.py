"""DEM layer tests: .hgt decode, mosaic assembly, reference semantics.

Oracles are the behaviors documented in SURVEY.md §2 from dem.c: big-endian
decode, sea-level clamp, NW-origin flip, 1-cell tile overlap, missing-tile
zeros, origin-cell math, radius_m conversion.
"""

import math

import numpy as np
import pytest

from horizonator_jax.dem import (SRTM3_EDGE, DemMosaic, cells_per_deg,
                                 hgt_filename, load_mosaic,
                                 radius_cells_from_m)
from horizonator_jax.dem import hgt


def test_hgt_filename_hemispheres():
    # dem.c:23-76 naming scheme
    assert hgt_filename(34, -118) == "N34W118.hgt"
    assert hgt_filename(34, 118) == "N34E118.hgt"
    assert hgt_filename(-34, -118) == "S34W118.hgt"
    assert hgt_filename(-1, 5) == "S01E005.hgt"
    assert hgt_filename(0, 0) == "N00E000.hgt"


def test_hgt_roundtrip_bigendian(tmp_path):
    edge = SRTM3_EDGE
    grid = np.arange(edge * edge, dtype=np.int16).reshape(edge, edge)
    p = tmp_path / "N10E020.hgt"
    hgt.write_hgt(p, grid)
    # On-disk bytes must be big-endian (dem.c:307)
    raw = p.read_bytes()
    assert raw[0] == 0 and raw[1] == 0 and raw[2] == 0 and raw[3] == 1
    back = hgt.read_hgt(p, srtm1=False)
    assert back is not None
    np.testing.assert_array_equal(np.asarray(back, dtype=np.int16), grid)


def test_hgt_missing_and_empty(tmp_path):
    assert hgt.read_hgt(tmp_path / "nope.hgt", srtm1=False) is None
    empty = tmp_path / "N00E000.hgt"
    empty.touch()
    assert hgt.read_hgt(empty, srtm1=False) is None
    bad = tmp_path / "N00E001.hgt"
    bad.write_bytes(b"\x00" * 100)
    with pytest.raises(ValueError):
        hgt.read_hgt(bad, srtm1=False)


def test_radius_cells_from_m():
    # dem.c:106-127: rcells = round(radius_m / (Rearth*pi/180*cos(lat)/cpd))
    cpd = cells_per_deg(False)
    got = radius_cells_from_m(40000.0, 34.3, cpd)
    cell_m = 6371000.0 * math.pi / 180 * math.cos(math.radians(34.3)) / cpd
    assert got == int(0.5 + 40000.0 / cell_m)
    assert 515 <= got <= 530   # ~522 per BASELINE.md


def test_mosaic_single_tile_flip_and_clamp(synthetic_dem_dir):
    edge = SRTM3_EDGE
    grid = np.zeros((edge, edge), np.int16)
    grid[0, 0] = 1000       # NW corner on disk
    grid[-1, -1] = 2000     # SE corner on disk
    grid[5, 5] = -30        # negative -> clamps to 0 (dem.c:308)
    d = synthetic_dem_dir({(34, -118): grid})
    m = load_mosaic(34.5, -117.5, render_radius_cells=100, datadir=d)
    assert m.grid.shape == (200, 200)
    assert m.grid.min() >= 0
    # Window around (34.5, -117.5): all inside tile N34W118; elevations 0
    # except the special corners which are outside this window.
    assert m.cells_per_deg == 1200
    assert m.origin_dem_lon_lat == (-118, 34)


def test_mosaic_origin_cell_math():
    # dem.c:136-159: icell_origin = floor(coord*cpd) - (R-1)
    # For viewer at exactly 34.5, -117.5, R=100:
    #   lon: floor(-117.5*1200) - 99 = -141000-99 = -141099
    #        origin_lon = -141099/1200 = -117.5825 -> tile -118, cell 0.4175*1200=501
    m = DemMosaic(grid=np.zeros((2, 2), np.int16), radius_cells=100,
                  cells_per_deg=1200, origin_dem_lon_lat=(-118, 34),
                  origin_dem_cellij=(501, 501))
    ci, cj = m.viewer_cell(34.5, -117.5)
    # viewer must sit between cell R-1 and R (dem.c:138-159 invariant)
    assert 99.0 <= ci <= 100.0
    assert 99.0 <= cj <= 100.0


def test_mosaic_multi_tile_seam(synthetic_dem_dir):
    """A window straddling 4 tiles: values must be continuous across the seam
    (tiles share their edge row/col, dem.c:161-171)."""
    edge = SRTM3_EDGE

    def f(lat, lon):
        # globally smooth function of lat/lon so seams are detectable
        return np.round(1000 + 500 * np.sin(lat * 3) + 400 * np.cos(lon * 2)
                        ).astype(np.int16)

    d = synthetic_dem_dir({(34, -118): f, (34, -117): f,
                           (35, -118): f, (35, -117): f})
    m = load_mosaic(35.0, -117.0, render_radius_cells=50, datadir=d)
    g = m.grid.astype(np.float32)
    # No seam discontinuities: neighboring cells differ by <= the function's
    # own smooth variation (a few meters per cell here)
    dj = np.abs(np.diff(g, axis=0)).max()
    di = np.abs(np.diff(g, axis=1)).max()
    assert dj < 5 and di < 5
    # And the values equal the function evaluated on the window's lat/lon grid
    lat0, lon0, lat1, lon1 = m.bounds_latlon_deg()
    lats = lat0 + np.arange(m.n) / m.cells_per_deg
    lons = lon0 + np.arange(m.n) / m.cells_per_deg
    expect = f(lats[:, None], lons[None, :]).astype(np.float32)
    np.testing.assert_allclose(g, expect, atol=0)


def test_mosaic_missing_tile_is_sea(synthetic_dem_dir, capsys):
    edge = SRTM3_EDGE
    grid = np.full((edge, edge), 500, np.int16)
    d = synthetic_dem_dir({(34, -118): grid})   # (34,-117) etc missing
    m = load_mosaic(35.0, -117.0, render_radius_cells=50, datadir=d)
    assert len(m.missing_tiles) > 0
    # cells from the present tile are 500; cells from missing tiles are 0
    assert m.grid.max() == 500
    assert m.grid.min() == 0


def test_sample_out_of_window():
    m = DemMosaic(grid=np.full((4, 4), 7, np.int16), radius_cells=2,
                  cells_per_deg=1200, origin_dem_lon_lat=(0, 0),
                  origin_dem_cellij=(0, 0))
    assert m.sample(-1, 0) == -1      # dem.c:270
    assert m.sample(0, -1) == -1
    assert m.sample(4, 0) == -1
    assert m.sample(3, 3) == 7


def test_auto_viewer_z():
    g = np.zeros((4, 4), np.int16)
    g[2, 2] = 120
    m = DemMosaic(grid=g, radius_cells=2, cells_per_deg=1200,
                  origin_dem_lon_lat=(0, 0), origin_dem_cellij=(0, 0))
    # viewer between cells (1..2, 1..2): max of 4 surrounding + 1
    # (horizonator-lib.c:775-789)
    lat = (1.5) / 1200
    lon = (1.5) / 1200
    assert m.auto_viewer_z(lat, lon) == 121.0


def test_bounds_latlon(synthetic_dem_dir):
    edge = SRTM3_EDGE
    d = synthetic_dem_dir({(34, -118): np.zeros((edge, edge), np.int16)})
    m = load_mosaic(34.5, -117.5, render_radius_cells=100, datadir=d)
    lat0, lon0, lat1, lon1 = m.bounds_latlon_deg()
    assert lat1 - lat0 == pytest.approx((2 * 100 - 1) / 1200)
    assert lon1 - lon0 == pytest.approx((2 * 100 - 1) / 1200)
    assert lat0 < 34.5 < lat1
    assert lon0 < -117.5 < lon1


class TestDemAutoDownload:
    """Auto-downloading missing .hgt tiles (the reference's unbuilt
    wish-list item, README.org 'Auto-downloading DEMs'): fetched tiles
    land in the cache dir and later loads never re-fetch."""

    @staticmethod
    def _serve(payloads):
        """Local HTTP server: path -> bytes; counts hits."""
        import threading
        from http.server import BaseHTTPRequestHandler, HTTPServer
        hits = []

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                hits.append(self.path)
                body = payloads.get(self.path)
                if body is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        srv = HTTPServer(("127.0.0.1", 0), H)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv, hits

    def _tile_bytes(self, fill):
        edge = hgt.SRTM3_EDGE
        grid = np.full((edge, edge), fill, np.int16)
        import io
        buf = io.BytesIO()
        # write_hgt writes big-endian rows, row 0 = north
        be = grid.astype(">i2")
        buf.write(be.tobytes())
        return buf.getvalue()

    @pytest.mark.parametrize("wrap", ["raw", "gz", "zip"])
    def test_fetch_unwrap_and_cache(self, tmp_path, wrap, capsys):
        import gzip
        import io
        import zipfile
        from horizonator_jax.dem.mosaic import load_mosaic

        raw = self._tile_bytes(321)
        if wrap == "gz":
            body = gzip.compress(raw)
            url_path = "/dem/N34W118.hgt.gz"
            fmt_suffix = ".gz"
        elif wrap == "zip":
            zb = io.BytesIO()
            with zipfile.ZipFile(zb, "w") as z:
                z.writestr("N34W118.hgt", raw)
            body = zb.getvalue()
            url_path = "/dem/N34W118.hgt.zip"
            fmt_suffix = ".zip"
        else:
            body = raw
            url_path = "/dem/N34W118.hgt"
            fmt_suffix = ""
        srv, hits = self._serve({url_path: body})
        port = srv.server_address[1]
        fmt = f"http://127.0.0.1:{port}/dem/{{name}}{fmt_suffix}"
        d = tmp_path / "dems"
        try:
            m = load_mosaic(34.4, -117.5, render_radius_cells=100,
                            datadir=str(d), dem_url_fmt=fmt)
            assert m.missing_tiles == []
            assert (m.grid == 321).all()
            assert (d / "N34W118.hgt").exists()
            n_after_first = len(hits)
            assert n_after_first >= 1
            # second load: cached, no refetch
            m2 = load_mosaic(34.4, -117.5, render_radius_cells=100,
                             datadir=str(d), dem_url_fmt=fmt)
            assert (m2.grid == 321).all()
            assert len(hits) == n_after_first
        finally:
            srv.shutdown()

    def test_fetch_multi_member_zip_picks_named_tile(self, tmp_path):
        """Region zips (viewfinderpanoramas style) hold many .hgt members;
        the fetch must extract the member for THIS tile, not namelist[0] --
        the wrong tile's elevations would be silently cached forever."""
        import io
        import zipfile
        from horizonator_jax.dem.mosaic import load_mosaic

        zb = io.BytesIO()
        with zipfile.ZipFile(zb, "w") as z:
            z.writestr("L11/N35W118.hgt", self._tile_bytes(999))  # decoy 1st
            z.writestr("L11/N34W118.hgt", self._tile_bytes(321))
            z.writestr("L11/N34W119.hgt", self._tile_bytes(555))
        srv, _hits = self._serve({"/dem/N34W118.hgt.zip": zb.getvalue()})
        port = srv.server_address[1]
        try:
            m = load_mosaic(34.4, -117.5, render_radius_cells=100,
                            datadir=str(tmp_path / "dems"),
                            dem_url_fmt=f"http://127.0.0.1:{port}"
                                        "/dem/{name}.zip")
            assert m.missing_tiles == []
            assert (m.grid == 321).all()
        finally:
            srv.shutdown()

    def test_fetch_multi_member_zip_without_match_fails_loudly(
            self, tmp_path, capsys):
        """A multi-member zip with NO member for the requested tile must
        degrade to sea+warning, never cache an arbitrary member."""
        import io
        import zipfile
        from horizonator_jax.dem.mosaic import load_mosaic

        zb = io.BytesIO()
        with zipfile.ZipFile(zb, "w") as z:
            z.writestr("N35W118.hgt", self._tile_bytes(999))
            z.writestr("N35W119.hgt", self._tile_bytes(888))
        srv, _hits = self._serve({"/dem/N34W118.hgt.zip": zb.getvalue()})
        port = srv.server_address[1]
        try:
            m = load_mosaic(34.4, -117.5, render_radius_cells=100,
                            datadir=str(tmp_path / "dems"),
                            dem_url_fmt=f"http://127.0.0.1:{port}"
                                        "/dem/{name}.zip")
            assert len(m.missing_tiles) == 1
            assert (m.grid == 0).all()
            assert "none named N34W118.hgt" in capsys.readouterr().err
        finally:
            srv.shutdown()

    def test_fetch_failure_degrades_to_sea(self, tmp_path, capsys):
        from horizonator_jax.dem.mosaic import load_mosaic
        srv, hits = self._serve({})   # 404 everything
        port = srv.server_address[1]
        try:
            m = load_mosaic(34.4, -117.5, render_radius_cells=100,
                            datadir=str(tmp_path / "dems"),
                            dem_url_fmt=f"http://127.0.0.1:{port}/x/%s")
            assert len(m.missing_tiles) == 1
            assert (m.grid == 0).all()
            err = capsys.readouterr().err
            assert "download failed" in err and "sea" in err
        finally:
            srv.shutdown()

    def test_api_srtm3_requires_url(self, tmp_path):
        from horizonator_jax import horizonator
        with pytest.raises(ValueError, match="dem_url_fmt"):
            horizonator(34.4, -117.5, 32, 16,
                        dir_dems=str(tmp_path / "dems"),
                        render_radius_cells=64, allow_dem_downloads=True)
