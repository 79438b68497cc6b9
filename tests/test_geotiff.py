"""GeoTIFF writer (geotiff.py): PIL round-trip + an independent IFD parse.

Two readers keep the writer honest: PIL decodes the pixels for uint8 and
float32, and a minimal struct-level IFD parser in this file checks the
raw layout (tags sorted, offsets aligned, geo tags correct) for every
dtype, including int16 which PIL does not reliably load.
"""

import struct

import numpy as np
import pytest

from horizonator_jax.geotiff import write_geotiff, cell_bounds

BOUNDS = (34.0, -118.0, 35.0, -117.0)   # lat_s, lon_w, lat_n, lon_e


def parse_tiff(path):
    """Tiny single-IFD TIFF parser: {tag: values}, plus the pixel bytes."""
    buf = open(path, "rb").read()
    order, magic, ifd = struct.unpack_from("<2sHI", buf, 0)
    assert order == b"II" and magic == 42
    (n,) = struct.unpack_from("<H", buf, ifd)
    tags = {}
    sizes = {1: 1, 2: 1, 3: 2, 4: 4, 12: 8}
    pats = {3: "H", 4: "I", 12: "d"}
    prev_tag = -1
    for k in range(n):
        tag, typ, count = struct.unpack_from("<HHI", buf, ifd + 2 + 12 * k)
        assert tag > prev_tag, "tags must be ascending"
        prev_tag = tag
        size = sizes[typ] * count
        voff = ifd + 2 + 12 * k + 8
        if size > 4:
            (voff,) = struct.unpack_from("<I", buf, voff)
            assert voff % 2 == 0, "payloads must be word-aligned"
        if typ == 2:
            tags[tag] = buf[voff:voff + count]
        else:
            tags[tag] = struct.unpack_from(f"<{count}{pats[typ]}", buf, voff)
    (nxt,) = struct.unpack_from("<I", buf, ifd + 2 + 12 * n)
    assert nxt == 0
    off, cnt = tags[273][0], tags[279][0]
    return tags, buf[off:off + cnt]


@pytest.mark.parametrize("dtype,fmt", [(np.uint8, 1), (np.uint16, 1),
                                       (np.int16, 2), (np.float32, 3)])
def test_layout_and_pixels_every_dtype(dtype, fmt, rng):
    a = rng.uniform(-100, 3000, (37, 53))
    if np.dtype(dtype) == np.uint8:
        a = np.clip(a, 0, 255)
    if np.dtype(dtype) == np.uint16:
        a = np.clip(a, 0, 65535)
    a = a.astype(dtype)
    path = "/tmp/t_geotiff_%s.tif" % np.dtype(dtype).name
    write_geotiff(path, a, bounds=BOUNDS, row0="south", nodata=-1)
    tags, pix = parse_tiff(path)
    assert tags[256] == (53,) and tags[257] == (37,)
    assert tags[339] == (fmt,)
    assert tags[259] == (1,)                       # uncompressed
    got = np.frombuffer(pix, dtype=np.dtype(dtype).newbyteorder("<"))
    np.testing.assert_array_equal(got.reshape(37, 53), a[::-1])  # north-up
    # geo tags: pixel scale + NW-corner tiepoint + EPSG:4326 geokeys
    sx, sy, _ = tags[33550]
    assert abs(sx - 1.0 / 53) < 1e-12 and abs(sy - 1.0 / 37) < 1e-12
    assert tags[33922][3:5] == (-118.0, 35.0)
    gk = tags[34735]
    keys = {gk[i]: gk[i + 3] for i in range(4, len(gk), 4)}
    assert keys[1024] == 2 and keys[1025] == 1 and keys[2048] == 4326
    assert tags[42113].rstrip(b"\x00") == b"-1"


def test_pil_roundtrip_uint8_and_float32(rng):
    from PIL import Image
    vis = rng.uniform(0, 1, (64, 80)) > 0.5       # a viewshed-style raster
    write_geotiff("/tmp/t_geotiff_vis.tif", vis, bounds=BOUNDS)
    im = Image.open("/tmp/t_geotiff_vis.tif")
    np.testing.assert_array_equal(np.asarray(im), vis[::-1].astype(np.uint8))
    assert tuple(im.tag_v2[33550])[:2] == (1.0 / 80, 1.0 / 64)

    sun = rng.uniform(0, 14, (40, 40)).astype(np.float32)  # sun-hours style
    write_geotiff("/tmp/t_geotiff_sun.tif", sun, bounds=BOUNDS, row0="north")
    im = Image.open("/tmp/t_geotiff_sun.tif")
    np.testing.assert_array_equal(np.asarray(im), sun)     # no flip


def test_input_validation():
    with pytest.raises(ValueError, match="2D"):
        write_geotiff("/tmp/t_bad.tif", np.zeros((4, 4, 3), np.uint8),
                      bounds=BOUNDS)
    with pytest.raises(ValueError, match="dtype"):
        write_geotiff("/tmp/t_bad.tif", np.zeros((4, 4), np.float64),
                      bounds=BOUNDS)
    with pytest.raises(ValueError, match="degenerate"):
        write_geotiff("/tmp/t_bad.tif", np.zeros((4, 4), np.uint8),
                      bounds=(35.0, -118.0, 34.0, -117.0))
    with pytest.raises(ValueError, match="row0"):
        write_geotiff("/tmp/t_bad.tif", np.zeros((4, 4), np.uint8),
                      bounds=BOUNDS, row0="west")


def test_cell_bounds_matches_mosaic(tmp_path):
    from tests.conftest import make_synthetic_dem_dir
    from horizonator_jax.dem import load_mosaic

    d = make_synthetic_dem_dir(tmp_path,
                               {(34, -118): lambda la, lo: 0 * (la + lo)})
    m = load_mosaic(34.5, -117.5, render_radius_m=20000.0, datadir=d)
    lat0, lon0, lat1, lon1 = m.bounds_latlon_deg()   # cell CENTERS, inclusive
    half = 0.5 / m.cells_per_deg
    got = cell_bounds(m)
    np.testing.assert_allclose(
        got, (lat0 - half, lon0 - half, lat1 + half, lon1 + half),
        rtol=0, atol=1e-9)
    # a sub-window: single cell (i, j) = (3, 7) spans exactly one cell
    s = cell_bounds(m, lo=(3, 7), hi=(3, 7))
    np.testing.assert_allclose(s[2] - s[0], 1.0 / m.cells_per_deg, atol=1e-12)
    np.testing.assert_allclose(s[3] - s[1], 1.0 / m.cells_per_deg, atol=1e-12)
    # its center is where viewer_cell says cell (3, 7) sits
    ci, cj = m.viewer_cell((s[0] + s[2]) / 2, (s[1] + s[3]) / 2)
    np.testing.assert_allclose([ci, cj], [3.0, 7.0], atol=1e-6)


def test_cli_viewshed(tmp_path):
    """--viewshed FILE.tif: the CLI's GIS raster path, georeferencing
    checked against the viewer position."""
    from tests.conftest import make_synthetic_dem_dir
    from horizonator_jax import cli

    def terrain(lat, lon):
        return 200 + 1800 * np.exp(-((lat - 34.47) ** 2 + (lon + 117.45) ** 2)
                                   / (2 * 0.015 ** 2))

    d = make_synthetic_dem_dir(tmp_path, {(34, -118): terrain})
    out = str(tmp_path / "vs.tif")
    rc = cli.main(["--viewshed", out, "--viewshed-halfwidth", "48",
                   "--viewshed-sampler", "step", "--nsteps", "256",
                   "--dirdems", d, "--zfar", "8000",
                   "34.40", "-117.45", "0", "180"])
    assert rc == 0
    tags, pix = parse_tiff(out)
    assert tags[256] == (96,) and tags[257] == (96,)
    vis = np.frombuffer(pix, np.uint8).reshape(96, 96)
    # open plain mostly visible; the 2000 m peak 0.07 deg north casts an
    # occlusion shadow behind it (rows beyond the peak in the north-up file
    # are the TOP rows)
    assert 0.3 < vis.mean() < 0.995
    assert vis[48:].mean() > vis[:20].mean()   # south half clearer than far north
    # tiepoint = NW corner = viewer + hw cells in each direction
    lon_w, lat_n = tags[33922][3:5]
    assert abs(lon_w - (-117.45 - 48 / 1200)) < 2 / 1200
    assert abs(lat_n - (34.40 + 48 / 1200)) < 2 / 1200


def test_viewshed_to_geotiff_end_to_end(rng):
    """The intended pipeline: viewshed_grid raster -> GeoTIFF on disk."""
    import math
    import jax.numpy as jnp
    from PIL import Image
    from horizonator_jax.ops import viewshed_grid
    from horizonator_jax.render import RenderParams

    n = 192
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    z = (200 + 120 * np.sin(ii / 9.0) * np.cos(jj / 13.0)).astype(np.float32)
    f = jnp.float32
    p = RenderParams(viewer_cell_i=f(96.0), viewer_cell_j=f(96.0),
                     viewer_z=f(400.0),
                     cos_viewer_lat=f(math.cos(math.radians(34.5))),
                     az_rad0=f(-math.pi), az_rad1=f(math.pi),
                     znear=f(60.0), zfar=f(8000.0),
                     znear_color=f(60.0), zfar_color=f(8000.0))
    hw = 64
    vis = np.asarray(viewshed_grid(jnp.asarray(z), p, width=256, nsteps=256,
                                   cells_per_deg=1200, out_halfwidth=hw))
    # the raster covers cells viewer +- hw: row r / col c centers at grid
    # (vj + r - hw + 0.5, vi + c - hw + 0.5), so the outer edges run from
    # viewer - hw to viewer + hw. Fake a 1-deg tile at (34, -118) whose
    # cell (0, 0) is the SW corner.
    cpd = 1200
    vi, vj = 96.0, 96.0
    b = (34.0 + (vj - hw) / cpd, -118.0 + (vi - hw) / cpd,
         34.0 + (vj + hw) / cpd, -118.0 + (vi + hw) / cpd)
    write_geotiff("/tmp/t_geotiff_vshed.tif", vis, bounds=b)
    back = np.asarray(Image.open("/tmp/t_geotiff_vshed.tif"))
    np.testing.assert_array_equal(back, vis[::-1].astype(np.uint8))
    assert 0.05 < back.mean() < 1.0
