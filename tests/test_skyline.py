"""Geolocated skyline (api.skyline + geojson exports + CLI --horizon-out).

Oracle: a gaussian ridge wall due north of the viewer with analytically
known crest distance/height; the apparent-elevation maximum along the ray
is computed numerically from the same analytic profile.
"""

import json
import math
import subprocess
import sys

import numpy as np
import pytest

from horizonator_jax.compile_cache import cache_dir

from horizonator_jax import horizonator
from horizonator_jax import geojson as gj

from conftest import make_synthetic_dem_dir

M_PER_DEG = 6371000.0 * math.pi / 180.0      # geometry.en_to_latlon's scale
WALL_LAT = 34.75                             # crest latitude
WALL_SIG_DEG = 0.004                         # gaussian sigma (~445 m)
WALL_H = 1000.0
VLAT, VLON = 34.5, -117.5
D_CREST = (WALL_LAT - VLAT) * M_PER_DEG      # ~27.8 km due north

_CLI_ENV = {"PATH": "/usr/bin:/bin", "HOME": "/root",
            "JAX_PLATFORMS": "cpu",
            "JAX_COMPILATION_CACHE_DIR": cache_dir()}


def _wall(lat, lon):
    z = WALL_H * np.exp(-((lat - WALL_LAT) / WALL_SIG_DEG) ** 2 / 2.0)
    return np.broadcast_to(z, np.broadcast_shapes(lat.shape, lon.shape))


@pytest.fixture(scope="module")
def dem_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("skyline")
    return make_synthetic_dem_dir(d, {(34, -118): _wall})


@pytest.fixture(scope="module")
def h(dem_dir):
    return horizonator(VLAT, VLON, 96, 48, dir_dems=dem_dir,
                       render_radius_m=35000.0)


def _oracle_max_el(viewer_z):
    """Numerical max of atan((z(d) - vz)/d) along the due-north ray."""
    d = np.linspace(1000.0, 35000.0, 200001)
    z = WALL_H * np.exp(-((d - D_CREST) / (WALL_SIG_DEG * M_PER_DEG)) ** 2
                        / 2.0)
    el = np.arctan((z - viewer_z) / d)
    k = int(np.argmax(el))
    return math.degrees(el[k]), d[k]


def test_skyline_geolocates_the_ridge(h):
    sky = h.skyline(-20.0, 20.0, width=81)
    c = int(np.argmin(np.abs(sky["az_deg"])))          # the az ~ 0 column
    el_ref, d_ref = _oracle_max_el(h.viewer_z)
    assert abs(sky["el_deg"][c] - el_ref) < 0.1
    assert abs(sky["dist_m"][c] - d_ref) < 400.0       # ~4 cells
    # geolocation consistent with the tangent-plane mapping (due north:
    # lat advances by d / M_PER_DEG, lon stays)
    assert abs(sky["lat"][c] - (VLAT + sky["dist_m"][c] / M_PER_DEG)) < 1e-3
    assert abs(sky["lon"][c] - VLON) < 1e-3
    # the wall spans the whole tile: every column's horizon is near its
    # crest, so distances grow away from az 0 as D/cos(az)
    expect = D_CREST / np.cos(np.radians(sky["az_deg"]))
    assert np.all(np.abs(sky["dist_m"] - expect) < 1500.0)


def test_skyline_matches_horizon_elevations(h):
    az, tan_el = h.horizon(-20.0, 20.0, width=81)
    sky = h.skyline(-20.0, 20.0, width=81)
    np.testing.assert_allclose(sky["el_deg"],
                               np.degrees(np.arctan(tan_el)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(sky["az_deg"], np.degrees(az),
                               atol=1e-5, rtol=0)


def test_skyline_sampler_crosscheck(dem_dir, h):
    hc = horizonator(VLAT, VLON, 96, 48, dir_dems=dem_dir,
                     render_radius_m=35000.0, sampler="crossing")
    a = h.skyline(-15.0, 15.0, width=33)
    b = hc.skyline(-15.0, 15.0, width=33)
    np.testing.assert_allclose(a["el_deg"], b["el_deg"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(a["dist_m"], b["dist_m"], atol=1.0, rtol=0)
    np.testing.assert_allclose(a["lat"], b["lat"], atol=1e-5, rtol=0)


def test_skyline_step_sampler_budget(dem_dir):
    """skyline() always marches CROSSINGS, so its step budget must be
    k_cross_for's column-dominant count even on the step/lod samplers:
    the uniform-step budget ((zfar-znear)/cell_north * oversample) runs
    out before zfar once oversample < 1/cos(lat), and the old code
    silently truncated the distant skyline (the ridge at 27.8 km vanished
    while horizon() still saw it)."""
    hh = horizonator(VLAT, VLON, 96, 48, dir_dems=dem_dir,
                     render_radius_m=35000.0, sampler="step", oversample=0.5)
    sky = hh.skyline(-10.0, 10.0, width=33, zfar=35000.0)
    el_deg, d_el = _oracle_max_el(hh.viewer_z)
    assert abs(sky["el_deg"].max() - el_deg) < 0.05
    assert abs(sky["dist_m"][np.argmax(sky["el_deg"])] - d_el) < 600.0
    # and horizon() (uniform steps, which DO reach zfar) agrees
    _, tan_el = hh.horizon(-10.0, 10.0, width=33, zfar=35000.0)
    assert abs(np.degrees(np.arctan(tan_el)).max() - el_deg) < 0.05


def test_geojson_and_csv_roundtrip(h, tmp_path):
    sky = h.skyline(-10.0, 10.0, width=17)
    p = tmp_path / "sky.geojson"
    doc = json.loads(gj.skyline_geojson(sky, p, properties={"viewer_lat": VLAT}))
    assert p.exists() and json.loads(p.read_text()) == doc
    (feat,) = doc["features"]
    assert feat["geometry"]["type"] == "LineString"
    coords = feat["geometry"]["coordinates"]
    assert len(coords) == 17
    lon0, lat0 = coords[0]
    assert abs(lat0 - sky["lat"][0]) < 1e-6 and abs(lon0 - sky["lon"][0]) < 1e-6
    assert feat["properties"]["viewer_lat"] == VLAT
    assert len(feat["properties"]["el_deg"]) == 17

    csv = gj.skyline_csv(sky, tmp_path / "sky.csv")
    lines = csv.strip().split("\n")
    assert lines[0] == "az_deg,el_deg,dist_m,lat,lon"
    assert len(lines) == 18
    row = dict(zip(lines[0].split(","), map(float, lines[9].split(","))))
    assert abs(row["dist_m"] - sky["dist_m"][8]) < 0.1


def test_line_geojson_batched(tmp_path):
    lat = np.array([[34.0, 34.1], [34.2, 34.3]])
    lon = np.array([[-118.0, -118.1], [-118.2, -118.3]])
    doc = json.loads(gj.line_geojson(lat, lon, tmp_path / "l.geojson",
                                     properties=[{"a": 1}, {"a": 2}]))
    assert [f["properties"]["a"] for f in doc["features"]] == [1, 2]
    assert doc["features"][1]["geometry"]["coordinates"][0] == [-118.2, 34.2]
    with pytest.raises(ValueError):
        gj.line_geojson(lat, lon[:1])


_POIS = [
    {"name": "crest", "lat": WALL_LAT, "lon": VLON, "ele_m": 1000.0},
    {"name": "behind", "lat": 34.85, "lon": VLON, "ele_m": 0.0},
    {"name": "front", "lat": 34.60, "lon": VLON, "ele_m": 0.0},
    {"name": "outside", "lat": 36.5, "lon": VLON, "ele_m": 0.0},
]


def test_visible_peaks(h):
    peaks = h.visible_peaks(_POIS)
    by = {p["name"]: p for p in peaks}
    assert [p["name"] for p in peaks] == [p["name"] for p in _POIS]
    assert by["crest"]["visible"] and by["front"]["visible"]
    assert not by["behind"]["visible"]      # occluded by the 1000 m wall
    assert not by["outside"]["visible"]     # beyond the loaded mosaic
    assert abs(by["crest"]["az_deg"]) < 1e-6
    assert abs(by["crest"]["dist_m"] - D_CREST) < 1.0
    # viewing geometry follows the render convention (viewer_z, tan el law)
    el_ref = math.degrees(math.atan((1000.0 - h.viewer_z) / D_CREST))
    assert abs(by["crest"]["el_deg"] - el_ref) < 1e-6
    assert by["front"]["el_deg"] < 0.0      # ground below the viewer
    assert h.visible_peaks([]) == []


def test_cli_horizon_out(dem_dir, tmp_path):
    out = tmp_path / "horizon.geojson"
    pois_in = tmp_path / "pois.json"
    pois_in.write_text(json.dumps(_POIS))
    pois_out = tmp_path / "peaks.geojson"
    r = subprocess.run(
        [sys.executable, "-m", "horizonator_jax.cli",
         "--dirdems", dem_dir, "--width", "33", "--zfar", "35000",
         "--horizon-out", str(out), "--pois", str(pois_in),
         "--pois-out", str(pois_out), str(VLAT), str(VLON), "0", "15"],
        capture_output=True, text=True, timeout=600, env=_CLI_ENV)
    assert r.returncode == 0, r.stderr
    pdoc = json.loads(pois_out.read_text())
    props = {f["properties"]["name"]: f["properties"]
             for f in pdoc["features"]}
    assert len(pdoc["features"]) == 4
    assert props["crest"]["visible"] and not props["behind"]["visible"]
    assert abs(props["crest"]["dist_m"] - D_CREST) < 1.0
    assert pdoc["features"][0]["geometry"]["coordinates"][1] == WALL_LAT
    doc = json.loads(out.read_text())
    (feat,) = doc["features"]
    assert len(feat["geometry"]["coordinates"]) == 33
    assert feat["properties"]["viewer_lat"] == pytest.approx(VLAT)
    # the ridge is visible due north: max elevation is positive and the
    # distances are near the crest
    el = np.array(feat["properties"]["el_deg"])
    dm = np.array(feat["properties"]["dist_m"])
    assert el.max() > 1.0
    assert abs(dm[np.argmax(el)] - D_CREST) < 2000.0


def test_cli_viewshed_composes_with_horizon_out(dem_dir, tmp_path):
    """--viewshed + --horizon-out without --image must write BOTH outputs:
    the r3 CLI returned right after the viewshed and silently skipped the
    requested vector products."""
    tif = tmp_path / "vis.tif"
    out = tmp_path / "horizon.geojson"
    r = subprocess.run(
        [sys.executable, "-m", "horizonator_jax.cli",
         "--dirdems", dem_dir, "--width", "33", "--zfar", "8000",
         "--viewshed", str(tif), "--viewshed-halfwidth", "24",
         "--horizon-out", str(out), str(VLAT), str(VLON), "0", "15"],
        capture_output=True, text=True, timeout=600, env=_CLI_ENV)
    assert r.returncode == 0, r.stderr
    assert tif.exists() and tif.stat().st_size > 0
    doc = json.loads(out.read_text())
    assert len(doc["features"][0]["geometry"]["coordinates"]) == 33
