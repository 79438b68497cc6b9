"""API tests: the reference-compatible horizonator class + CLI."""

import json
import subprocess
import sys

import numpy as np
import pytest

from horizonator_jax.compile_cache import cache_dir

_CLI_ENV = {"PATH": "/usr/bin:/bin", "HOME": "/root",
            "JAX_PLATFORMS": "cpu",
            "JAX_COMPILATION_CACHE_DIR": cache_dir()}

from horizonator_jax import horizonator
from horizonator_jax.dem import hgt


@pytest.fixture(scope="module")
def dem_dir(tmp_path_factory):
    """One synthetic tile with a couple of peaks."""
    d = tmp_path_factory.mktemp("dems")
    edge = hgt.SRTM3_EDGE
    lat = 35.0 - np.arange(edge) / (edge - 1)
    lon = -118.0 + np.arange(edge) / (edge - 1)
    LA, LO = np.meshgrid(lat, lon, indexing="ij")
    z = 200 + 0 * LA
    for plat, plon, hgt_m, s in [(34.55, -117.45, 2200, 0.03),
                                 (34.48, -117.38, 2800, 0.015)]:
        z = z + hgt_m * np.exp(-((LA - plat) ** 2 + (LO - plon) ** 2) / (2 * s * s))
    hgt.write_hgt(d / "N34W118.hgt", np.round(z).astype(np.int16))
    return str(d)


@pytest.fixture(scope="module")
def h(dem_dir):
    return horizonator(34.40, -117.45, 400, 150,
                       dir_dems=dem_dir, render_radius_m=25000.0, nsteps=1024)


def test_ctor_and_str(h):
    assert str(h) == "Looking out from 34.4000,-117.4500"
    assert h.viewer_z > 200.0   # auto-z on the 200 m plain + 1


def test_render_shapes_and_tuple_semantics(h):
    image, ranges = h.render(-60, 60)
    assert image.shape == (150, 400, 3) and image.dtype == np.uint8
    assert ranges.shape == (150, 400) and ranges.dtype == np.float32
    only_img = h.render(-60, 60, return_range=False)
    assert isinstance(only_img, np.ndarray) and only_img.ndim == 3
    only_rng = h.render(-60, 60, return_image=False)
    assert only_rng.ndim == 2
    nothing = h.render(-60, 60, return_image=False, return_range=False)
    assert nothing == ()


def test_render_sees_the_peaks(h):
    image, ranges = h.render(-60, 60)
    # some terrain visible, some sky
    assert 0.05 < (ranges > 0).mean() < 0.95
    # sky is blue in BGR
    sky = ranges < 0
    assert (image[sky][:, 0] == 255).all()


def test_camera_move_changes_view(h):
    _, r0 = h.render(-60, 60)
    _, r1 = h.render(-60, 60, lat=34.55, lon=-117.45)   # on the peak
    assert not np.array_equal(r0, r1)
    assert h.viewer_lat == 34.55
    # moving back restores
    _, r2 = h.render(-60, 60, lat=34.40, lon=-117.45)
    np.testing.assert_array_equal(r0, r2)


def test_pixel_center_extents(h):
    """az_extents_use_pixel_centers widens the window by half a pixel each
    side (horizonator-pywrap.c:204-212): the centered render's first column
    must look at exactly az_deg0."""
    img_edge, _ = h.render(-30, 30)
    img_ctr, _ = h.render(-30, 30, az_extents_use_pixel_centers=True)
    assert not np.array_equal(img_edge, img_ctr)


def test_explicit_elevation(h):
    _, r_low = h.render(-60, 60, lat=34.40, lon=-117.45)
    _, r_high = h.render(-60, 60, ele_m=3000.0)
    assert h.viewer_z == 3000.0
    # From 3000 m the nearby peaks no longer rise above the horizon: the
    # highest terrain pixel sits lower in the image than at ground level.
    top_low = np.nonzero((r_low > 0).any(axis=1))[0][0]
    top_high = np.nonzero((r_high > 0).any(axis=1))[0][0]
    assert top_high > top_low
    h.render(-60, 60, lat=34.40, lon=-117.45)   # reset auto z


def test_pick_roundtrip(h):
    """pick() must return a lat/lon whose re-projection lands on the picked
    pixel (the reference's pick-vs-project consistency, never tested there)."""
    image, ranges = h.render(-60, 60)
    ys, xs = np.nonzero(ranges > 0)
    k = len(ys) // 2
    x, y = int(xs[k]), int(ys[k])
    out = h.pick(x, y)
    assert out is not None
    plat, plon = out
    lat0, lon0, lat1, lon1 = h.mosaic.bounds_latlon_deg()
    assert lat0 <= plat <= lat1 and lon0 <= plon <= lon1
    # sky pick -> None
    sy, sx = np.nonzero(ranges < 0)
    assert h.pick(int(sx[0]), int(sy[0])) is None


def test_horizon_profile_api(h):
    az, tan_el = h.horizon(-60, 60, width=256)
    assert az.shape == (256,) and tan_el.shape == (256,)
    assert np.isfinite(tan_el).all()


def test_default_radius_cells(dem_dir):
    """Default render radius is 1000 cells (horizonator-pywrap.c:65)."""
    hh = horizonator(34.40, -117.45, 64, 32, dir_dems=dem_dir, nsteps=256)
    assert hh.mosaic.radius_cells == 1000


def test_both_radii_error(dem_dir):
    with pytest.raises(ValueError):
        horizonator(34.4, -117.45, 64, 32, dir_dems=dem_dir,
                    render_radius_cells=10, render_radius_m=1000.0)


def test_cli_png(dem_dir, tmp_path):
    out = tmp_path / "pano.png"
    r = subprocess.run(
        [sys.executable, "-m", "horizonator_jax.cli",
         "--width", "300", "--height", "100",
         "--image", str(out), "--dirdems", dem_dir,
         "--zfar", "25000", "--nsteps", "512",
         "34.40", "-117.45", "0", "60"],
        capture_output=True, text=True, cwd="/root/repo",
        env=_CLI_ENV)
    assert r.returncode == 0, r.stderr
    from PIL import Image
    im = Image.open(out)
    assert im.size == (300, 100)


def test_cli_full_circle_radius_180(dem_dir, tmp_path):
    """AZ_RADIUS_DEG=180 must render a full 360-deg panorama: the
    pixel-center widening (standalone.c:400-404) used to push the span past
    360 deg, which az_window_rad rewraps into a half-pixel-wide window
    facing az_center+180 -- a flat backwards sliver instead of the circle
    (the reference degenerates the same way; a 360 panorama is first-class
    here, so the CLI clamps the widened span at exactly 360)."""
    out = tmp_path / "full.png"
    r = subprocess.run(
        [sys.executable, "-m", "horizonator_jax.cli",
         "--width", "400", "--height", "120",
         "--image", str(out), "--dirdems", dem_dir,
         "--zfar", "25000", "--nsteps", "512",
         "34.40", "-117.45", "0", "180"],
        capture_output=True, text=True, cwd="/root/repo", env=_CLI_ENV)
    assert r.returncode == 0, r.stderr
    from PIL import Image
    img = np.asarray(Image.open(out))
    sky = (img[:, :, 2] > 200) & (img[:, :, 0] < 50)     # RGB file order
    horizon = sky.sum(axis=0)
    # the two Gaussian peaks sit NNE/ENE of the viewer: the horizon must
    # rise there (not the flat backwards sliver the rewrap produced)
    assert horizon.max() - horizon.min() > 10
    # full circle: the seam columns are neighbors on the circle
    assert abs(int(horizon[0]) - int(horizon[-1])) <= 2


def test_cli_svg_annotated(dem_dir, tmp_path):
    pois = [{"name": "Big Peak", "lat": 34.48, "lon": -117.38, "ele_m": 3000},
            {"name": "Round Top", "lat": 34.55, "lon": -117.45, "ele_m": 2400}]
    pf = tmp_path / "pois.json"
    pf.write_text(json.dumps(pois))
    out = tmp_path / "pano.svg"
    r = subprocess.run(
        [sys.executable, "-m", "horizonator_jax.cli",
         "--width", "400", "--height", "150",
         "--image", str(out), "--dirdems", dem_dir, "--pois", str(pf),
         "--zfar", "25000", "--nsteps", "512",
         "34.40", "-117.45", "30", "40"],
        capture_output=True, text=True, cwd="/root/repo",
        env=_CLI_ENV)
    assert r.returncode == 0, r.stderr
    svg = out.read_text()
    assert "caltopo.com" in svg
    assert "Big Peak" in svg
    assert "deg</text>" in svg   # bearing ticks


def test_cli_arg_validation(dem_dir):
    env = _CLI_ENV
    # --width without --image
    r = subprocess.run([sys.executable, "-m", "horizonator_jax.cli",
                        "--width", "100", "34", "-117", "0", "45"],
                       capture_output=True, text=True, cwd="/root/repo", env=env)
    assert r.returncode == 1 and "--image" in r.stderr
    # bad latitude
    r = subprocess.run([sys.executable, "-m", "horizonator_jax.cli",
                        "--width", "10", "--image", "/tmp/x.png",
                        "95", "-117", "0", "45"],
                       capture_output=True, text=True, cwd="/root/repo", env=env)
    assert r.returncode == 1 and "latitude" in r.stderr
    # --width WITH --pois-out alone is legal (the GIS batch mode reads it;
    # r3 rejected it with a misleading --image error): validation falls
    # through to the pois/pois-out pairing check instead
    r = subprocess.run([sys.executable, "-m", "horizonator_jax.cli",
                        "--width", "100", "--pois-out", "/tmp/x.geojson",
                        "34", "-117", "0", "45"],
                       capture_output=True, text=True, cwd="/root/repo", env=env)
    assert r.returncode == 1 and "--pois-out needs --pois" in r.stderr
    # --width 1 would divide by zero in the pixel-center conversion
    r = subprocess.run([sys.executable, "-m", "horizonator_jax.cli",
                        "--width", "1", "--image", "/tmp/x.png",
                        "34", "-117", "0", "45"],
                       capture_output=True, text=True, cwd="/root/repo", env=env)
    assert r.returncode == 1 and "width" in r.stderr
    # AZ_RADIUS_DEG 0 would divide by zero in the default-height formula
    r = subprocess.run([sys.executable, "-m", "horizonator_jax.cli",
                        "--width", "100", "--image", "/tmp/x.png",
                        "34", "-117", "0", "0"],
                       capture_output=True, text=True, cwd="/root/repo", env=env)
    assert r.returncode == 1 and "AZ_RADIUS_DEG" in r.stderr


def test_dropped_guard_small_nsteps_warns(dem_dir):
    """A manual nsteps below k_cross_for's latitude-scaled budget used to
    silently truncate the march short of zfar (lowered horizons); the
    march's truncation counter now reaches render()/horizon() as a
    RuntimeWarning, and strict_coverage=True turns it into an error."""
    hh = horizonator(34.40, -117.45, 64, 32, dir_dems=dem_dir,
                     render_radius_m=20000.0, nsteps=64)
    with pytest.warns(RuntimeWarning, match="masked"):
        hh.render(-60, 60, zfar=20000.0)
    with pytest.warns(RuntimeWarning, match="masked"):
        hh.horizon(-60, 60, zfar=20000.0)
    with pytest.warns(RuntimeWarning, match="masked"):
        hh.skyline(-60, 60, zfar=20000.0)
    hs = horizonator(34.40, -117.45, 64, 32, dir_dems=dem_dir,
                     render_radius_m=20000.0, nsteps=64,
                     strict_coverage=True)
    with pytest.raises(RuntimeError, match="masked"):
        hs.render(-60, 60, zfar=20000.0)


def test_dropped_guard_quiet_on_auto_budget(dem_dir):
    """The default (k_cross_for-sized) budget must never trip the guard."""
    import warnings
    hh = horizonator(34.40, -117.45, 64, 32, dir_dems=dem_dir,
                     render_radius_m=20000.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        hh.render(-60, 60, zfar=20000.0)
        hh.horizon(-60, 60, zfar=20000.0)
        hh.skyline(-60, 60, zfar=20000.0)


def test_render_batch_method(dem_dir):
    import numpy as np
    from horizonator_jax.api import horizonator
    h = horizonator(34.40, -117.45, 128, 64, dir_dems=dem_dir,
                    render_radius_m=20000.0)
    imgs, rngs = h.render_batch(-60, 60, [34.40, 34.42], [-117.45, -117.44],
                                zfar=20000.0)
    assert imgs.shape == (2, 64, 128, 3)
    assert rngs.shape == (2, 64, 128)
    # batch element 0 equals the single render from the same spot
    img1, rng1 = h.render(-60, 60, lat=34.40, lon=-117.45, zfar=20000.0)
    np.testing.assert_array_equal(imgs[0], img1)
    np.testing.assert_array_equal(rngs[0], rng1)
    assert not np.array_equal(imgs[0], imgs[1])


def test_render_batch_color_ramp_kwargs(h):
    imgs_d, rngs_d = h.render_batch(-60, 60, [34.40], [-117.45])
    # pin the ramp to a tiny window: everything visible saturates red
    imgs_c, rngs_c = h.render_batch(-60, 60, [34.40], [-117.45],
                                    znear_color=1.0, zfar_color=2.0)
    np.testing.assert_array_equal(rngs_d, rngs_c)   # ranges unaffected
    vis = rngs_c[0] > 0
    assert (imgs_c[0][..., 2][vis] == 255).all()
    assert not (imgs_d[0][..., 2][vis] == 255).all()
    # and it matches the single render with the same ramp (explicit camera:
    # other tests in this module may have moved the shared fixture's viewer)
    img1, _ = h.render(-60, 60, lat=34.40, lon=-117.45,
                       znear_color=1.0, zfar_color=2.0)
    np.testing.assert_array_equal(imgs_c[0], img1)


def test_render_batch_multichip_through_api(dem_dir):
    """VERDICT round-2 item 3: multi-chip reachable from the public API
    alone -- an 8-virtual-device mesh through horizonator.render_batch."""
    import jax
    from jax.sharding import Mesh
    from horizonator_jax.api import horizonator
    h = horizonator(34.40, -117.45, 128, 64, dir_dems=dem_dir,
                    render_radius_m=20000.0)
    lats = [34.40, 34.42, 34.44]
    lons = [-117.45, -117.44, -117.43]
    imgs1, rngs1 = h.render_batch(-60, 60, lats, lons, zfar=20000.0)

    # "auto": every device on the batch axis; 3 viewpoints pad to 8
    imgs_a, rngs_a = h.render_batch(-60, 60, lats, lons, zfar=20000.0,
                                    mesh="auto")
    assert imgs_a.shape == imgs1.shape
    np.testing.assert_array_equal(imgs_a, imgs1)
    np.testing.assert_array_equal(rngs_a, rngs1)

    # explicit 2x4 batch x az mesh: wedge-local f32 tolerance
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("batch", "az"))
    imgs_m, rngs_m = h.render_batch(-60, 60, lats, lons, zfar=20000.0,
                                    mesh=mesh)
    vis_agree = (rngs_m > 0) == (rngs1 > 0)
    assert (~vis_agree).mean() < 0.002
    np.testing.assert_allclose(rngs_m[vis_agree], rngs1[vis_agree],
                               rtol=5e-3, atol=1.0)

    # batch-only mesh gets a size-1 wedge axis added
    mesh_b = Mesh(np.array(jax.devices()[:4]), ("batch",))
    imgs_b, _ = h.render_batch(-60, 60, lats, lons, zfar=20000.0,
                               mesh=mesh_b)
    np.testing.assert_array_equal(imgs_b, imgs1)

    # the shard_map closure is cached per (mesh, static config): a second
    # call with the same mesh must reuse it (a fresh jit wrapper identity
    # every call would recompile every call)
    n_cached = len(h._sharded_cache)
    h.render_batch(-60, 60, lats, lons, zfar=20000.0, mesh=mesh_b)
    assert len(h._sharded_cache) == n_cached


def test_cli_ranges_output(dem_dir, tmp_path):
    out = tmp_path / "pano.png"
    rng_npy = tmp_path / "ranges.npy"
    rng_raw = tmp_path / "ranges.f32"
    for rf in (rng_npy, rng_raw):
        r = subprocess.run(
            [sys.executable, "-m", "horizonator_jax.cli",
             "--width", "200", "--height", "80",
             "--image", str(out), "--ranges", str(rf),
             "--dirdems", dem_dir, "--zfar", "20000", "--nsteps", "256",
             "34.40", "-117.45", "0", "60"],
            capture_output=True, text=True, cwd="/root/repo", env=_CLI_ENV)
        assert r.returncode == 0, r.stderr
    a = np.load(rng_npy)
    assert a.shape == (80, 200) and a.dtype == np.float32
    assert (a > 0).any() and (a == -1).any()
    b = np.fromfile(rng_raw, dtype="<f4").reshape(80, 200)
    np.testing.assert_array_equal(a, b)


def test_hillshade_render(dem_dir):
    """Beyond-reference hillshade: sun-shaded terrain through the in-kernel
    textured path, no tiles required."""
    hs = horizonator(34.40, -117.45, 200, 80, dir_dems=dem_dir,
                     render_radius_m=25000.0, nsteps=512, hillshade=True,
                     sun_az_deg=90.0, sun_alt_deg=35.0)
    img, rng = hs.render(-30, 30)
    assert img.shape == (80, 200, 3) and rng.shape == (80, 200)
    vis = rng > 0
    assert vis.any()
    # the red-ramp-only render has G == 0 on terrain; hillshade's gray
    # texture puts weight in every channel (0.7*tex + 0.3*ramp blend)
    assert img[..., 1][vis].max() > 40
    # sun from the east vs the west shades the two flanks differently
    hw = horizonator(34.40, -117.45, 200, 80, dir_dems=dem_dir,
                     render_radius_m=25000.0, nsteps=512, hillshade=True,
                     sun_az_deg=270.0, sun_alt_deg=35.0)
    img_w, _ = hw.render(-30, 30)
    assert (img[..., 1][vis] != img_w[..., 1][vis]).any()
    with pytest.raises(ValueError):
        horizonator(34.40, -117.45, 100, 50, dir_dems=dem_dir,
                    render_radius_m=25000.0, render_texture=True,
                    hillshade=True)


def test_cli_hillshade(dem_dir, tmp_path):
    out = tmp_path / "hs.png"
    r = subprocess.run(
        [sys.executable, "-m", "horizonator_jax.cli",
         "--width", "200", "--height", "80", "--image", str(out),
         "--dirdems", dem_dir, "--zfar", "25000", "--nsteps", "512",
         "--hillshade", "--sun-az", "90", "--sun-alt", "35",
         "34.40", "-117.45", "0", "40"],
        capture_output=True, text=True, cwd="/root/repo", env=_CLI_ENV)
    assert r.returncode == 0, r.stderr
    from PIL import Image
    im = np.asarray(Image.open(out))
    assert im.shape == (80, 200, 3)
    # terrain pixels are gray-ish (hillshade), not pure red-ramp
    ground = im[-10:]                       # bottom rows: near terrain
    assert ground[..., 1].max() > 40


def test_hillshade_sun_time(dem_dir):
    """sun_time places the hillshade sun astronomically: a morning and an
    evening render of the same scene shade opposite flanks."""
    hm = horizonator(34.40, -117.45, 160, 60, dir_dems=dem_dir,
                     render_radius_m=25000.0, nsteps=512, hillshade=True,
                     sun_time="2026-08-18T15:00:00")       # ~8am local
    he = horizonator(34.40, -117.45, 160, 60, dir_dems=dem_dir,
                     render_radius_m=25000.0, nsteps=512, hillshade=True,
                     sun_time="2026-08-19T01:00:00")       # ~6pm local
    assert 60 < hm.sun_az_deg < 120 and 240 < he.sun_az_deg < 300
    im, rm = hm.render(-30, 30)
    ie, re_ = he.render(-30, 30)
    vis = (rm > 0) & (re_ > 0)
    assert (im[..., 1][vis] != ie[..., 1][vis]).mean() > 0.2


def test_debug_fill_validation(h):
    """debug_fill: bad mode fails loudly; wireframe returns a normal-shape
    BGR frame with green-dominant lattice pixels (the GLUT fill-mode
    analog, standalone.c:68-97)."""
    with pytest.raises(ValueError, match="wireframe.*point|point.*wireframe"):
        h.render(-60, 60, debug_fill="triangles")
    img = h.render(-60, 60, return_range=False, debug_fill="wireframe")
    assert img.shape == (h.height, h.width, 3) and img.dtype == np.uint8
    vis_green = ((img[:, :, 1].astype(int) > img[:, :, 0].astype(int) + 40)
                 & (img[:, :, 1].astype(int) > img[:, :, 2].astype(int)))
    assert vis_green.sum() > 50
