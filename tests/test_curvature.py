"""Earth-curvature / refraction correction (beyond-reference feature).

The reference projects on a flat tangent plane (vertex.glsl:63-88 derives
its error bounds but EXCLUDES curvature -- ~125 m of apparent-height error
at its default 40 km zfar). RenderParams.curv = 1/(2 R_effective) drops
apparent tan(el) by curv*d; geometry.curvature_coeff maps the user-facing
modes. Default 0 preserves exact reference parity (golden render covers
that); these tests check the physics and cross-sampler consistency.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from horizonator_jax import geometry
from horizonator_jax.render import RenderParams, render_panorama
from horizonator_jax.render.crossing import k_cross_for
from horizonator_jax.render.window import march_window

CPD = 1200


def _params(n, vz, zfar, curv):
    f = jnp.float32
    return RenderParams(
        viewer_cell_i=f(n / 2), viewer_cell_j=f(n / 2), viewer_z=f(vz),
        cos_viewer_lat=f(math.cos(math.radians(34.0))),
        az_rad0=f(-math.pi), az_rad1=f(math.pi),
        znear=f(50.0), zfar=f(zfar), znear_color=f(50.0), zfar_color=f(zfar),
        curv=f(curv))


def test_coefficients():
    assert geometry.curvature_coeff("none") == 0.0
    R = geometry.EARTH_RADIUS_M
    assert geometry.curvature_coeff("spherical") == pytest.approx(1 / (2 * R))
    assert geometry.curvature_coeff("refracted") == pytest.approx(
        (1 - 0.13) / (2 * R))
    assert geometry.curvature_coeff("refracted") < geometry.curvature_coeff(
        "spherical")
    assert geometry.curvature_coeff(1e-8) == 1e-8


def test_ocean_horizon_dip_matches_theory():
    # flat sea, viewer at height hv: the horizon tangent is
    # max_d (-hv/d - c*d) = -2*sqrt(hv*c) at d* = sqrt(hv/c) -- the classic
    # dip formula. Use an exaggerated curvature so d* fits a small grid.
    n = 192
    dem = jnp.zeros((n, n), jnp.float32)
    hv = 100.0
    c = 1.0 / (2.0 * 50000.0)                 # R_eff = 50 km
    d_star = math.sqrt(hv / c)                # ~3162 m, well inside zfar
    p = _params(n, hv, 7000.0, c)
    k = k_cross_for(7000.0, CPD, 34.0, n=n)
    tanel, _, _, _ = march_window(dem, p, width=128, k_cross=k,
                                  cells_per_deg=CPD, lat_hint_deg=34.0)
    dip = float(jnp.max(tanel, axis=1).max())
    want = -2.0 * math.sqrt(hv * c)
    # sampling hits within a cell of d*; tolerance = curvature over a cell
    assert dip == pytest.approx(want, abs=2e-4), (dip, want, d_star)

    # flat-plane control: horizon tangent approaches 0 from below
    p0 = _params(n, hv, 7000.0, 0.0)
    dip0 = float(jnp.max(march_window(
        dem, p0, width=128, k_cross=k, cells_per_deg=CPD,
        lat_hint_deg=34.0)[0], axis=1).max())
    assert dip0 > -0.02 and dip0 < 0.0
    assert dip < dip0                          # curvature lowers horizons


def test_curvature_hides_distant_terrain():
    # a ridge at ~15 km whose top is just above the flat-plane line of
    # sight disappears behind the curve when correction is on
    n = 360
    cell = geometry.EARTH_RADIUS_M * math.pi / 180.0 / CPD
    dem = np.zeros((n, n), np.float32)
    ridge_j = n // 2 + int(15000.0 / cell)
    d_ridge = (ridge_j - n / 2) * cell
    c = geometry.curvature_coeff("spherical")
    vz = 50.0
    # apparent drop at the ridge = c*d^2 ~ 17.5 m at 15 km; pick a ridge
    # height between the flat and curved lines of sight at el=0
    drop = c * d_ridge * d_ridge
    dem[ridge_j, :] = vz + 0.5 * drop
    demj = jnp.asarray(dem)
    k = k_cross_for(20000.0, CPD, 34.0, n=n)

    def horizon(curv):
        p = _params(n, vz, 20000.0, curv)
        tanel, _, _, _ = march_window(demj, p, width=64, k_cross=k,
                                      cells_per_deg=CPD, lat_hint_deg=34.0)
        return np.asarray(jnp.max(tanel, axis=1))

    flat = horizon(0.0)
    curved = horizon(c)
    north = 32  # column looking at the ridge (az ~ 0 is mid-width... find it)
    assert flat.max() > 0.0          # ridge pokes above eye level flat
    assert curved.max() < 0.0        # and hides behind the curve


def test_render_and_project_agree_with_curvature():
    # a rendered peak's horizon column row == geometry.project of its
    # summit with the same curv (annotations stay glued to peaks)
    n = 256
    cell = geometry.EARTH_RADIUS_M * math.pi / 180.0 / CPD
    dem = np.zeros((n, n), np.float32)
    pj, pi = 200, 128
    dem[pj - 2:pj + 3, pi - 2:pi + 3] = 900.0
    demj = jnp.asarray(dem)
    c = 1.0 / (2.0 * 2000000.0)     # exaggerated ~3x earth
    vz = 100.0
    W, H = 256, 128
    p = _params(n, vz, 12000.0, c)
    k = k_cross_for(12000.0, CPD, 34.0, n=n)
    img, rng = render_panorama(demj, p, width=W, height=H, nsteps=k,
                               cells_per_deg=CPD, sampler="window",
                               lat_hint_deg=34.0)
    rngs = np.asarray(rng)

    # project the summit with the same curv: lat/lon of cell (pj, pi)
    lat_v = 34.0
    dlat = (pj - n / 2) * cell / (geometry.EARTH_RADIUS_M * math.pi / 180.0)
    dlon = ((pi - n / 2) * cell
            / (geometry.EARTH_RADIUS_M * math.pi / 180.0
               * math.cos(math.radians(lat_v))))
    x, y, r, vis = geometry.project(
        lat_v, math.cos(math.radians(lat_v)), -118.0, vz,
        lat_v + dlat, -118.0 + dlon, 900.0,
        -math.pi, math.pi, W, H, curv=c)
    assert bool(vis)
    xi, yi = int(round(float(x))), int(round(float(y)))
    # the pixel just below the projected summit is terrain, just above sky
    col = rngs[:, xi]
    top_terrain = np.argmax(col > 0)
    assert abs(top_terrain - yi) <= 1, (top_terrain, yi)


def test_samplers_agree_with_curvature():
    # window kernel == crossing sampler under the same curv
    from horizonator_jax.render.crossing import march_crossing, pack_scene
    rng = np.random.default_rng(7)
    n = 192
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = 300 + 200 * np.sin(ii / 17.0) * np.cos(jj / 23.0)
    dem = jnp.asarray(np.maximum(z, 0).astype(np.float32))
    c = geometry.curvature_coeff("refracted")
    p = _params(n, float(z[96, 96]) + 30.0, 8000.0, c)
    k = k_cross_for(8000.0, CPD, 34.0, n=n)
    t_w, _, _, _ = march_window(dem, p, width=128, k_cross=k,
                                cells_per_deg=CPD, lat_hint_deg=34.0)
    t_c, _, _, _ = march_crossing(pack_scene(dem), p, width=128, k_cross=k,
                                  cells_per_deg=CPD)
    hw = np.asarray(jnp.max(t_w, axis=1))
    hc = np.asarray(jnp.max(t_c, axis=1))
    np.testing.assert_allclose(hw, hc, atol=5e-4)


def test_api_curvature_modes(tmp_path):
    from tests.conftest import make_synthetic_dem_dir
    import horizonator_jax

    def scene(lat, lon):
        peak = 1500.0 * np.exp(-((lat - 34.6) ** 2 + (lon + 117.4) ** 2)
                               / (2 * 0.02 ** 2))
        return np.round(np.maximum(peak + 200.0, 0)).astype(np.int16)

    demdir = make_synthetic_dem_dir(tmp_path, {(34, -118): scene})
    imgs = {}
    for mode in ("none", "refracted"):
        h = horizonator_jax.horizonator(
            34.40, -117.45, 256, 128, dir_dems=demdir,
            render_radius_m=30000.0, curvature=mode)
        img, rngs = h.render(0.0, 60.0)
        imgs[mode] = np.asarray(rngs) > 0
    # refraction-corrected sky is a (weak) superset: terrain only drops
    assert imgs["refracted"].sum() <= imgs["none"].sum()
    assert imgs["none"].any()


def test_unknown_mode_raises_with_valid_modes_named():
    with pytest.raises(ValueError, match="spherical"):
        geometry.curvature_coeff("Spherical")   # typo'd case
    with pytest.raises(ValueError, match="refracted"):
        geometry.curvature_coeff("bogus")
