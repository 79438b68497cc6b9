"""chip_smoke.py: its comparison helpers, its refusal to run without a
GPU, and (``gpu`` marker) the whole smoke on the card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent.parent


def _ranges(h=64, w=128, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.uniform(200.0, 40000.0, (h, w)).astype(np.float32)
    r[: h // 3] = -1.0                              # sky band on top
    return r


def test_compare_ranges_identical():
    r = _ranges()
    st = cs.compare_ranges(r, r)
    assert st["mask_agree"] == 1.0 and st["median_rel"] == 0.0
    assert abs(st["terrain"] - (1 - (64 // 3) / 64)) < 1e-9
    cs.check_ranges(st, "identical")


def test_compare_ranges_counts_mask_flips_and_relative_error():
    want = _ranges()
    got = want.copy()
    got *= 1.0 + 5e-5                               # uniform 5e-5 drift
    got[40, :10] = -1.0                             # 10 terrain -> sky
    st = cs.compare_ranges(got, want)
    assert st["mask_agree"] == pytest.approx(1 - 10 / got.size)
    assert st["median_rel"] == pytest.approx(5e-5, rel=1e-2)   # f32 ulps


@pytest.mark.parametrize("mutate,msg", [
    (lambda r: r.__setitem__((slice(30, 40), slice(None)), -1.0), "masks"),
    (lambda r: r.__imul__(1.001), "median rel"),
])
def test_check_ranges_fails_outside_bounds(mutate, msg):
    want = _ranges()
    got = want.copy()
    mutate(got)
    with pytest.raises(cs.SmokeFailure, match=msg):
        cs.check_ranges(cs.compare_ranges(got, want), "mutated")


def test_check_ranges_fails_on_all_sky():
    # two identical all-sky renders agree perfectly and prove nothing
    sky = np.full((16, 32), -1.0, np.float32)
    with pytest.raises(cs.SmokeFailure, match="degenerate"):
        cs.check_ranges(cs.compare_ranges(sky, sky), "sky")


def test_compare_ranges_rejects_nonfinite_and_shape():
    want = _ranges()
    bad = want.copy()
    bad[5, 5] = np.nan
    with pytest.raises(cs.SmokeFailure, match="non-finite"):
        cs.compare_ranges(bad, want)
    with pytest.raises(cs.SmokeFailure, match="shape"):
        cs.compare_ranges(want[:, :-1], want)


def test_image_agreement_tolerance():
    a = np.full((8, 8, 3), 100, np.uint8)
    b = a.copy()
    b[0, :4, 1] = 102                               # within 2 counts
    b[1, :2, 2] = 103                               # 2 pixels beyond
    assert cs.image_agreement(b, a) == pytest.approx(1 - 2 / 64)


def test_synthetic_tiles_are_seeded_and_seamless(tmp_path):
    from horizonator_jax.dem import hgt
    cs.write_tiles(str(tmp_path), [(34, -118), (34, -117)], seed=3)
    west = hgt.read_hgt(tmp_path / hgt.hgt_filename(34, -118), False)
    east = hgt.read_hgt(tmp_path / hgt.hgt_filename(34, -117), False)
    assert west.shape == (hgt.SRTM3_EDGE, hgt.SRTM3_EDGE)
    # adjacent tiles share their edge column, as real .hgt tiles do
    np.testing.assert_array_equal(west[:, -1], east[:, 0])
    assert west.max() > west.min() + 100
    again = cs.terrain_m(np.float64(34.5), np.float64(-117.5), 3)
    assert again == cs.terrain_m(np.float64(34.5), np.float64(-117.5), 3)
    assert again != cs.terrain_m(np.float64(34.5), np.float64(-117.5), 4)


def _env_without_platform_pins():
    return {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}


def test_refuses_cpu_backend():
    env = _env_without_platform_pins()
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.fixture
def gpu():
    """Skip unless this host has an NVIDIA card (decided at run time)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no NVIDIA GPU on this host")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_env_without_platform_pins(),
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')


def test_raster_disagreement_edge_flips_pass_regions_fail():
    want = np.zeros((40, 40), bool)
    want[:, 20:] = True                              # one straight edge
    flips = want.copy()
    flips[5, 19] = True                              # on the edge
    flips[30, 5] = True                              # isolated, off-edge
    d = cs.raster_disagreement(flips, want)
    assert d["agree"] == pytest.approx(1 - 2 / 1600)
    assert d["off_edge"] == 0
    region = want.copy()
    region[2:12, 2:12] = True                        # a wrong block
    assert cs.raster_disagreement(region, want)["off_edge"] == 8 * 8
