"""Golden-render regression anchor (reference: example-*.png + repro
commands, README.org:78-80,123-127 — the reference's de-facto regression
artifacts; here the comparison is explicit and automated).

Renders the canonical view through the FULL CLI path on a deterministic
synthetic DEM and compares every pixel against the checked-in golden PNG.
Any unintentional change to the render output fails this test; after a
DELIBERATE change, regenerate with

    HORIZONATOR_REGEN_GOLDEN=1 python -m pytest tests/test_golden.py -q

and commit the new golden with the reason for the change.

Pixel (not file-byte) comparison: PNG encoder bytes vary across PIL
versions, pixels must not. Runs on the CPU backend like the whole suite.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from horizonator_jax.compile_cache import cache_dir

from tests.conftest import make_synthetic_dem_dir

GOLDEN_DIR = Path(__file__).parent / "golden"

# The canonical view: mirrors the reference's standalone example command
# shape (README.org:123-127) on the synthetic peak+ridge scene below.
CANONICAL = ["--width", "800", "34.40", "-117.45", "20", "60"]
# Second golden: the EXACT azimuth arguments of the reference's
# example-standalone command ("--width 800 ... -35 125", README.org:124) --
# a 250-degree wide view with the default-FOV height path.
CANONICAL_WIDE = ["--width", "800", "34.40", "-117.45", "-35", "125"]


def _scene(lat, lon):
    """Deterministic terrain with azimuth structure: a tall Gaussian peak
    NNE of the viewer, a meridional ridge wall to the ENE, and rolling hills
    over a gentle slope -- so the golden horizon has peaks, a plateau edge,
    and undulation to anchor against."""
    peak = 2400.0 * np.exp(-((lat - 34.55) ** 2 + (lon + 117.40) ** 2)
                           / (2 * 0.03 ** 2))
    wall = 1100.0 * (np.exp(-((lon + 117.28) ** 2) / (2 * 0.012 ** 2))
                     * (lat > 34.42) * (lat < 34.75))
    hills = 120.0 * np.sin(lat * 140.0) * np.cos(lon * 170.0)
    slope = 250.0 + 400.0 * (lat - 34.0)
    return np.round(np.maximum(peak + wall + hills + slope, 0)
                    ).astype(np.int16)


def _render_cli(tmp_path, view=CANONICAL):
    demdir = make_synthetic_dem_dir(tmp_path, {(34, -118): _scene})
    out = tmp_path / "golden_out.png"
    # MINIMAL env, like test_api's _CLI_ENV: inheriting the suite's
    # XLA_FLAGS (8 virtual devices) slows the one-shot CLI compile ~6x;
    # the persistent cache is the suite's own (compile_cache.cache_dir)
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/root"),
           "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": cache_dir()}
    cmd = [sys.executable, "-m", "horizonator_jax.cli",
           "--image", str(out), "--dirdems", demdir] + view
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=900,
                       cwd=str(Path(__file__).parent.parent))
    assert r.returncode == 0, r.stderr
    from PIL import Image
    return np.asarray(Image.open(out)), cmd


def _check_golden(img, cmd, golden_path):
    if os.environ.get("HORIZONATOR_REGEN_GOLDEN"):
        GOLDEN_DIR.mkdir(exist_ok=True)
        from PIL import Image
        Image.fromarray(img).save(golden_path)
        pytest.skip(f"regenerated {golden_path} via: {' '.join(cmd)}")
    assert golden_path.exists(), (
        "golden missing; generate with HORIZONATOR_REGEN_GOLDEN=1")
    from PIL import Image
    want = np.asarray(Image.open(golden_path))
    assert img.shape == want.shape, (img.shape, want.shape)
    diff = (img != want).any(axis=-1)
    assert not diff.any(), (
        f"{int(diff.sum())} of {diff.size} pixels changed vs the golden "
        f"render; if deliberate, regenerate (see module docstring)")


@pytest.mark.slow
def test_golden_render_pixels_stable(tmp_path):
    img, cmd = _render_cli(tmp_path)
    _check_golden(img, cmd, GOLDEN_DIR / "canonical_800.png")


@pytest.mark.slow
def test_golden_render_wide_pixels_stable(tmp_path):
    img, cmd = _render_cli(tmp_path, view=CANONICAL_WIDE)
    _check_golden(img, cmd, GOLDEN_DIR / "canonical_800_wide.png")


@pytest.mark.slow
def test_golden_scene_sanity(tmp_path):
    # the golden view must actually contain sky, terrain, and the peak
    img, _ = _render_cli(tmp_path)
    bgr = img[:, :, ::-1]
    sky = (bgr[:, :, 0] == 255) & (bgr[:, :, 2] == 0)
    assert 0.2 < sky.mean() < 0.8
    assert (~sky).mean() > 0.2
