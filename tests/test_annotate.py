"""Annotation subsystem tests: occlusion fuzz, label staggering, SVG/PDF
emission."""

import numpy as np
import pytest

from horizonator_jax.annotate import (Poi, annotate, build_annotation_scene,
                                      load_pois)
from horizonator_jax.annotate.layout import (FONT_HEIGHT, stagger_labels,
                                             string_width)
from horizonator_jax.annotate.occlusion import project_and_occlusion_test


def _flat_scene(w=280, h=140):
    """A render where everything below the horizon row is terrain at a known
    range."""
    image = np.zeros((h, w, 3), np.uint8)
    image[: h // 2] = (255, 0, 0)       # sky, BGR
    ranges = np.full((h, w), -1.0, np.float32)
    ranges[h // 2:] = 5000.0
    return image, ranges


def test_occlusion_accepts_matching_range():
    _, ranges = _flat_scene()
    h, w = ranges.shape
    # A POI dead ahead at ~5 km, just below the horizon: el slightly negative.
    # viewer at (0,0), az window -45..45, az=0 -> north
    lat_poi = 5000.0 / 111194.9   # ~5 km north
    keep, x, y = project_and_occlusion_test(
        ranges, [lat_poi], [0.0], [0.0], 0.0, 0.0, 50.0, -45.0, 45.0, h)
    assert keep[0]
    assert abs(x[0] - (w / 2 - 0.5)) < 1.0

    # Same POI but the rendered range disagrees by > FUZZ_RANGE -> dropped
    ranges2 = np.where(ranges > 0, 9000.0, ranges).astype(np.float32)
    keep2, _, _ = project_and_occlusion_test(
        ranges2, [lat_poi], [0.0], [0.0], 0.0, 0.0, 50.0, -45.0, 45.0, h)
    assert not keep2[0]


def test_occlusion_distance_gates():
    _, ranges = _flat_scene()
    h, w = ranges.shape
    # too close (< 500 m) and too far (> 100 km) both rejected
    for dist, rng_val in [(300.0, 300.0), (150000.0, 150000.0)]:
        lat_poi = dist / 111194.9
        r = np.where(ranges > 0, rng_val, ranges).astype(np.float32)
        keep, _, _ = project_and_occlusion_test(
            r, [lat_poi], [0.0], [0.0], 0.0, 0.0, 10.0, -45.0, 45.0, h)
        assert not keep[0]


def test_stagger_labels():
    pois = [Poi(f"P{i}", 0, 0, 0) for i in range(3)]
    # two overlapping at x=10,12 and one far right
    out = stagger_labels(pois, [10.0, 12.0, 200.0], [50.0, 50.0, 50.0], 140)
    tops = {p.name: ytop for p, x, y, ytop in out}
    assert tops["P0"] == 0.0
    assert tops["P1"] == FONT_HEIGHT       # staggered down
    assert tops["P2"] == 0.0               # new group, back to top


def test_string_width_monotone():
    assert string_width("Mount Baldy") > string_width("Mt B")
    assert string_width("iii") < string_width("MMM")


def test_scene_and_svg_pdf(tmp_path):
    image, ranges = _flat_scene()
    h, w = ranges.shape
    lat_poi = 5000.0 / 111194.9
    pois = [Poi("Testpeak", lat_poi, 0.0, 0.0)]
    scene = build_annotation_scene(image, ranges, 0, pois,
                                   0.0, 0.0, -45.0, 45.0, 50.0)
    assert len(scene.link_rects) > 50          # grid over the terrain half
    assert any(t.s == "Testpeak" for t in scene.texts)
    assert any(t.s == "0deg" for t in scene.texts)   # bearing tick
    assert any(t.s == "30deg" for t in scene.texts)
    assert not any(t.s == "90deg" for t in scene.texts)  # outside window

    svg_f = tmp_path / "out.svg"
    annotate(str(svg_f), image, ranges, pois=pois, lat=0.0, lon=0.0,
             az_deg0=-45.0, az_deg1=45.0, ele_m=50.0)
    svg = svg_f.read_text()
    assert svg.startswith("<svg") and "Testpeak" in svg and "caltopo" in svg

    pdf_f = tmp_path / "out.pdf"
    annotate(str(pdf_f), image, ranges, pois=pois, lat=0.0, lon=0.0,
             az_deg0=-45.0, az_deg1=45.0, ele_m=50.0)
    raw = pdf_f.read_bytes()
    assert raw.startswith(b"%PDF-1.4")
    assert raw.rstrip().endswith(b"%%EOF")
    assert b"/Subtype /Link" in raw and b"caltopo" in raw
    assert b"/Subtype /Image" in raw


def test_pdf_parses_with_pypdf_or_structure(tmp_path):
    """Validate the hand-written PDF's xref structure by re-reading offsets."""
    image, ranges = _flat_scene()
    pdf_f = tmp_path / "x.pdf"
    annotate(str(pdf_f), image, ranges, pois=[], lat=0.0, lon=0.0,
             az_deg0=-45.0, az_deg1=45.0, ele_m=50.0)
    raw = pdf_f.read_bytes()
    # xref offsets must point at "N 0 obj"
    xref_at = int(raw.rsplit(b"startxref", 1)[1].split(b"%%EOF")[0].strip())
    assert raw[xref_at:xref_at + 4] == b"xref"
    lines = raw[xref_at:].split(b"\n")
    nobj = int(lines[1].split()[1])
    for i in range(1, nobj):
        off = int(lines[2 + i].split()[0])
        assert raw[off:].startswith(f"{i} 0 obj".encode())


def test_cut_off_bottom(tmp_path):
    image, ranges = _flat_scene()
    scene = build_annotation_scene(image, ranges, 40, [], 0.0, 0.0,
                                   -45.0, 45.0, 50.0)
    assert scene.height == ranges.shape[0] - 40
    assert scene.image_rgb.shape[0] == scene.height


def test_load_pois(tmp_path):
    f = tmp_path / "p.json"
    f.write_text('[{"name":"A","lat":1,"lon":2,"ele_m":3},'
                 '{"name":"B","lat":4,"lon":5,"ele":6}]')
    pois = load_pois(str(f))
    assert pois[0] == Poi("A", 1, 2, 3)
    assert pois[1].ele_m == 6.0


def test_dome_shoulder_occlusion_semantics(tmp_path):
    """A smooth dome seen from below: the tangent-horizon shoulder is
    labelable, the true summit behind it fails the +-500 m range fuzz
    (annotator.c:311-348 semantics) -- verified through the full
    render + occlusion pipeline."""
    import math
    import numpy as np
    import jax.numpy as jnp
    from horizonator_jax.render import RenderParams, render_panorama
    from horizonator_jax.render.crossing import k_cross_for
    from horizonator_jax.annotate.occlusion import project_and_occlusion_test

    n = 384
    cpd = 1200
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    # dome centered 180 cells north of the viewer
    cx, cy, = n / 2, n / 2 + 160
    z = 200 + 2200 * np.exp(-((ii - cx) ** 2 + (jj - cy) ** 2) / (2 * 40.0 ** 2))
    dem = jnp.asarray(z, jnp.float32)

    lat0, lon0 = 34.0, -118.0      # viewer geodetic anchor
    vi, vj = n / 2, n / 2
    vz = float(z[int(vj), int(vi)]) + 2.0
    f = jnp.float32
    zfar = 25000.0
    p = RenderParams(f(vi), f(vj), f(vz), f(math.cos(math.radians(lat0))),
                     f(math.radians(-30.0)), f(math.radians(30.0)),
                     f(100.0), f(zfar), f(100.0), f(zfar))
    k = k_cross_for(zfar, cpd, lat0, n=n)
    img, rng = render_panorama(dem, p, width=512, height=256, nsteps=k,
                               cells_per_deg=cpd, sampler="window",
                               lat_hint_deg=lat0)
    rng = np.asarray(rng)

    cell_deg = 1.0 / cpd
    summit_lat = lat0 + (cy - vj) * cell_deg
    summit_ele = float(z[int(cy), int(cx)])
    # the visible shoulder: walk the dome toward the viewer to the tangent pt
    best = None
    for dj in range(20, 160):
        jx = cy - dj
        ele = float(z[int(jx), int(cx)])
        d = (jx - vj) * (6371000.0 * math.pi / 180.0 / cpd)
        tan_el = (ele - vz) / d
        if best is None or tan_el > best[0]:
            best = (tan_el, jx, ele)
    _, jx_sh, ele_sh = best
    shoulder_lat = lat0 + (jx_sh - vj) * cell_deg

    keep, x, y = project_and_occlusion_test(
        rng, [shoulder_lat, summit_lat], [lon0, lon0], [ele_sh, summit_ele],
        lat0, lon0, vz, -30.0, 30.0, 256)
    assert bool(keep[0]), "tangent shoulder must be labelable"
    assert not bool(keep[1]), "occluded summit must fail the range fuzz"


def test_png_backend(tmp_path):
    """PNG annotation backend (beyond reference): labels rasterized into
    the bitmap; label pixels must appear in yellow near the POI."""
    import numpy as np
    from horizonator_jax.annotate import annotate, Poi
    h, w = 120, 400
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :, 0] = 255                       # blue sky (BGR)
    rng = np.full((h, w), -1.0, np.float32)
    rng[60:, :] = 5000.0                     # terrain in the lower half
    img[60:, :, 0] = 0
    img[60:, :, 2] = 120
    poi = Poi("Testberg", 34.55, -117.45, 2500.0)
    out = tmp_path / "anno.png"
    annotate(str(out), img, rng, pois=[poi], lat=34.40, lon=-117.45,
             az_deg0=-30.0, az_deg1=30.0, ele_m=900.0)
    from PIL import Image
    arr = np.asarray(Image.open(out))
    assert arr.shape == (h, w, 3)
    # yellow annotation pixels exist (RGB: high R, high G, low B)
    yellow = (arr[..., 0] > 200) & (arr[..., 1] > 200) & (arr[..., 2] < 80)
    assert yellow.sum() > 20
