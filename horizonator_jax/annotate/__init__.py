"""Peak annotation: occlusion-tested, staggered, hyperlinked labels over a
rendered panorama, written to PDF or SVG.

Feature-parity port of annotator.c (annotate(), annotator.c:142-426) on top
of the shared JAX projection math, without cairo: the same link grid, POI
occlusion fuzz test, label staggering, and 15-degree bearing ticks, emitted
by from-scratch SVG/PDF backends.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass

import numpy as np

from .. import geometry
from .layout import (FONT_HEIGHT, FONT_SIZE, LABEL_CROSSHAIR_R, stagger_labels,
                     string_width)
from .occlusion import project_and_occlusion_test
from .scene import AnnotationScene, Line, LinkRect, Text, caltopo_url

LINK_CELL = 14           # annotator.c:228-229
BEARING_SPACING_DEG = 15  # annotator.c:391


@dataclass
class Poi:
    """A point of interest (annotator.h:4-8)."""
    name: str
    lat: float
    lon: float
    ele_m: float


def load_pois(path: str) -> list[Poi]:
    """Load a POI list from JSON: [{"name":..., "lat":..., "lon":...,
    "ele_m":...}] (this build's replacement for the compiled-in
    socal-peaks.h, standalone.c:493-497)."""
    with open(path) as f:
        raw = json.load(f)
    return [Poi(name=str(d["name"]), lat=float(d["lat"]), lon=float(d["lon"]),
                ele_m=float(d.get("ele_m", d.get("ele", 0.0)))) for d in raw]


def build_annotation_scene(image_bgr: np.ndarray, range_image: np.ndarray,
                           cut_off_bottom_px: int,
                           pois: list[Poi],
                           lat: float, lon: float,
                           az_deg0: float, az_deg1: float,
                           ele_m: float,
                           curv: float = 0.0) -> AnnotationScene:
    """Assemble the drawing-primitive scene (the backend-free 90% of
    annotator.c's annotate())."""
    h, w = range_image.shape
    height_out = h - cut_off_bottom_px   # annotator.c:161
    image_rgb = np.ascontiguousarray(image_bgr[:height_out, :, ::-1])
    scene = AnnotationScene(width=w, height=height_out, image_rgb=image_rgb)

    # ---- link grid (annotator.c:209-264): every 14x14 cell with render data
    # gets an invisible rectangle linking to the map at its unprojected
    # lat/lon. Reference quirk preserved: the range is read at the cell's
    # top-left corner, the unprojection happens at the cell center.
    ys = np.arange(0, height_out - LINK_CELL, LINK_CELL)
    xs = np.arange(0, w - LINK_CELL, LINK_CELL)
    if len(ys) and len(xs):
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
        rr = range_image[yy, xx]
        ok = rr > 0
        cos_lat = math.cos(math.radians(lat))
        glat, glon = geometry.unproject(
            (xx + LINK_CELL // 2).astype(np.float64),
            (yy + LINK_CELL // 2).astype(np.float64),
            rr.astype(np.float64), -1.0,
            lat, cos_lat, lon, az_deg0, az_deg1, w, h)
        glat = np.asarray(glat)
        glon = np.asarray(glon)
        for j, i in zip(*np.nonzero(ok)):
            scene.link_rects.append(LinkRect(
                float(xs[i]), float(ys[j]), LINK_CELL, LINK_CELL,
                caltopo_url(glat[j, i], glon[j, i])))

    # ---- POIs: project + occlusion fuzz (annotator.c:279-348)
    if pois:
        keep, px, py = project_and_occlusion_test(
            range_image,
            [p.lat for p in pois], [p.lon for p in pois],
            [p.ele_m for p in pois],
            lat, lon, ele_m, az_deg0, az_deg1, height_out, curv=curv)
        kept = [(pois[i], float(px[i]), float(py[i]))
                for i in range(len(pois)) if keep[i]]
        if kept:
            kp, kx, ky = zip(*kept)
            for poi, x, y, y_top in stagger_labels(list(kp), list(kx),
                                                   list(ky), height_out):
                url = caltopo_url(poi.lat, poi.lon)
                # crosshair + leader (draw_label, annotator.c:68-96)
                scene.lines.append(Line(x - LABEL_CROSSHAIR_R, y,
                                        x + LABEL_CROSSHAIR_R, y))
                scene.lines.append(Line(x, y + LABEL_CROSSHAIR_R, x, y_top))
                scene.texts.append(Text(x, y_top + FONT_HEIGHT, poi.name,
                                        FONT_SIZE, url=url))

    # ---- bearing ticks every 15 deg (annotator.c:391-411)
    for az in range(180, -180, -BEARING_SPACING_DEG):
        x, az_ndc, _ = geometry.x_from_az(
            math.radians(az), math.radians(az_deg0), math.radians(az_deg1), w)
        if not (-1.0 <= float(az_ndc) <= 1.0):
            continue
        scene.texts.append(Text(float(x), height_out - FONT_HEIGHT,
                                f"{az}deg", FONT_SIZE, centered=True))
    return scene


def annotate(out_filename: str, image_bgr, range_image, *,
             cut_off_bottom_px: int = 0,
             pois: list[Poi] | None = None,
             lat: float, lon: float,
             az_deg0: float, az_deg1: float,
             ele_m: float, curv: float = 0.0) -> None:
    """Write an annotated panorama to .pdf or .svg (annotator.c:142-205
    contract: the extension picks the backend), or -- beyond the
    reference -- to a labeled .png bitmap (no hyperlink grid there)."""
    scene = build_annotation_scene(
        np.asarray(image_bgr), np.asarray(range_image), cut_off_bottom_px,
        pois or [], lat, lon, az_deg0, az_deg1, ele_m, curv=curv)
    low = out_filename.lower()
    if low.endswith(".pdf"):
        from .pdf import write_pdf
        write_pdf(scene, out_filename)
    elif low.endswith(".svg"):
        from .svg import write_svg
        write_svg(scene, out_filename)
    elif low.endswith(".png"):
        from .png import write_png
        write_png(scene, out_filename)
    else:
        raise ValueError(
            f"output filename must be xxx.pdf, xxx.svg, or xxx.png; got "
            f"'{out_filename}'")


__all__ = ["Poi", "load_pois", "annotate", "build_annotation_scene",
           "string_width"]
