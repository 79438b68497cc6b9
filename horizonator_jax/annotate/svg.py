"""SVG backend for the annotation scene.

Hand-rolled SVG (no cairo dependency). Unlike the reference -- which
warns "the links don't work" for its cairo-SVG output (annotator.c:192) --
links here are real ``<a href>`` elements.
"""

from __future__ import annotations

import base64
import io
from xml.sax.saxutils import escape, quoteattr

from .scene import SCALE, AnnotationScene


def _png_b64(image_rgb) -> str:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(image_rgb).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _rgb(color) -> str:
    r, g, b = (int(round(c * 255)) for c in color)
    return f"rgb({r},{g},{b})"


def write_svg(scene: AnnotationScene, out_filename: str) -> None:
    w_pt, h_pt = scene.page_w_pt, scene.page_h_pt
    parts = []
    parts.append(
        f'<svg xmlns="http://www.w3.org/2000/svg" '
        f'xmlns:xlink="http://www.w3.org/1999/xlink" '
        f'width="{w_pt:.2f}pt" height="{h_pt:.2f}pt" '
        f'viewBox="0 0 {scene.width} {scene.height}">')

    parts.append(f'<image x="0" y="0" width="{scene.width}" '
                 f'height="{scene.height}" '
                 f'xlink:href="data:image/png;base64,{_png_b64(scene.image_rgb)}"/>')

    # Invisible-but-clickable link grid (the reference must draw occluded
    # rectangles to get cairo links, annotator.c:211-215; SVG can just make a
    # transparent rect clickable).
    for lr in scene.link_rects:
        parts.append(
            f'<a xlink:href={quoteattr(lr.url)} target="_blank">'
            f'<rect x="{lr.x:.1f}" y="{lr.y:.1f}" width="{lr.w:.1f}" '
            f'height="{lr.h:.1f}" fill="#000" fill-opacity="0" '
            f'pointer-events="all"/></a>')

    for ln in scene.lines:
        parts.append(
            f'<line x1="{ln.x0:.2f}" y1="{ln.y0:.2f}" x2="{ln.x1:.2f}" '
            f'y2="{ln.y1:.2f}" stroke="{_rgb(ln.color)}" '
            f'stroke-width="{ln.width:.2f}"/>')

    for t in scene.texts:
        anchor = ' text-anchor="middle"' if t.centered else ""
        el = (f'<text x="{t.x:.2f}" y="{t.y_baseline:.2f}" '
              f'font-family="Helvetica,Arial,sans-serif" '
              f'font-size="{t.size:.1f}" fill="{_rgb(t.color)}"{anchor}>'
              f'{escape(t.s)}</text>')
        if t.url is not None:
            el = f'<a xlink:href={quoteattr(t.url)} target="_blank">{el}</a>'
        parts.append(el)

    parts.append("</svg>")
    with open(out_filename, "w", encoding="utf-8") as f:
        f.write("\n".join(parts))
