"""Minimal-but-real PDF 1.4 writer for the annotation scene.

The reference renders its annotated panorama through cairo-pdf
(annotator.c:184-205). cairo isn't a dependency here, so this is a
from-scratch PDF generator producing exactly what the annotator needs: one
page at 72/300 scale, a FlateDecode RGB image XObject, Helvetica text,
stroked lines, and URI link annotations (both the invisible link grid and the
clickable labels).

Coordinates: the scene is in image pixels, y down; PDF user space is points,
y up. Everything is converted explicitly (no global flip, which would mirror
glyphs).
"""

from __future__ import annotations

import zlib

import numpy as np

from .scene import SCALE, AnnotationScene
from .layout import string_width


def _esc(s: str) -> bytes:
    """PDF literal-string escaping; non-latin1 chars degrade to '?'."""
    out = []
    for ch in s:
        if ch in "()\\":
            out.append("\\" + ch)
        elif ord(ch) < 32:
            out.append(f"\\{ord(ch):03o}")
        else:
            try:
                ch.encode("latin-1")
                out.append(ch)
            except UnicodeEncodeError:
                out.append("?")
    return "".join(out).encode("latin-1")


class _PdfBuilder:
    def __init__(self):
        self.objects: list[bytes | None] = [None]   # 1-indexed

    def add(self, body: bytes) -> int:
        self.objects.append(body)
        return len(self.objects) - 1

    def reserve(self) -> int:
        self.objects.append(b"")
        return len(self.objects) - 1

    def set(self, num: int, body: bytes) -> None:
        self.objects[num] = body

    def tobytes(self) -> bytes:
        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0] * len(self.objects)
        for i, body in enumerate(self.objects):
            if i == 0:
                continue
            offsets[i] = len(out)
            out += f"{i} 0 obj\n".encode()
            out += body
            out += b"\nendobj\n"
        xref_at = len(out)
        n = len(self.objects)
        out += f"xref\n0 {n}\n".encode()
        out += b"0000000000 65535 f \n"
        for i in range(1, n):
            out += f"{offsets[i]:010d} 00000 n \n".encode()
        out += (f"trailer\n<< /Size {n} /Root 1 0 R >>\n"
                f"startxref\n{xref_at}\nstartxref_end"
                ).encode().replace(b"startxref_end", b"%%EOF\n")
        return bytes(out)


def write_pdf(scene: AnnotationScene, out_filename: str) -> None:
    w_pt, h_pt = scene.page_w_pt, scene.page_h_pt

    def to_pdf(x_px: float, y_px: float) -> tuple[float, float]:
        return x_px * SCALE, h_pt - y_px * SCALE

    b = _PdfBuilder()
    catalog = b.reserve()    # 1
    pages = b.reserve()      # 2
    page = b.reserve()       # 3

    # Image XObject: raw RGB rows, Flate-compressed.
    img = np.ascontiguousarray(scene.image_rgb, dtype=np.uint8)
    ih, iw = img.shape[:2]
    data = zlib.compress(img.tobytes(), 6)
    img_obj = b.add(
        (f"<< /Type /XObject /Subtype /Image /Width {iw} /Height {ih} "
         f"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /FlateDecode "
         f"/Length {len(data)} >>\nstream\n").encode()
        + data + b"\nendstream")

    font_obj = b.add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
                     b"/Encoding /WinAnsiEncoding >>")

    # Content stream ------------------------------------------------------
    c = []
    # panorama: unit image square scaled to full width, top-aligned
    c.append(f"q {iw * SCALE:.4f} 0 0 {ih * SCALE:.4f} 0 "
             f"{h_pt - ih * SCALE:.4f} cm /Im0 Do Q")
    for ln in scene.lines:
        x0, y0 = to_pdf(ln.x0, ln.y0)
        x1, y1 = to_pdf(ln.x1, ln.y1)
        r, g, bl = ln.color
        c.append(f"{r:.3f} {g:.3f} {bl:.3f} RG {ln.width * SCALE:.3f} w "
                 f"{x0:.2f} {y0:.2f} m {x1:.2f} {y1:.2f} l S")
    text_chunks = []
    for t in scene.texts:
        x = t.x - (string_width(t.s, t.size) / 2.0 if t.centered else 0.0)
        xp, yp = to_pdf(x, t.y_baseline)
        r, g, bl = t.color
        text_chunks.append(
            f"BT /F1 {t.size * SCALE:.3f} Tf {r:.3f} {g:.3f} {bl:.3f} rg "
            f"{xp:.2f} {yp:.2f} Td (".encode()
            + _esc(t.s) + b") Tj ET")
    content = ("\n".join(c) + "\n").encode() + b"\n".join(text_chunks)
    content_z = zlib.compress(content, 6)
    content_obj = b.add(
        f"<< /Length {len(content_z)} /Filter /FlateDecode >>\nstream\n"
        .encode() + content_z + b"\nendstream")

    # Link annotations ----------------------------------------------------
    annot_refs = []
    for lr in scene.link_rects:
        x0, y1 = to_pdf(lr.x, lr.y)
        x1, y0 = to_pdf(lr.x + lr.w, lr.y + lr.h)
        a = b.add((f"<< /Type /Annot /Subtype /Link "
                   f"/Rect [{x0:.2f} {y0:.2f} {x1:.2f} {y1:.2f}] "
                   f"/Border [0 0 0] "
                   f"/A << /S /URI /URI (").encode()
                  + _esc(lr.url) + b") >> >>")
        annot_refs.append(f"{a} 0 R")
    for t in scene.texts:
        if t.url is None:
            continue
        wtxt = string_width(t.s, t.size)
        x_left = t.x - (wtxt / 2.0 if t.centered else 0.0)
        x0, y0 = to_pdf(x_left, t.y_baseline)
        x1, y1 = to_pdf(x_left + wtxt, t.y_baseline - t.size)
        a = b.add((f"<< /Type /Annot /Subtype /Link "
                   f"/Rect [{x0:.2f} {y0:.2f} {x1:.2f} {y1:.2f}] "
                   f"/Border [0 0 0] "
                   f"/A << /S /URI /URI (").encode()
                  + _esc(t.url) + b") >> >>")
        annot_refs.append(f"{a} 0 R")

    annots = (" /Annots [" + " ".join(annot_refs) + "]") if annot_refs else ""
    b.set(catalog, f"<< /Type /Catalog /Pages {pages} 0 R >>".encode())
    b.set(pages, f"<< /Type /Pages /Kids [{page} 0 R] /Count 1 >>".encode())
    b.set(page, (f"<< /Type /Page /Parent {pages} 0 R "
                 f"/MediaBox [0 0 {w_pt:.2f} {h_pt:.2f}] "
                 f"/Resources << /XObject << /Im0 {img_obj} 0 R >> "
                 f"/Font << /F1 {font_obj} 0 R >> >> "
                 f"/Contents {content_obj} 0 R{annots} >>").encode())

    with open(out_filename, "wb") as f:
        f.write(b.tobytes())
