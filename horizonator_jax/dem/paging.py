"""HBM window paging: fly-throughs over terrain larger than device memory.

BASELINE.md config 4 calls for "incremental HBM tile paging": a camera
path can cross far more terrain than one chip wants resident (a continent
of SRTM1 is ~100 GB). This module keeps a fixed-shape square window of the
host-side mosaic resident in HBM and re-centers it only when the viewer
leaves a guard margin:

- fixed window shape => ONE compiled render executable for the whole
  flight (re-centering changes data + the viewer's window-relative cell
  coords, never shapes);
- `jax.device_put(..., donate=...)`-free simplicity: the window upload is
  host->device of window_cells^2 * 4 bytes (e.g. 2048^2 = 16 MB) and
  happens only every `margin_cells` of travel -- at 60 FPS and 100 m/frame
  that is one upload per ~1.5 minutes of flight;
- renders between re-centers are pure device work; the returned
  RenderParams are always window-relative.

The host side holds the full mosaic as a numpy array (mmap-backed .hgt
decoding happens once in load_mosaic); this is the device-resident analog of
the reference's "load a radius around the viewer at init" (dem.c:106-127)
made incremental.
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp


class PagedWindow:
    """A device-resident square window over a big host elevation grid."""

    def __init__(self, host_grid: np.ndarray, window_cells: int = 2048,
                 margin_cells: int = 256, device=None):
        if window_cells > min(host_grid.shape):
            window_cells = min(host_grid.shape)
        self.host = host_grid
        self.wc = int(window_cells)
        self.margin = int(margin_cells)
        self.device = device
        self.origin = (-(10 ** 9), -(10 ** 9))   # (j0, i0), forces first load
        self.dem = None
        self.uploads = 0

    def _load(self, j0: int, i0: int):
        nj, ni = self.host.shape
        j0 = max(0, min(j0, nj - self.wc))
        i0 = max(0, min(i0, ni - self.wc))
        if self.dem is not None and (j0, i0) == self.origin:
            # viewer hugging a host-grid edge: the clamped origin cannot
            # move, so re-sending the identical block would only burn
            # host->HBM bandwidth every segment
            return
        self.origin = (j0, i0)
        block = np.ascontiguousarray(
            self.host[j0:j0 + self.wc, i0:i0 + self.wc], np.float32)
        self.dem = jax.device_put(jnp.asarray(block), self.device)
        self.uploads += 1

    def ensure(self, viewer_cell_i: float, viewer_cell_j: float) -> None:
        """Re-center the window if the viewer (host-grid cell coords) is
        within ``margin`` of its edge (or it is not loaded yet)."""
        j0, i0 = self.origin
        m = self.margin
        inside = (viewer_cell_j - j0 >= m and viewer_cell_i - i0 >= m
                  and j0 + self.wc - viewer_cell_j >= m
                  and i0 + self.wc - viewer_cell_i >= m)
        if self.dem is None or not inside:
            self._load(int(viewer_cell_j) - self.wc // 2,
                       int(viewer_cell_i) - self.wc // 2)

    def local_cell(self, viewer_cell_i: float, viewer_cell_j: float):
        """Host-grid -> window-relative viewer cell coords."""
        j0, i0 = self.origin
        return viewer_cell_i - i0, viewer_cell_j - j0


def fly(host_grid, path_cells, *, width, height, zfar_m, cells_per_deg,
        lat_deg, window_cells=2048, margin_cells=256, znear_m=100.0,
        az_deg=(-60.0, 60.0), chunk=16, viewer_agl_m=50.0):
    """Fly a camera path over a big host grid with HBM window paging.

    path_cells: (F, 2) host-grid (i, j) viewer positions. Renders in
    ``chunk``-frame single-dispatch segments (render_path); the window
    re-centers between segments when needed. Returns (images (F,H,W,3),
    ranges (F,H,W), uploads) with uploads = number of HBM window loads.
    """
    from ..render.crossing import k_cross_for
    from ..parallel import stack_params
    from ..parallel.sharding import render_path
    from ..render.raymarch import RenderParams

    win = PagedWindow(host_grid, window_cells, margin_cells)
    k = k_cross_for(zfar_m, cells_per_deg, lat_deg, n=win.wc)
    f = jnp.float32
    cos_lat = math.cos(math.radians(lat_deg))

    imgs = []
    rngs = []
    path = np.asarray(path_cells, np.float64)
    npad = -(-len(path) // chunk) * chunk
    path_p = np.concatenate([path, np.repeat(path[-1:], npad - len(path), 0)])
    for s in range(0, npad, chunk):
        seg = path_p[s:s + chunk]
        # one window covers the whole segment (re-center on its middle);
        # fail LOUDLY if a fast path outruns the window instead of
        # rendering from a viewer cell off the resident grid
        mid = seg[len(seg) // 2]
        win.ensure(mid[0], mid[1])
        # fail LOUDLY if the segment outran the resident window (a fast
        # path + small window/margin): rendering from a viewer cell off
        # the window would be silently wrong. Checked POST-ensure against
        # the actual window bounds, so whole-grid-resident windows and
        # freshly re-centered ones never false-positive.
        j0w, i0w = win.origin
        ci_lo, cj_lo = seg.min(axis=0)
        ci_hi, cj_hi = seg.max(axis=0)
        if (ci_lo < i0w or cj_lo < j0w or ci_hi > i0w + win.wc - 1
                or cj_hi > j0w + win.wc - 1):
            raise ValueError(
                f"path segment [{ci_lo:.0f}..{ci_hi:.0f}] x "
                f"[{cj_lo:.0f}..{cj_hi:.0f}] leaves the resident "
                f"{win.wc}-cell window at ({i0w}, {j0w}): lower chunk= "
                f"or raise window_cells=/margin_cells=")
        ps = []
        for (ci, cj) in seg:
            li, lj = win.local_cell(ci, cj)
            # auto elevation: ground at the viewer + AGL margin. floor +
            # clamp: int() truncates toward zero (wrong cell for a
            # fractionally-negative local coord), and a path point at the
            # host grid's edge would slice zero rows (np.max raises on an
            # empty array) -- clamp to the last full 2x2 stencil instead.
            nj_h, ni_h = win.host.shape
            j0i = min(max(int(math.floor(lj)) + win.origin[0], 0), nj_h - 2)
            i0i = min(max(int(math.floor(li)) + win.origin[1], 0), ni_h - 2)
            ground = float(np.max(win.host[j0i: j0i + 2, i0i: i0i + 2]))
            ps.append(RenderParams(
                f(li), f(lj), f(ground + viewer_agl_m), f(cos_lat),
                f(math.radians(az_deg[0])), f(math.radians(az_deg[1])),
                f(znear_m), f(zfar_m), f(znear_m), f(zfar_m)))
        out = render_path(win.dem, stack_params(ps), width=width,
                          height=height, nsteps=k,
                          cells_per_deg=cells_per_deg, sampler="window",
                          lat_hint_deg=lat_deg)
        imgs.append(np.asarray(out[0]))
        rngs.append(np.asarray(out[1]))
    images = np.concatenate(imgs)[:len(path)]
    ranges = np.concatenate(rngs)[:len(path)]
    return images, ranges, win.uploads
