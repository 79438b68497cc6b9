"""settings.xml persistence (florb orb_settings parity) + GPX parsing."""

import os

from horizonator_jax.settings import Settings, DEFAULTS
from horizonator_jax.gpx import load_gpx


def test_settings_defaults_and_roundtrip(tmp_path):
    p = str(tmp_path / "settings.xml")
    s = Settings(p)
    assert s.get("osm::tileserver") == DEFAULTS["osm::tileserver"]
    assert s.get("osm::zoommax", type=int) == 18
    s.set("osm::tileserver", "https://example.com/tiles/")
    s.set("viewer::last_lat", 34.2884)
    s.save()
    assert os.path.exists(p)

    s2 = Settings(p)
    assert s2.get("osm::tileserver") == "https://example.com/tiles/"
    assert abs(s2.get("viewer::last_lat", type=float) - 34.2884) < 1e-9
    # unknown keys fall back
    assert s2.get("nope", default="d") == "d"
    assert s2.get("osm::zoommin", type=int) == 0


def test_settings_bad_file_ignored(tmp_path):
    p = tmp_path / "settings.xml"
    p.write_text("<not-even-xml")
    s = Settings(str(p))
    assert s.get("osm::zoommax", type=int) == 18


GPX = """<?xml version="1.0"?>
<gpx xmlns="http://www.topografix.com/GPX/1/1" version="1.1">
 <trk><name>t</name>
  <trkseg>
   <trkpt lat="34.1" lon="-117.5"><ele>1000</ele></trkpt>
   <trkpt lat="34.2" lon="-117.6"/>
   <trkpt lat="34.3" lon="-117.7"/>
  </trkseg>
  <trkseg>
   <trkpt lat="35.0" lon="-118.0"/>
   <trkpt lat="35.1" lon="-118.1"/>
  </trkseg>
 </trk>
 <rte>
  <rtept lat="33.0" lon="-117.0"/>
  <rtept lat="33.1" lon="-117.1"/>
 </rte>
</gpx>
"""


def test_gpx_tracks_and_routes(tmp_path):
    p = tmp_path / "t.gpx"
    p.write_text(GPX)
    segs = load_gpx(str(p))
    assert len(segs) == 3
    assert segs[0][0] == (34.1, -117.5)
    assert len(segs[0]) == 3 and len(segs[1]) == 2 and len(segs[2]) == 2
