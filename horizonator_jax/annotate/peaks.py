"""Fetch peak POIs from the OSM Overpass API.

Feature port of query-peaks-from-osm.py (reference): query ``natural=peak``
nodes within a radius, with the same name fallback chain
(``name:en`` -> ``name`` -> ``name:th`` -> ``"<ele>m"``,
query-peaks-from-osm.py:73-83). Output is JSON POI records (the format
``--pois`` consumes) or the reference's C-initializer lines for drop-in use
with the original tool.

Usage:
    python -m horizonator_jax.annotate.peaks LAT LON RADIUS_M [--format c]
"""

from __future__ import annotations

import json
import sys

OVERPASS_URL = "http://overpass-api.de/api/interpreter"


def overpass_query(lat: float, lon: float, radius_m: float) -> str:
    """The Overpass QL query (query-peaks-from-osm.py:45-56 behavior)."""
    return f"""
[out:json];
node
  [natural=peak]
  (around:{radius_m:f},{lat:f},{lon:f});
out body;
"""


def peak_name(tags: dict, ele: float) -> str:
    """Name fallback chain (query-peaks-from-osm.py:73-83)."""
    for key in ("name:en", "name", "name:th"):
        if tags.get(key):
            return tags[key]
    return f"{ele:.0f}m"


def parse_elements(elements: list[dict]) -> list[dict]:
    """Overpass node elements -> POI dicts; nodes without an elevation tag
    are skipped (the reference indexes tags['ele'] unconditionally and would
    die; we drop them instead)."""
    out = []
    for el in elements:
        tags = el.get("tags", {})
        try:
            ele = float(tags["ele"])
        except (KeyError, ValueError):
            continue
        out.append({"name": peak_name(tags, ele),
                    "lat": float(el["lat"]), "lon": float(el["lon"]),
                    "ele_m": ele})
    return out


def fetch_peaks(lat: float, lon: float, radius_m: float,
                url: str = OVERPASS_URL) -> list[dict]:
    import requests
    r = requests.post(url, data={"data": overpass_query(lat, lon, radius_m)},
                      timeout=120)
    r.raise_for_status()
    return parse_elements(r.json().get("elements", []))


def to_c_initializers(pois: list[dict]) -> str:
    """The reference's output format (query-peaks-from-osm.py:104): lines
    suitable for #include into a poi_t array."""
    return "\n".join(
        f'{{ "{p["name"]}", {p["lat"]:f}, {p["lon"]:f}, {p["ele_m"]:f} }},'
        for p in pois)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    fmt = "json"
    if "--format" in args:
        i = args.index("--format")
        fmt = args[i + 1]
        del args[i:i + 2]
    if len(args) != 3:
        print("usage: peaks.py LAT LON RADIUS_M [--format json|c]",
              file=sys.stderr)
        return 1
    lat, lon, radius = float(args[0]), float(args[1]), float(args[2])
    pois = fetch_peaks(lat, lon, radius)
    if fmt == "c":
        print(to_c_initializers(pois))
    else:
        print(json.dumps(pois, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
