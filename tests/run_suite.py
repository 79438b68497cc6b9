"""Resilient full-suite runner: pytest in a few sequential process groups.

Why not one `pytest tests/`: this environment's XLA:CPU executable
(de)serializer intermittently crashes the process natively (SIGSEGV in
deserialize, SIGABRT in serialize) while persisting large compile-cache
entries -- observed only on COLD caches, where a single-process run does
hundreds of big puts. The atomic-put hardening (compile_cache.py)
eliminated the torn-entry class; this runner contains the remaining
native-flakiness class: a crash loses only its group, and the rerun
resumes from the persistent cache (which keeps everything the crashed
group DID write), so a cold suite converges in at most a couple of
invocations instead of restarting from zero.

Groups are balanced by measured runtime (1-core box); each runs in its
own process with the shared hardened cache.

    python tests/run_suite.py [-m "not slow"] [extra pytest args...]
"""

import subprocess
import sys
import time

GROUPS = [
    # heavy Pallas/interpret + fuzz
    ["tests/test_window.py", "tests/test_resolve.py", "tests/test_lod.py"],
    # render core + API
    ["tests/test_render.py", "tests/test_api.py", "tests/test_api_lod.py",
     "tests/test_crossing.py", "tests/test_curvature.py"],
    # parallel/regions + golden CLI subprocesses
    ["tests/test_regions.py", "tests/test_parallel.py",
     "tests/test_golden.py", "tests/test_mesh.py", "tests/test_paging.py"],
    # GIS ops + everything else
    ["tests/test_viewshed.py", "tests/test_viewshed_contract.py",
     "tests/test_shadows.py", "tests/test_los.py", "tests/test_skyline.py",
     "tests/test_geotiff.py", "tests/test_annotate.py", "tests/test_dem.py",
     "tests/test_geometry.py", "tests/test_native.py",
     "tests/test_settings_gpx.py", "tests/test_tiles.py",
     "tests/test_viewer.py", "tests/test_chip_smoke.py"],
]


def main() -> int:
    extra = sys.argv[1:]
    rc_total = 0
    t0 = time.time()
    for i, group in enumerate(GROUPS):
        t = time.time()
        print(f"=== group {i + 1}/{len(GROUPS)}: {len(group)} files",
              flush=True)
        rc = subprocess.call([sys.executable, "-m", "pytest", "-q",
                              "--durations=10", "--durations-min=5.0",
                              *extra, *group])
        print(f"=== group {i + 1} exit {rc} "
              f"({time.time() - t:.0f} s)", flush=True)
        if rc not in (0, 5):                 # 5 = no tests collected
            rc_total = rc
    print(f"=== total {time.time() - t0:.0f} s, exit {rc_total}",
          flush=True)
    return rc_total


if __name__ == "__main__":
    sys.exit(main())
