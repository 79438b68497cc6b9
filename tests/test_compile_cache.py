"""compile_cache hardening: era sweep + corrupt-entry-tolerant gets.

VERDICT r4 weak #5: stale zstd-era or torn entries in an existing cache dir
used to crash native consumers on read, and the documented remedy was a
manual wipe-and-bump of the dir suffix. harden_cache(cache_dir) now sweeps
incompatible entries up front, and any corrupt entry that appears mid-run
degrades to a cache miss (one recompile) instead of a crash.
"""

import os
import subprocess
import sys
import zlib

import pytest

from horizonator_jax.compile_cache import sweep_cache_dir, _entry_is_foreign


def test_entry_header_classifier():
    # valid zlib streams (any level) are kept
    for level in (1, 6, 9):
        assert not _entry_is_foreign(zlib.compress(b"payload", level)[:4])
    # zstd frame magic, empty, truncated, garbage are foreign
    assert _entry_is_foreign(b"\x28\xb5\x2f\xfd\x00\x00")
    assert _entry_is_foreign(b"")
    assert _entry_is_foreign(b"\x78")
    assert _entry_is_foreign(b"\xff\xff\xff\xff")


def test_sweep_cache_dir(tmp_path):
    good = tmp_path / "good-cache"
    good.write_bytes(zlib.compress(b"x" * 100))
    torn = tmp_path / "torn-cache"
    torn.write_bytes(b"")
    zstd = tmp_path / "zstd-cache"
    zstd.write_bytes(b"\x28\xb5\x2f\xfd" + b"\x00" * 32)
    garbage = tmp_path / "garbage-cache"
    garbage.write_bytes(os.urandom(64)[:1] + b"\x00" + os.urandom(62))
    stale_tmp = tmp_path / "k-cache.tmp.999.ab"
    stale_tmp.write_bytes(b"partial")
    os.utime(stale_tmp, (0, 0))                      # ancient mtime
    fresh_tmp = tmp_path / "k2-cache.tmp.1000.cd"
    fresh_tmp.write_bytes(b"inflight")               # a live writer's file
    other = tmp_path / "notes.txt"
    other.write_bytes(b"unrelated")

    with pytest.warns(UserWarning, match="incompatible/corrupt"):
        removed = sweep_cache_dir(tmp_path)
    # garbage-cache MAY survive if its random header happens to be valid
    # zlib (probability ~1/8000); everything else is deterministic
    assert removed >= 3
    assert good.exists() and fresh_tmp.exists() and other.exists()
    assert not torn.exists() and not zstd.exists() and not stale_tmp.exists()
    # idempotent + missing dir is a no-op
    assert sweep_cache_dir(tmp_path / "nope") == 0


@pytest.mark.slow
def test_corrupt_entry_degrades_to_miss(tmp_path):
    """End-to-end: a cache entry corrupted AFTER the sweep (mid-run tear)
    must cost one recompile, not a crash. Two subprocesses share a cache
    dir; the entries are torn in between."""
    cache = tmp_path / "cache"
    cache.mkdir()
    prog = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from horizonator_jax.compile_cache import harden_cache\n"
        f"harden_cache({str(cache)!r})\n"
        f"jax.config.update('jax_compilation_cache_dir', {str(cache)!r})\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
        " 0.0)\n"
        "import jax.numpy as jnp\n"
        "x = jax.jit(lambda a: jnp.sin(a) @ a.T)("
        "jnp.ones((257, 129))).block_until_ready()\n"
        "print('OK', float(x[0, 0]))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH="/root/repo", XLA_FLAGS="")
    r1 = subprocess.run([sys.executable, "-c", prog], env=env,
                        capture_output=True, text=True, timeout=300)
    assert r1.returncode == 0, r1.stderr
    entries = list(cache.glob("*-cache"))
    assert entries, "first run wrote no cache entry"
    for e in entries:                    # tear every entry mid-byte
        b = e.read_bytes()
        e.write_bytes(b[: max(1, len(b) // 2)])
    r2 = subprocess.run([sys.executable, "-c", prog], env=env,
                        capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr
    assert "OK" in r2.stdout
    assert "dropping unreadable compile-cache entry" in r2.stderr
