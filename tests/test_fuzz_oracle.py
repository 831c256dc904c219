"""Randomized end-to-end byte parity vs the C tool (fixed seed, bounded).

Each case builds a valid PNG with our encoder (itself byte-parity-tested),
runs it through the CLI and through the reference binary with random
parameters, and requires byte-identical output.
"""

import io
import os

import numpy as np
import pytest

from pngloss_jax.cli import run
from pngloss_jax.codec import encode
from tests.conftest import run_oracle


def _random_rgba(rng):
    kind = rng.choice(["gray", "gray_alpha", "rgb", "rgba", "flat", "noisy"])
    h = int(rng.integers(1, 12))
    w = int(rng.integers(1, 12))
    if kind == "flat":
        rgba = np.full((h, w, 4), int(rng.integers(0, 256)), np.uint8)
        rgba[:, :, 3] = 255
        return rgba
    rgba = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    if kind in ("gray", "gray_alpha"):
        rgba[:, :, 0] = rgba[:, :, 2] = rgba[:, :, 1]
    if kind in ("gray", "rgb", "noisy"):
        rgba[:, :, 3] = 255
    if kind in ("gray_alpha", "rgba") and rng.random() < 0.5:
        rgba[:: 2, :, 3] = 0  # exercise the transparent-pixel rule
    return rgba


@pytest.mark.skipif(
    os.environ.get("PNGLOSS_TEST_FUZZ_FULL") != "1",
    reason="set PNGLOSS_TEST_FUZZ_FULL=1 for the full randomized fuzz loop")
def test_fuzz_loop_full_domain(oracle, tmp_path):
    """The committed form of BASELINE.md's overnight fuzz evidence:
    tools/fuzz_loop.py over randomized 1-128px images, all colorspaces,
    the full 0-255 strength domain, subprocess-cycled workers. Scale with
    PNGLOSS_FUZZ_CASES (default 512; the overnight run used ~12,500)."""
    import subprocess
    import sys

    cases = int(os.environ.get("PNGLOSS_FUZZ_CASES", "512"))
    out = tmp_path / "fuzz.jsonl"
    r = subprocess.run(
        [sys.executable, "tools/fuzz_loop.py", "--total", str(cases),
         "--out", str(out), "--oracle", oracle, "--seed", "7000"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    lines = out.read_text().splitlines()
    assert r.returncode == 0
    assert len(lines) >= cases
    assert all('"byte_identical": true' in ln for ln in lines)


@pytest.mark.parametrize("seed", range(12))
def test_random_roundtrip_matches_oracle(oracle, seed):
    rng = np.random.default_rng(1000 + seed)
    rgba = _random_rgba(rng)
    png = encode(rgba, row_filters=None)
    strength = int(rng.integers(0, 90))
    bleed = int(rng.choice([1, 2, 3, 17, 32767]))
    out = io.BytesIO()
    rc = run(["-f", "-s", str(strength), "-b", str(bleed), "-"],
             stdin=io.BytesIO(png), stdout=out)
    ref = run_oracle(oracle, png, strength, bleed)
    assert rc == 0
    assert out.getvalue() == ref, (seed, rgba.shape, strength, bleed)
