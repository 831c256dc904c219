"""Suite runner smoke test (rose only — CPU-friendly)."""

import math

from pngloss_jax.metrics import psnr_rgba
from pngloss_jax.suite import run_suite


def test_run_suite_rose(oracle, suite_dir, tmp_path):
    results, summary = run_suite(
        [f"{suite_dir}/rose.png"], [19, 0], oracle=oracle,
        out_dir=str(tmp_path), verbose=False)
    assert summary["all_byte_identical"]
    assert summary["files"] == 1
    by_s = {r["strength"]: r for r in results}
    assert by_s[0]["psnr_db"] == "inf"       # -s 0 is pixel-lossless
    assert by_s[19]["out_bytes"] < by_s[19]["in_bytes"]
    assert (tmp_path / "rose-s19.png").exists()


def test_psnr():
    import numpy as np
    a = np.zeros((4, 4, 4), np.uint8)
    assert psnr_rgba(a, a) == math.inf
    b = a.copy()
    b[0, 0, 0] = 255
    assert 0 < psnr_rgba(a, b) < 100
