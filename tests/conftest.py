"""Test configuration.

Tests run JAX on a virtual 8-device CPU mesh, so sharding logic is exercised
without a card. A program that already runs JAX on its devices before it
starts pytest in-process (chip_smoke.py on the GPU) keeps them; tests that
need the card are marked `gpu` and skip elsewhere through the `gpu` fixture.
"""

import os
import shutil
import subprocess
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
from jax._src import xla_bridge  # noqa: E402

if not xla_bridge.backends_are_initialized():
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

# a compiled reference C tool (foobaz/pngloss) for byte-parity tests, built
# from its sources when PNGLOSS_REFERENCE_SRC names them
REFERENCE_SRC = os.environ.get("PNGLOSS_REFERENCE_SRC", "")
ORACLE_BIN = os.environ.get("PNGLOSS_ORACLE", "")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; runs on the card through chip_smoke.py")


def _build_oracle(tmp_dir) -> str | None:
    """The reference C tool to serve as the byte-level parity oracle:
    PNGLOSS_ORACLE, or a build of PNGLOSS_REFERENCE_SRC."""
    if ORACLE_BIN and os.path.exists(ORACLE_BIN):
        return ORACLE_BIN
    if not os.path.isdir(REFERENCE_SRC) or not shutil.which("gcc"):
        return None
    out = os.path.join(str(tmp_dir), "pngloss")
    srcs = [
        os.path.join(REFERENCE_SRC, f)
        for f in os.listdir(REFERENCE_SRC)
        if f.endswith(".c")
    ]
    try:
        subprocess.run(
            ["gcc", "-O2", "-o", out, *srcs, "-lpng", "-lz", "-lm"],
            check=True, capture_output=True, timeout=120,
        )
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    return out


@pytest.fixture(scope="session")
def oracle(tmp_path_factory):
    """Path to the compiled reference pngloss binary, or skip."""
    path = _build_oracle(tmp_path_factory.mktemp("oracle"))
    if path is None:
        pytest.skip("reference oracle unavailable (set PNGLOSS_ORACLE)")
    return path


@pytest.fixture(scope="session")
def suite_dir(tmp_path_factory):
    """A directory holding the seeded stand-ins for the reference suite's
    eleven images (pngloss_jax.corpus)."""
    from pngloss_jax import corpus

    path = str(tmp_path_factory.mktemp("suite"))
    corpus.write_suite(path)
    return path


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run on the card through chip_smoke.py")


def run_oracle(oracle_bin, png_bytes: bytes, strength: int, bleed: int = 2,
               strip: bool = False, tmp_path=None, extra_args=()) -> bytes:
    """Run the C tool on png_bytes via stdin/stdout and return output bytes."""
    args = [oracle_bin, "-f", "-s", str(strength), "-b", str(bleed)]
    if strip:
        args.append("--strip")
    args += list(extra_args)
    args.append("-")
    proc = subprocess.run(args, input=png_bytes, capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr.decode(errors="replace")
    return proc.stdout
