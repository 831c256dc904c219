"""CLI parity vs the reference tool: bytes, exit codes, naming, guards."""

import io
import os
import subprocess

import pytest

from pngloss_jax.cli import (
    INVALID_ARGUMENT,
    MISSING_ARGUMENT,
    NOT_OVERWRITING_ERROR,
    READ_ERROR,
    SUCCESS,
    TOO_LARGE_FILE,
    add_filename_extension,
    run,
)

@pytest.fixture(scope="module")
def rose_path(suite_dir):
    return f"{suite_dir}/rose.png"


@pytest.fixture(scope="module")
def rose_bytes(rose_path):
    with open(rose_path, "rb") as f:
        return f.read()


def _run_ours(args, stdin=b""):
    out = io.BytesIO()
    rc = run(args, stdin=io.BytesIO(stdin), stdout=out)
    return rc, out.getvalue()


@pytest.mark.parametrize("strength", [19, 0])
def test_stdin_stdout_byte_parity(oracle, rose_bytes, strength):
    rc, out = _run_ours(["-f", "-s", str(strength), "-b", "2", "-"], rose_bytes)
    ref = subprocess.run(
        [oracle, "-f", "-s", str(strength), "-b", "2", "-"],
        input=rose_bytes, capture_output=True)
    assert rc == ref.returncode == 0
    assert out == ref.stdout


def test_output_file_and_overwrite_guard(oracle, rose_bytes, rose_path,
                                        tmp_path):
    outp = tmp_path / "rose-out.png"
    rc, _ = _run_ours(["-s", "19", "-o", str(outp), rose_path])
    assert rc == SUCCESS
    ref = subprocess.run([oracle, "-f", "-s", "19", "-b", "2", "-"],
                         input=rose_bytes, capture_output=True).stdout
    assert outp.read_bytes() == ref
    # second run without -f must refuse (pngloss.c:184-187)
    rc, _ = _run_ours(["-s", "19", "-o", str(outp), rose_path])
    assert rc == NOT_OVERWRITING_ERROR
    # --no-force after -f restores the guard
    rc, _ = _run_ours(["-f", "--no-force", "-s", "19", "-o", str(outp),
                       rose_path])
    assert rc == NOT_OVERWRITING_ERROR


def test_default_extension_naming(tmp_path, rose_bytes):
    src = tmp_path / "img.png"
    src.write_bytes(rose_bytes)
    rc, _ = _run_ours(["-f", "-s", "19", str(src)])
    assert rc == SUCCESS
    assert (tmp_path / "img-loss.png").exists()
    rc, _ = _run_ours(["-f", "-s", "19", "--ext", "_x.png", str(src)])
    assert (tmp_path / "img_x.png").exists()


def test_add_filename_extension():
    assert add_filename_extension("a.png", "-loss.png") == "a-loss.png"
    assert add_filename_extension("a.jpg", "-loss.png") == "a.jpg-loss.png"
    assert add_filename_extension("noext", "-loss.png") == "noext-loss.png"


def test_skip_if_larger_exit_code(oracle, rose_bytes):
    # at -s 0 the output cannot beat size-1 of an already optimal file
    rc, out = _run_ours(["-f", "-s", "0", "--skip-if-larger", "-"], rose_bytes)
    ref = subprocess.run([oracle, "-f", "-s", "0", "--skip-if-larger", "-"],
                         input=rose_bytes, capture_output=True)
    assert rc == ref.returncode == TOO_LARGE_FILE
    # stdout fallback: both write the original 24-bit image (pngloss.c:290-297)
    assert out == ref.stdout


def test_error_exit_codes(tmp_path):
    assert _run_ours(["-s", "300", "-o", str(tmp_path / "x.png"), "a.png"])[0] == INVALID_ARGUMENT
    assert _run_ours(["-b", "0", "-o", str(tmp_path / "x.png"), "a.png"])[0] == INVALID_ARGUMENT
    assert _run_ours(["--ext", "x", "-o", "y", "a.png"])[0] == INVALID_ARGUMENT
    assert _run_ours(["-o", "x", "a.png", "b.png"])[0] == INVALID_ARGUMENT
    assert _run_ours([])[0] == MISSING_ARGUMENT
    assert _run_ours(["-v"])[0] == MISSING_ARGUMENT
    assert _run_ours(["-V"])[0] == SUCCESS
    assert _run_ours(["-h"])[0] == SUCCESS
    rc, _ = _run_ours(["-f", str(tmp_path / "missing.png")])
    assert rc == READ_ERROR


def test_not_a_png_is_libpng_fatal_error(tmp_path, capsys):
    # the reference reports decode failures as LIBPNG_FATAL_ERROR (25) with
    # the libpng message plus the cannot-decode line (pngloss.c:453)
    from pngloss_jax.cli import LIBPNG_FATAL_ERROR

    bad = tmp_path / "bad.png"
    bad.write_bytes(b"this is not a png")
    assert _run_ours(["-f", str(bad)])[0] == LIBPNG_FATAL_ERROR
    err = capsys.readouterr().err
    assert "  error: Not a PNG file (libpng failed)" in err
    assert "  error: cannot decode image bad.png" in err


def test_multi_file_batched_mode(oracle, rose_bytes, tmp_path):
    for n in ("a", "b", "c"):
        (tmp_path / f"{n}.png").write_bytes(rose_bytes)
    paths = [str(tmp_path / f"{n}.png") for n in ("a", "b", "c")]
    rc, _ = _run_ours(["-f", "-s", "19", *paths])
    assert rc == SUCCESS
    ref = subprocess.run([oracle, "-f", "-s", "19", "-b", "2", "-"],
                         input=rose_bytes, capture_output=True).stdout
    for n in ("a", "b", "c"):
        assert (tmp_path / f"{n}-loss.png").read_bytes() == ref
    # mixed errors: one missing file, one guard, one ok
    rc, _ = _run_ours(["-s", "19", str(tmp_path / "a.png"),
                       str(tmp_path / "missing.png")])
    assert rc == NOT_OVERWRITING_ERROR or rc == READ_ERROR


def test_verbose_stderr_parity(oracle, rose_bytes, capsys):
    """Full -v stderr matches the C tool line for line, spinner aside
    (pngloss.c:238-254, pngloss_image.c:310-325). Pins the vectorized
    unique_symbol_count and the 'writing compressed image' line."""
    rc, _ = _run_ours(["-fv", "-s", "19", "-b", "2", "-"], rose_bytes)
    assert rc == SUCCESS
    ours = [ln for ln in capsys.readouterr().err.splitlines()
            if "pngloss-jax" not in ln]    # version header lines, ours only
    ref = subprocess.run([oracle, "-fv", "-s", "19", "-b", "2", "-"],
                         input=rose_bytes, capture_output=True)
    theirs = []
    for ln in ref.stderr.decode().splitlines():
        # the per-row spinner redraws in place with ESC[\x01G
        # (pngloss_image.c:214-237); keep only the final segment
        theirs.append(ln.rsplit("\x1b[\x01G", 1)[-1])
    assert ours == theirs
