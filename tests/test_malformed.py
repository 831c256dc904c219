"""Malformed-PNG regression tests (round-3 verdict items Weak #1-2).

The deterministic catalog in tools/malformed.py has one specimen per
malformed-input class; this test asserts, for every specimen:
  * neither codec crashes or leaks an untyped exception (the native codec
    previously SIGABRT'd the process on a 91-byte dimension bomb where the
    reference exits cleanly with code 24);
  * native and pypng agree on accept/reject, and on decoded pixels +
    metadata when both accept;
  * rejections carry the rwpng.h exit code the reference would use.
When the reference toolchain is available the oracle's accept/reject and
exit codes are asserted too (byte-level output parity over the whole
catalog is covered by tools/malformed_probe.py --pixels and the
--malformed fuzzer; see BASELINE.md).
"""

import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

from malformed import catalog, base_palette, with_chunk_at  # noqa: E402

from pngloss_jax.codec import native, pypng  # noqa: E402

CASES = catalog()


def _img_state(img):
    meta = (img.rgba.shape, round(img.gamma, 9), img.color_transform,
            [(c.name, c.data, c.location) for c in img.chunks])
    return hashlib.sha224(img.rgba.tobytes() + repr(meta).encode()).hexdigest()


def _decode(mod, data):
    """(accepted, state_or_error)."""
    try:
        return True, _img_state(mod.decode(data))
    except pypng.PngDecodeError as e:
        return False, int(getattr(e, "exit_code", 25))


@pytest.mark.parametrize("name,png", CASES, ids=[n for n, _ in CASES])
def test_codecs_agree(name, png):
    ok_py, res_py = _decode(pypng, png)
    if native.available():
        ok_nat, res_nat = _decode(native, png)
        assert ok_nat == ok_py, f"accept/reject split: native={ok_nat} pypng={ok_py}"
        assert res_nat == res_py, "decoded state (or exit code) differs"


def test_dimension_bomb_is_clean_exit_24():
    # round-3 verdict repro: 100000x100000 header previously escaped
    # std::bad_alloc through the ctypes boundary -> SIGABRT of the process
    bomb = dict(CASES)["dims_bomb_100k"]
    for mod in ([native] if native.available() else []) + [pypng]:
        with pytest.raises(pypng.PngDecodeError) as ei:
            mod.decode(bomb)
        assert ei.value.exit_code == 24


def test_trns_longer_than_palette_is_discarded():
    # round-3 verdict repro: libpng discards the malformed tRNS -> opaque;
    # the old native codec applied it (color-type-6 output, parity break)
    png = dict(CASES)["trns_longer_than_palette"]
    for mod in ([native] if native.available() else []) + [pypng]:
        img = mod.decode(png)
        assert np.all(img.rgba[:, :, 3] == 255)


def test_palette_index_oob_decodes_black():
    png = dict(CASES)["palette_index_oob"]
    img = pypng.decode(png)
    oob = img.rgba[(img.rgba[:, :, :3] == 0).all(axis=2)]
    assert len(oob) > 0  # indices 4..7 hit the calloc'd palette tail


def test_ancillary_crc_bad_chunk_is_kept():
    # unknown-path chunks are stored by rwpng's callback before libpng sees
    # the CRC result -> kept despite the error
    png = dict(CASES)["ancillary_crc_bad"]
    img = pypng.decode(png)
    assert any(c.name == b"tEXt" for c in img.chunks)


def test_strip_mode_rejects_unknown_critical():
    png = dict(CASES)["unknown_critical"]
    assert pypng.decode(png, strip=False)  # kept path accepts
    with pytest.raises(pypng.PngDecodeError):
        pypng.decode(png, strip=True)
    if native.available():
        with pytest.raises(pypng.PngDecodeError):
            native.decode(png, strip=True)


def test_kept_chunk_order_is_reversed():
    # round-4 fuzz repro (seed 97185): rwpng's read callback prepends each
    # kept chunk to a linked list, so the emitted order is the reverse of
    # the read order; we previously preserved input order (parity break)
    png = dict(CASES)["two_kept_chunks_before_idat"]
    for mod in ([native] if native.available() else []) + [pypng]:
        names = [c.name for c in mod.decode(png).chunks]
        assert names == [b"bbBb", b"aaAa"]


def test_kept_chunk_location_groups_split_at_plte():
    # round-4 fuzz repro (seed 33487): libpng normalises each unknown
    # chunk's location to the top-most mode bit (1 before any PLTE, 2
    # after), and writes the location-1 group before the location-2 group
    # (png_write_info's two write points).  A PLTE that is itself ignored
    # (grayscale, bad length) still sets the mode bit.
    png = dict(CASES)["text_straddles_plte"]
    for mod in ([native] if native.available() else []) + [pypng]:
        locs = [(c.data[1:2], c.location) for c in mod.decode(png).chunks]
        assert locs == [(b"b", 2), (b"a", 1)]  # list reversed, locations kept
    png = dict(CASES)["text_straddles_benign_rgb_plte"]
    for mod in ([native] if native.available() else []) + [pypng]:
        locs = [(c.data[1:2], c.location) for c in mod.decode(png).chunks]
        assert locs == [(b"b", 2), (b"a", 1)]


def test_ignored_plte_still_gates_colorspace_and_duplicates():
    # the PNG_HAVE_PLTE mode bit from an IGNORED gray PLTE makes a later
    # gAMA "out of place" (default gamma survives) and a second PLTE a
    # fatal duplicate — oracle-pinned in round 4
    png = dict(CASES)["gama_after_ignored_gray_plte"]
    for mod in ([native] if native.available() else []) + [pypng]:
        img = mod.decode(png)
        # the 0.25 gAMA must be ignored: default gamma state (which this
        # codec represents as gama_only/0.45455 — no gAMA chunk emitted)
        assert img.color_transform != pypng.COLOR_SRGB
        assert abs(img.gamma - 0.45455) < 1e-9
    png = dict(CASES)["plte_duplicate_after_ignored"]
    for mod in ([native] if native.available() else []) + [pypng]:
        with pytest.raises(pypng.PngDecodeError if mod is pypng
                           else native.PngDecodeError):
            mod.decode(png)


def test_header_time_dispatch_ordering():
    # round-4 review repros: libpng acts on a chunk's length+name BEFORE
    # reading its data or CRC, so (a) a bad-CRC gAMA between two IDATs
    # still ends the IDAT run ("Not enough image data", not a bridged
    # decode); (b) the rwpng.c:287-290 rowbytes guard fires at the first
    # IDAT header (exit 24) even when that IDAT's CRC is corrupt
    cases = dict(CASES)
    for mod in ([native] if native.available() else []) + [pypng]:
        with pytest.raises(pypng.PngDecodeError) as ei:
            mod.decode(cases["idat_run_split_by_bad_crc_gama"])
        assert "Not enough image data" in str(ei.value)
        with pytest.raises(pypng.PngDecodeError) as ei:
            mod.decode(cases["dims_bomb_bad_idat_crc"])
        assert ei.value.exit_code == 24


def test_strip_zero_length_text_bug_fires_before_crc():
    # round-4 review repro: the tEXt handler's zero-length read-past-EOF
    # bug-compat fires while reading chunk data, before the CRC check, so
    # a bad CRC doesn't rescue the chunk into the warn+discard path; and
    # without --strip the chunk takes the keep-callback path (no handler,
    # bad-CRC ancillary unknown-path chunks are kept) so it must decode
    png = dict(CASES)["text_empty_bad_crc_before_idat"]
    for mod in ([native] if native.available() else []) + [pypng]:
        with pytest.raises(pypng.PngDecodeError) as ei:
            mod.decode(png, strip=True)
        assert "Read error" in str(ei.value)
        mod.decode(png, strip=False)  # must accept


def test_zero_length_plte_is_fatal_for_color_types():
    # round-4 fuzz repro (seed 97193): libpng's png_set_PLTE errors on
    # num_palette == 0 ("Invalid palette") -> rc 25; we previously accepted
    png = dict(CASES)["plte_empty_truecolor"]
    for mod in ([native] if native.available() else []) + [pypng]:
        with pytest.raises(pypng.PngDecodeError) as ei:
            mod.decode(png)
        assert ei.value.exit_code == 25


def test_post_idat_chunks_not_kept():
    png = with_chunk_at(base_palette(), 3, b"tEXt", b"k\x00v")
    img = pypng.decode(png)
    assert not any(c.name == b"tEXt" for c in img.chunks)


def _placement_corner_cases():
    """Chunk-placement corners the random mutator essentially never hits
    (round-4 hand probe): zero-length text chunks before/after IDAT and
    after IEND, unknown safe/unsafe-to-copy ancillaries after IDAT, kept
    known chunks after IDAT, and colorspace chunks in the post-IDAT
    position (libpng accepts sRGB/gAMA there; rwpng.c reads them at
    png_read_info time only)."""
    from malformed import base_rgb, build, chunk, parse

    rgb = base_rgb()
    cs = parse(rgb)  # IHDR, IDAT, IEND

    def after_idat(name, body):
        return build([cs[0], cs[1], (name, body), cs[2]])

    return [
        ("text0_after_idat", after_idat(b"tEXt", b"")),
        ("itxt0_after_idat", after_idat(b"iTXt", b"")),
        ("ztxt0_after_idat", after_idat(b"zTXt", b"")),
        ("ztxt0_before_idat", with_chunk_at(rgb, 1, b"zTXt", b"")),
        ("itxt0_before_idat", with_chunk_at(rgb, 1, b"iTXt", b"")),
        ("text0_after_iend", rgb + chunk(b"tEXt", b"")),
        ("unknown_safe_after_idat", after_idat(b"aaAa", b"hello")),
        ("unknown_unsafe_after_idat", after_idat(b"aaAA", b"hello")),
        ("known_kept_after_idat_phys", after_idat(b"pHYs", bytes(9))),
        ("text_after_idat_normal", after_idat(b"tEXt", b"k\x00v")),
        ("srgb_after_idat_then_gama",
         build([cs[0], cs[1], (b"sRGB", b"\x00"),
                (b"gAMA", (45455).to_bytes(4, "big")), cs[2]])),
    ]


@pytest.mark.parametrize("strip", [False, True])
def test_chunk_placement_corner_codec_agreement(strip):
    def dec(mod, data):
        try:
            return True, _img_state(mod.decode(data, strip=strip))
        except pypng.PngDecodeError as e:
            return False, int(getattr(e, "exit_code", 25))

    for name, png in _placement_corner_cases():
        ok_py, res_py = dec(pypng, png)
        if native.available():
            ok_nat, res_nat = dec(native, png)
            assert (ok_nat, res_nat) == (ok_py, res_py), name


ORACLE = "/tmp/pngloss_oracle/pngloss"


@pytest.mark.skipif(
    not (os.path.exists(ORACLE) or (shutil.which("gcc")
         and os.path.exists("/root/reference/src/rwpng.c"))),
    reason="reference toolchain unavailable")
def test_oracle_accept_reject_and_exit_code_parity():
    if not os.path.exists(ORACLE):
        import glob
        os.makedirs(os.path.dirname(ORACLE), exist_ok=True)
        subprocess.run(["gcc", "-O2", "-o", ORACLE,
                        *glob.glob("/root/reference/src/*.c"),
                        "-lpng", "-lz", "-lm"], check=True)
    bad = []
    for name, png in CASES:
        r = subprocess.run([ORACLE, "-f", "-s", "19", "-b", "2", "-"],
                           input=png, capture_output=True, timeout=120)
        ok_py, res_py = _decode(pypng, png)
        if ok_py != (r.returncode == 0):
            bad.append(f"{name}: accept split ours={ok_py} oracle rc={r.returncode}")
        elif not ok_py and res_py != r.returncode:
            bad.append(f"{name}: exit code ours={res_py} oracle={r.returncode}")
    assert not bad, "\n".join(bad)


@pytest.mark.skipif(not os.path.exists(ORACLE),
                    reason="oracle binary unavailable")
@pytest.mark.parametrize("strip", [False, True])
def test_chunk_placement_corner_oracle_byte_parity(strip):
    # full-pipeline output bytes must match the C tool on every placement
    # corner, in both keep and strip modes (round-4 hand probe, 0 fails)
    from pngloss_jax.pipeline import compress_many

    cases = _placement_corner_cases()
    outs = compress_many([png for _, png in cases], [19] * len(cases), 2,
                         strip=strip)
    bad = []
    for (name, png), res in zip(cases, outs):
        cmd = [ORACLE, "-f", "-s", "19", "-b", "2"] + (["--strip"] if strip else [])
        r = subprocess.run(cmd + ["-"], input=png, capture_output=True,
                           timeout=120)
        if r.returncode == 0:
            if res.error is not None:
                bad.append(f"{name}: ours rejected {res.error!r}, oracle accepted")
            elif res.data != r.stdout:
                bad.append(f"{name}: bytes differ {len(res.data)} vs {len(r.stdout)}")
        elif res.error is None:
            bad.append(f"{name}: ours accepted, oracle rc={r.returncode}")
    assert not bad, "\n".join(bad)


def test_rowbytes_guard_boundary():
    # rwpng.c:287-290 fires iff rowbytes(=width*4) > INT_MAX/height, at the
    # first IDAT header: one past the boundary is exit 24, on the boundary
    # the decode proceeds and dies on the truncated IDAT instead (exit 25).
    # Hand-probed vs the oracle (16/16 exact, incl. pypng AND native).
    import zlib as _zlib

    from malformed import build, make_ihdr

    def png_for(w, h):
        return build([(b"IHDR", make_ihdr(w, h, 8, 2)),
                      (b"IDAT", _zlib.compress(b"\x00" * 10)),
                      (b"IEND", b"")])

    for w, h, want in [(536, 1000000, 25), (537, 1000000, 24),
                       (2147, 250000, 25), (2148, 250000, 24),
                       (1000000, 536, 25), (1000000, 537, 24)]:
        for mod in ([native] if native.available() else []) + [pypng]:
            with pytest.raises(pypng.PngDecodeError) as ei:
                mod.decode(png_for(w, h))
            assert ei.value.exit_code == want, (w, h, mod.__name__)
