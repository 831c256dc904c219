#!/usr/bin/env python3
"""End-to-end check of pngloss-jax on one NVIDIA GPU.

Run from the root of a checkout, in one process (the CLI and the website
are driven in-process, never as a second process on the card):

    python3 chip_smoke.py           # all phases on one card
    python3 chip_smoke.py --four    # only the 4-card mesh path, vs 1 card

Phases:
  1. device: platform, kind, count, JAX version, the card's name and power
     limit; exits non-zero when JAX finds no GPU
  2. build: the CUDA row kernel from native/, compiled at real widths
  3. parity: the kernel against core/reference.py on small seeded images
     (every bpp, band class, bleed, transparency, embedding mode, a ragged
     mixed batch) and against the XLA path on the same card at real widths;
     exact, byte for byte; then the repository's `gpu` tests
  4. main path: compress_many on a seeded suite corpus at s = 0, 19, 40, 75,
     the CLI on one file, the embedding API, and the website on a thread
     answering POSTs up to a 3000x3000 upload; every output must decode to
     the device result, losslessly at s = 0
  5. timing: compress_many on the row kernel and on the XLA path, seeded
     512x512 RGB at s = 19, batch 25 and batch 1, host clock

The last line of standard output is one JSON object, printed only when
every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# real widths of the compile, XLA-parity, upload and timing phases
COMPILE_SHAPES = ((25, 512, 512, 3, 32), (1, 48, 3000, 4, 128),
                  (1, 3000, 3000, 3, 32))
XLA_CASES = ((512, 512, "rgb", 19), (48, 3000, "rgba", 75))
UPLOAD_SIDE = 3000
TIMING_SIDE, TIMING_BATCH = 512, 25
_failures: list[str] = []


def _say(*parts) -> None:
    print(*parts, flush=True)


def _phase(name, fn, *args):
    """Run one phase; record (not raise) its failure."""
    _say(f"== {name}")
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except Exception:
        traceback.print_exc(file=sys.stdout)
        _failures.append(name)
        _say(f"== {name}: FAILED after {time.perf_counter() - t0:.1f} s")
        return None
    _say(f"== {name}: ok in {time.perf_counter() - t0:.1f} s")
    return out


def device_info(expect: int):
    import jax

    from bench import card

    devs = jax.devices()
    d = devs[0]
    _say(f"platform={d.platform} kind={d.device_kind} count={len(devs)} "
         f"jax={jax.__version__}")
    _say(f"card: {card()}")
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {d.platform}")
    if len(devs) < expect:
        raise SystemExit(f"needs {expect} GPUs, JAX sees {len(devs)}")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def build_and_compile():
    import jax
    import jax.numpy as jnp

    from pngloss_jax.ops import rowkernel

    t0 = time.perf_counter()
    rowkernel.ensure_registered("gpu")
    _say(f"built and loaded {rowkernel.BUILD_DIR}/librowopt_cuda.so in "
         f"{time.perf_counter() - t0:.1f} s")
    for b, h, w, bpp, band in COMPILE_SHAPES:
        i32 = jax.ShapeDtypeStruct((b,), jnp.int32)
        t0 = time.perf_counter()
        compiled = rowkernel._rowopt_jit.lower(
            jax.ShapeDtypeStruct((b, h, w * bpp), jnp.uint8), i32,
            jax.ShapeDtypeStruct((), jnp.int32), i32, i32,
            bpp=bpp, band=band, embed=False).compile()
        _say(f"compiled B={b} {w}x{h} bpp={bpp} band={band} in "
             f"{time.perf_counter() - t0:.1f} s: {compiled.memory_analysis()}")


def _work(h, w, kind, seed):
    from pngloss_jax import corpus
    from pngloss_jax.pipeline import reduce_colorspace

    return reduce_colorspace(corpus.synth_rgba(h, w, kind, seed))


def _exact(name, q, f, want_q, want_f):
    import numpy as np

    if not (np.array_equal(q, want_q) and np.array_equal(f, want_f)):
        diff = int(np.sum(q != want_q)) if q.shape == want_q.shape else -1
        raise AssertionError(f"{name}: mismatch ({diff} bytes differ)")


def parity():
    import numpy as np
    import pytest

    from pngloss_jax.core import reference as ref
    from pngloss_jax.ops import optimize_batch, optimize_batch_kernel

    n = 0

    def vs_reference(name, work, bpp, s, bleed=2, urf=True):
        nonlocal n
        q, f = optimize_batch_kernel(work[None], s, bleed, bpp=bpp,
                                     use_row_filters=urf)
        qr, fr = ref.optimize_image(work, bpp, s, bleed, urf)
        _exact(name, np.asarray(q)[0], np.asarray(f)[0], qr, fr)
        n += 1

    for kind, seed in (("gray", 1), ("gray_alpha", 2), ("rgb", 3), ("rgba", 4)):
        work, bpp = _work(46, 70, kind, seed)
        vs_reference(f"70x46 {kind} bpp={bpp} s=19", work, bpp, 19)
    rgba, bpp4 = _work(24, 32, "rgba", 5)
    assert bpp4 == 4 and (rgba.reshape(24, 32, 4)[:, :, 3] == 0).any()
    for s in (0, 3, 19, 31, 40, 75, 127, 255):
        vs_reference(f"32x24 rgba s={s}", rgba, 4, s)
    rgb, bpp3 = _work(24, 32, "rgb", 6)
    for bleed in (1, 2, 32767):
        vs_reference(f"32x24 rgb bleed={bleed}", rgb, bpp3, 19, bleed)
    vs_reference("32x24 rgb embedding s=19", rgb, bpp3, 19, urf=False)
    vs_reference("32x24 rgba embedding s=45", rgba, 4, 45, urf=False)

    # a ragged, mixed-size, mixed-strength batch in one padded launch
    sizes, strengths = ((46, 70), (20, 33), (41, 17), (3, 5)), (0, 19, 75, 255)
    works = [_work(h, w, "rgb", 10 + i)[0] for i, (h, w) in enumerate(sizes)]
    pad = np.zeros((4, 48, 72 * 3), np.uint8)
    for k, wk in enumerate(works):
        pad[k, :wk.shape[0], :wk.shape[1]] = wk
    q, f = optimize_batch_kernel(
        pad, np.asarray(strengths), 2, bpp=3,
        w_real=[w for _, w in sizes], h_real=[h for h, _ in sizes])
    q, f = np.asarray(q), np.asarray(f)
    for k, ((h, w), wk, s) in enumerate(zip(sizes, works, strengths)):
        qr, fr = ref.optimize_image(wk, 3, s, 2)
        _exact(f"ragged {w}x{h} s={s}", q[k, :h, :w * 3], f[k, :h], qr, fr)
        n += 1
    _say(f"kernel == core/reference.py on {n} images")

    # against the XLA path on this card, at real widths
    for i, (h, w, kind, s) in enumerate(XLA_CASES):
        name = f"{w}x{h} {kind} s={s}"
        work, bpp = _work(h, w, kind, 20 + i)
        t0 = time.perf_counter()
        qk, fk = optimize_batch_kernel(work[None], s, 2, bpp=bpp)
        qk, fk = np.asarray(qk), np.asarray(fk)
        t1 = time.perf_counter()
        qx, fx = optimize_batch(work[None], s, 2, bpp=bpp)
        qx, fx = np.asarray(qx), np.asarray(fx)
        t2 = time.perf_counter()
        _exact(f"{name} vs XLA", qk, fk, qx, fx)
        _say(f"kernel == XLA on {name} (first calls: kernel {t1 - t0:.1f} s, "
             f"XLA {t2 - t1:.1f} s, compiles included)")

    class Outcomes:
        def __init__(self):
            self.passed = self.other = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.other += 1

    outcomes = Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(ROOT, "tests", "test_rowkernel.py")],
                     plugins=[outcomes])
    _say(f"gpu tests: {outcomes.passed} passed, {outcomes.other} not")
    if rc != 0 or outcomes.passed == 0 or outcomes.other:
        raise AssertionError(f"gpu tests failed (pytest exit {rc})")


def _decoded(data):
    from pngloss_jax import codec

    return codec.decode(data).rgba


def corpus_jobs():
    from pngloss_jax import corpus

    files = corpus.suite_corpus(SEED)
    names = [n for n in files for _ in (0, 19, 40, 75)]
    strengths = [s for _ in files for s in (0, 19, 40, 75)]
    return names, [files[n] for n in names], strengths


def main_path():
    import numpy as np

    from pngloss_jax import cli, corpus, pipeline

    names, pngs, strengths = corpus_jobs()
    t0 = time.perf_counter()
    results = pipeline.compress_many(pngs, strengths)
    _say(f"compress_many: {len(pngs)} jobs in {time.perf_counter() - t0:.1f} s")
    inputs = [_decoded(p) for p in pngs]
    want, _ = pipeline.optimize_rgba_batch(inputs, strengths)
    for name, s, rgba, res, q in zip(names, strengths, inputs, results, want):
        got = _decoded(res.unwrap())
        if not np.array_equal(got, q):
            raise AssertionError(f"{name} s={s}: output != device result")
        if s == 0 and not np.array_equal(got, rgba):
            raise AssertionError(f"{name} s=0: not lossless")
    _say(f"all {len(pngs)} outputs decode to the device result; "
         "s=0 is lossless")

    tux = corpus.suite_image("tux.png", SEED)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.png"), os.path.join(tmp, "out.png")
        with open(src, "wb") as fh:
            fh.write(tux)
        argv, sys.argv = sys.argv, ["pngloss-jax", "-f", "-s", "19", "-o",
                                    dst, src]
        try:
            cli.main()
            rc = 0
        except SystemExit as e:
            rc = e.code
        finally:
            sys.argv = argv
        if rc != 0:
            raise AssertionError(f"CLI exit code {rc}")
        with open(dst, "rb") as fh:
            out = fh.read()
    q, _ = pipeline.optimize_rgba(_decoded(tux), 19)
    if not np.array_equal(_decoded(out), q):
        raise AssertionError("CLI output != device result")
    _say("CLI main(): ok")

    from pngloss_jax.core.reference import adaptive_filter_for_row

    rgba = _decoded(corpus.suite_image("redbrush.png", SEED))
    q = pipeline.optimize_for_average_filter(rgba, 19)
    q2, f = pipeline.optimize_rgba(rgba, 19, bleed=2, use_row_filters=False)
    if not np.array_equal(q, q2) or not (q[rgba[:, :, 3] == 0, 3] == 0).all():
        raise AssertionError("embedding API: wrong result")
    bpp = pipeline.working_bpp(rgba)
    qw = pipeline.pack_work(q, bpp)
    for y in range(qw.shape[0]):
        pick = adaptive_filter_for_row(qw[y - 1] if y else None, qw[y], bpp,
                                       qw.shape[1] // bpp)
        if pick != f[y]:
            raise AssertionError(f"embedding API: row {y} fails the check")
    _say("optimize_for_average_filter: every row passes libpng's heuristic")

    website()


def website():
    import base64
    import hashlib
    import threading
    import urllib.request

    import numpy as np

    from pngloss_jax import corpus, pipeline
    from pngloss_jax.website import make_server

    uploads = [
        ("rose", corpus.suite_image("rose.png", SEED), 19),
        ("tux", corpus.suite_image("tux.png", SEED), 40),
        (f"{UPLOAD_SIDE}x{UPLOAD_SIDE} rgb", corpus.encode_png(corpus.synth_rgba(
            UPLOAD_SIDE, UPLOAD_SIDE, "rgb", 30, noise=1.0), "rgb"), 19),
    ]
    with tempfile.TemporaryDirectory() as store:
        srv = make_server(port=0, store=store)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            for name, data, s in uploads:
                t0 = time.perf_counter()
                boundary = "pnglosssmoke"
                body = b""
                for k, v in (("file", data), ("strength", str(s).encode()),
                             ("bleed", b"2"), ("strip", b"0")):
                    body += (f"--{boundary}\r\nContent-Disposition: form-data;"
                             f' name="{k}"\r\n\r\n').encode() + v + b"\r\n"
                body += f"--{boundary}--\r\n".encode()
                req = urllib.request.Request(
                    f"{base}/compress.cgi", data=body, headers={
                        "Content-Type":
                            f"multipart/form-data; boundary={boundary}"})
                with urllib.request.urlopen(req, timeout=600) as resp:
                    page = resp.read().decode()
                if "compressed.cgi?sum224=" not in page:
                    raise AssertionError(f"website {name}: no result page")
                sum224 = base64.urlsafe_b64encode(
                    hashlib.sha224(data).digest()).decode()
                with urllib.request.urlopen(
                        f"{base}/compressed.cgi?sum224={sum224}&strength={s}"
                        "&bleed=2&strip=0", timeout=600) as resp:
                    out = resp.read()
                took = time.perf_counter() - t0
                q, _ = pipeline.optimize_rgba(_decoded(data), s)
                if not np.array_equal(_decoded(out), q):
                    raise AssertionError(f"website {name}: != device result")
                _say(f"website {name} ({len(data)} B in, {len(out)} B out): "
                     f"ok, {took:.2f} s")
        finally:
            srv.shutdown()
            srv.server_close()


def timing(card: str):
    from bench import bench_inputs
    from pngloss_jax import pipeline

    side = TIMING_SIDE
    pngs = bench_inputs(TIMING_BATCH, side)
    mp = side * side / 1e6
    outs = {}
    for impl, reps in (("cuda", 3), ("xla", 1)):
        for batch in (TIMING_BATCH, 1):
            files = pngs[:batch]
            t0 = time.perf_counter()
            first = pipeline.compress_many(files, 19, impl=impl)
            warm = time.perf_counter() - t0
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                res = pipeline.compress_many(files, 19, impl=impl)
                times.append(time.perf_counter() - t0)
            outs[(impl, batch)] = [r.unwrap() for r in res]
            assert [r.unwrap() for r in first] == outs[(impl, batch)]
            best = min(times)
            _say(f"timing compress_many impl={impl} batch={batch} "
                 f"{side}x{side} rgb "
                 f"s=19: first {warm:.3f} s, then {[round(t, 4) for t in times]}"
                 f" s -> {batch * mp / best:.3f} MP/s, {batch / best:.3f} "
                 f"img/s [{card}]")
    for batch in (TIMING_BATCH, 1):
        if outs[("cuda", batch)] != outs[("xla", batch)]:
            raise AssertionError(f"batch {batch}: kernel bytes != XLA bytes")
    _say("kernel and XLA outputs byte-identical")


def four_cards():
    import jax

    from pngloss_jax import pipeline
    from pngloss_jax.parallel import data_mesh

    names, pngs, strengths = corpus_jobs()
    mesh = data_mesh(jax.devices()[:4])
    t0 = time.perf_counter()
    one = [r.unwrap() for r in pipeline.compress_many(pngs, strengths)]
    t1 = time.perf_counter()
    four = [r.unwrap() for r in pipeline.compress_many(pngs, strengths,
                                                       mesh=mesh)]
    t2 = time.perf_counter()
    bad = [f"{n} s={s}" for n, s, a, b in zip(names, strengths, one, four)
           if a != b]
    if bad:
        raise AssertionError(f"4-card output differs from 1 card: {bad}")
    _say(f"4-card mesh == 1 card on all {len(pngs)} jobs, byte for byte "
         f"(first calls, compiles included: 1 card {t1 - t0:.1f} s, "
         f"4 cards {t2 - t1:.1f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh path and its 1-card twin")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        import bench
        import pngloss_jax  # noqa: F401
    except ImportError as e:
        _say(f"FAIL: run from the root of a pngloss-jax checkout ({e})")
        return 1
    try:
        device = device_info(4 if args.four else 1)
    except SystemExit as e:
        _say(f"FAIL: {e}")
        return 1
    except Exception as e:
        _say(f"FAIL: JAX found no usable device ({e})")
        return 1
    card = bench.card()

    if args.four:
        _phase("build", build_and_compile)
        if not _failures:
            _phase("four cards", four_cards)
        device["count"] = 4
    else:
        _phase("build", build_and_compile)
        if not _failures:
            _phase("parity", parity)
            _phase("main path", main_path)
            _phase("timing", timing, card)
    if _failures:
        _say(f"FAIL: {', '.join(_failures)}")
        return 1
    _say(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
