"""Randomized byte-parity fuzz loop vs the compiled C tool.

This is the committed form of the overnight evidence generator behind
BASELINE.md's fuzz row (~12.5k randomized cases, 0 mismatches): random
image sizes (1..--max-px per side), all colorspace kinds (gray,
gray+alpha, RGB, RGBA, flat, noisy, with transparent-pixel stripes),
per-image strengths over the FULL 0-255 domain and random bleeds per
batch, pushed through the production batched pipeline (ragged bucketing
included) and byte-compared case by case against the reference binary.
Reference counterpart: suite/run_suite.sh (the reference's only committed
evidence generator).

Architecture: a driver process spawns short-lived WORKER subprocesses
(~--cycle-cases cases each). Long-lived CPU-JAX processes that compile
many programs die with "LLVM compilation error: Cannot allocate memory"
despite free RAM (working notes), so the loop cycles workers instead of
threading one process through the night.

Usage:
  python tools/fuzz_loop.py --total 2000 --out /tmp/fuzz.jsonl
  python tools/fuzz_loop.py --duration 28800 --out /tmp/fuzz_overnight.jsonl
  # repro one batch: python tools/fuzz_loop.py --worker --seed 4217 --cases 64

Every case appends one JSONL record; mismatching inputs are written next
to the JSONL as <out>.case<N>.png for direct repro with the CLI + oracle.
Exit code 0 iff every case was byte-identical.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_ORACLE = "/tmp/pngloss_oracle/pngloss"
CRASH_EXIT = 125     # worker exit for "died before finishing", not parity


def _line_count(path):
    try:
        with open(path) as f:
            return sum(1 for _ in f)
    except (OSError, TypeError):
        return 0


def build_oracle(path: str = DEFAULT_ORACLE) -> str:
    """Compile the reference C tool if it is not already present."""
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        import glob

        subprocess.run(
            ["gcc", "-O2", "-o", path,
             *glob.glob("/root/reference/src/*.c"), "-lpng", "-lz", "-lm"],
            check=True)
    return path


def random_case(rng):
    """One random RGBA image + parameters. Mirrors the CI fuzz slice
    (tests/test_fuzz_oracle.py) but over the full size/strength domain."""
    import numpy as np

    max_px = int(os.environ.get("PNGLOSS_FUZZ_MAX_PX", "128"))
    kind = rng.choice(["gray", "gray_alpha", "rgb", "rgba", "flat", "noisy"])
    h = int(rng.integers(1, max_px + 1))
    w = int(rng.integers(1, max_px + 1))
    if kind == "flat":
        rgba = np.full((h, w, 4), int(rng.integers(0, 256)), np.uint8)
        rgba[:, :, 3] = 255
    else:
        rgba = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
        if kind in ("gray", "gray_alpha"):
            rgba[:, :, 0] = rgba[:, :, 2] = rgba[:, :, 1]
        if kind in ("gray", "rgb", "noisy"):
            rgba[:, :, 3] = 255
        if kind in ("gray_alpha", "rgba") and rng.random() < 0.5:
            rgba[::2, :, 3] = 0   # exercise the transparent-pixel rule
    # FULL strength domain by default; cap it to concentrate a run on one
    # band class (chosen by the batch's max strength, so e.g.
    # MAX_STRENGTH=31 pins every batch to the 32-entry class)
    s_max = int(os.environ.get("PNGLOSS_FUZZ_MAX_STRENGTH", "255"))
    strength = int(rng.integers(0, s_max + 1))
    return kind, rgba, strength


def run_worker(seed: int, cases: int, out_path: str | None,
               oracle: str, impl: str = "auto") -> int:
    """Run `cases` randomized cases as ONE ragged mixed-strength batch
    through compress_many; oracle-compare each. Returns mismatch count.

    impl="cuda" runs the row kernel's host twin (native/rowopt.h built
    by g++, the same source as the CUDA build) through the same wrapper,
    so the kernel's arithmetic gets fuzzed too, not just the XLA path."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from pngloss_jax.codec import encode
    from pngloss_jax.pipeline import compress_many

    rng = np.random.default_rng(seed)
    bleed = int(rng.choice([1, 2, 3, 5, 17, 255, 32767]))
    metas, pngs, strengths = [], [], []
    for _ in range(cases):
        kind, rgba, strength = random_case(rng)
        metas.append((kind, rgba.shape[0], rgba.shape[1]))
        pngs.append(encode(rgba, row_filters=None))
        strengths.append(strength)

    results = compress_many(pngs, strengths, bleed, impl=impl)

    mismatches = 0
    recs = []
    for i, (res, png) in enumerate(zip(results, pngs)):
        ref = subprocess.run(
            [oracle, "-f", "-s", str(strengths[i]), "-b", str(bleed), "-"],
            input=png, capture_output=True).stdout
        ok = res.error is None and res.data == ref
        kind, h, w = metas[i]
        rec = {"seed": seed, "case": i, "kind": kind, "h": h, "w": w,
               "strength": strengths[i], "bleed": bleed,
               "byte_identical": bool(ok)}
        if not ok:
            mismatches += 1
            rec["error"] = repr(res.error) if res.error else None
            if out_path:
                bad = f"{out_path}.seed{seed}case{i}.png"
                with open(bad, "wb") as f:
                    f.write(png)
                rec["input_saved"] = bad
        recs.append(rec)
    if out_path:
        with open(out_path, "a") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
    else:
        for rec in recs:
            print(json.dumps(rec))
    return mismatches


def run_malformed_worker(seed: int, cases: int, out_path: str | None,
                         oracle: str) -> int:
    """Differential malformed-input fuzz: mutate valid PNGs, then assert for
    every case (round-3 verdict item 1d):
      * neither of our codecs crashes or leaks an untyped exception,
      * native and pypng agree on accept/reject AND decoded state,
      * accept/reject + exit code + output bytes match the oracle
        (including --strip mode, which changes acceptance rules).
    Returns the mismatch count."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import hashlib

    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from malformed import catalog, mutate, random_base

    from pngloss_jax.codec import native, pypng
    from pngloss_jax.pipeline import compress_many

    rng = np.random.default_rng(seed)
    bleed = int(rng.choice([1, 2, 3, 17, 32767]))
    cat = catalog()

    def decode_state(mod, data, strip):
        """(accepted, state-hash or exit-code). PngDecodeError is the ONLY
        acceptable failure; anything else is an untyped leak -> crash."""
        try:
            img = mod.decode(data, strip=strip)
        except pypng.PngDecodeError as e:
            return False, int(getattr(e, "exit_code", 25))
        meta = (img.rgba.shape, round(img.gamma, 9), img.color_transform,
                [(c.name, c.data, c.location) for c in img.chunks])
        return True, hashlib.sha224(
            img.rgba.tobytes() + repr(meta).encode()).hexdigest()[:20]

    specs = []
    for i in range(cases):
        if rng.random() < 0.06:
            kinds, png = ["catalog"], cat[int(rng.integers(0, len(cat)))][1]
        else:
            png = random_base(rng)
            kinds = []
            for _ in range(int(rng.integers(1, 4))):
                k, png = mutate(png, rng)
                kinds.append(k)
        strip = bool(rng.random() < 0.25)
        strength = int(rng.integers(0, 256))
        specs.append({"png": png, "strip": strip, "strength": strength,
                      "kinds": kinds})

    # oracle + decode-level cross-checks per case
    for sp in specs:
        cmd = [oracle, "-f", "-s", str(sp["strength"]), "-b", str(bleed)]
        if sp["strip"]:
            cmd.append("--strip")
        r = subprocess.run(cmd + ["-"], input=sp["png"],
                           capture_output=True, timeout=300)
        sp["oracle_rc"], sp["oracle_out"] = r.returncode, r.stdout
        sp["py"] = decode_state(pypng, sp["png"], sp["strip"])
        sp["nat"] = decode_state(native, sp["png"], sp["strip"]) \
            if native.available() else sp["py"]

    # full-pipeline byte compare, batched per strip group
    for strip in (False, True):
        grp = [sp for sp in specs if sp["strip"] == strip]
        if not grp:
            continue
        outs = compress_many([sp["png"] for sp in grp],
                             [sp["strength"] for sp in grp], bleed,
                             strip=strip)
        for sp, res in zip(grp, outs):
            sp["res"] = res

    mismatches = 0
    recs = []
    for i, sp in enumerate(specs):
        res = sp["res"]
        problems = []
        if sp["nat"] != sp["py"]:
            problems.append(f"native={sp['nat']} pypng={sp['py']}")
        if sp["oracle_rc"] == 0:
            if res.error is not None:
                problems.append(f"ours rejected ({res.error!r}), oracle accepted")
            elif res.data != sp["oracle_out"]:
                problems.append(f"output bytes differ ({len(res.data)} vs "
                                f"{len(sp['oracle_out'])})")
        else:
            if res.error is None:
                problems.append(f"ours accepted, oracle rc={sp['oracle_rc']}")
            else:
                code = int(getattr(res.error, "exit_code", 25))
                if code != sp["oracle_rc"]:
                    problems.append(f"exit code ours={code} "
                                    f"oracle={sp['oracle_rc']}")
        rec = {"seed": seed, "case": i, "mode": "malformed",
               "kinds": sp["kinds"], "strip": sp["strip"],
               "strength": sp["strength"], "bleed": bleed,
               "oracle_rc": sp["oracle_rc"],
               "byte_identical": not problems}
        if problems:
            mismatches += 1
            rec["problems"] = problems
            if out_path:
                bad = f"{out_path}.seed{seed}case{i}.png"
                with open(bad, "wb") as f:
                    f.write(sp["png"])
                rec["input_saved"] = bad
        recs.append(rec)
    if out_path:
        with open(out_path, "a") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
    else:
        for rec in recs:
            print(json.dumps(rec))
    return mismatches


def run_deflate(args) -> int:
    """Differential-fuzz the fast deflate clone vs the system zlib.

    Builds native/fd_test (211 generated cases per seed spanning stored/
    static/dynamic blocks, window slides, MAX_DIST-straddling matches,
    run-heavy lossy-like data) and sweeps seeds until --total cases or
    --duration seconds."""
    native = os.path.join(REPO, "native")
    # fd_test carries the production ISA flags (AVX-512 match filter);
    # fd_test_portable is the same source scalar-only — alternate seeds
    # between them so both code paths accumulate coverage.
    builds = []
    for target in ("fd_test", "fd_test_portable"):
        subprocess.run(["make", "-C", native, "-s", target], check=True)
        builds.append(os.path.join(native, target))
    total = fails = 0
    t0 = time.time()
    seed = args.seed
    while True:
        if args.total and total >= args.total:
            break
        if args.duration and time.time() - t0 >= args.duration:
            break
        binary = builds[seed % len(builds)]
        r = subprocess.run([binary, str(seed)], capture_output=True,
                           text=True)
        line = (r.stdout.strip().splitlines() or ["?"])[-1]
        print(f"seed {seed} [{os.path.basename(binary)}]: {line}",
              file=sys.stderr)
        if r.returncode != 0:
            sys.stdout.write(r.stdout)
            fails += 1
        total += 211  # cases per fd_test run
        seed += 1
    print(f"deflate fuzz DONE: ~{total} cases, {fails} failing seeds",
          file=sys.stderr)
    return 1 if fails else 0


def run_driver(args) -> int:
    oracle = build_oracle(args.oracle)
    total = done = mismatches = 0
    t0 = time.time()
    seed = args.seed
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    while True:
        if args.total and done >= args.total:
            break
        if args.duration and time.time() - t0 >= args.duration:
            break
        cases = min(args.cycle_cases,
                    (args.total - done) if args.total else args.cycle_cases)
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               "--seed", str(seed), "--cases", str(cases),
               "--oracle", oracle, "--impl", args.impl]
        if args.malformed:
            cmd.append("--malformed")
        if args.out:
            cmd += ["--out", args.out]
        before = _line_count(args.out)
        r = subprocess.run(cmd, env=env)
        if r.returncode < 0:
            print(f"fuzz worker seed={seed} killed by signal "
                  f"{-r.returncode}", file=sys.stderr)
            return 2
        if r.returncode >= CRASH_EXIT:
            print(f"fuzz worker seed={seed} CRASHED (exit "
                  f"{r.returncode}) — not a parity result", file=sys.stderr)
            return 2
        if args.out and _line_count(args.out) - before != cases:
            print(f"fuzz worker seed={seed} wrote "
                  f"{_line_count(args.out) - before}/{cases} records — "
                  "aborting (worker died mid-batch?)", file=sys.stderr)
            return 2
        mismatches += r.returncode
        done += cases
        total += cases
        seed += 1
        rate = done / max(time.time() - t0, 1e-9)
        print(f"fuzz: {done} cases, {mismatches} mismatches, "
              f"{rate:.1f} cases/s", file=sys.stderr)
    print(f"fuzz DONE: {total} cases, {mismatches} mismatches",
          file=sys.stderr)
    return 1 if mismatches else 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", action="store_true",
                    help="internal: run one worker cycle in-process")
    ap.add_argument("--seed", type=int, default=int(time.time()) % 100000)
    ap.add_argument("--cases", type=int, default=64,
                    help="worker mode: cases in this batch")
    ap.add_argument("--total", type=int, default=0,
                    help="driver: stop after N cases (0 = duration-bound)")
    ap.add_argument("--duration", type=float, default=0,
                    help="driver: stop after S seconds")
    ap.add_argument("--cycle-cases", type=int, default=256,
                    help="driver: cases per worker subprocess (workers are "
                         "cycled to dodge the CPU-JAX LLVM OOM)")
    ap.add_argument("--out", default=None, help="JSONL output path")
    ap.add_argument("--oracle", default=DEFAULT_ORACLE)
    ap.add_argument("--impl", default="auto",
                    choices=["auto", "xla", "cuda"],
                    help="cuda = fuzz the row kernel's host twin")
    ap.add_argument("--deflate", action="store_true",
                    help="differential-fuzz the native fast-deflate clone "
                         "vs the system zlib (no oracle/JAX involved)")
    ap.add_argument("--malformed", action="store_true",
                    help="differential-fuzz MALFORMED inputs: mutate valid "
                         "PNGs and assert crash-freedom, native<->pypng "
                         "agreement, and accept/reject + exit-code + output-"
                         "byte parity vs the oracle")
    args = ap.parse_args()
    if not args.worker and not args.total and not args.duration:
        args.total = 1024
    if args.deflate:
        sys.exit(run_deflate(args))
    if args.worker:
        sys.path.insert(0, REPO)
        try:
            if args.malformed:
                n = run_malformed_worker(args.seed, args.cases, args.out,
                                         build_oracle(args.oracle))
            else:
                n = run_worker(args.seed, args.cases, args.out,
                               build_oracle(args.oracle), impl=args.impl)
        except Exception:
            import traceback

            traceback.print_exc()
            sys.exit(CRASH_EXIT)
        sys.exit(min(n, 120))
    sys.exit(run_driver(args))


if __name__ == "__main__":
    main()
