"""Batched suite runner — the batched form of the reference's
suite/run_suite.sh (1,089 sequential process invocations, SURVEY.md §3.4):
one batched device dispatch per shape bucket, host codec around it.

Usage:
    python -m pngloss_jax.suite [--dir DIR] [--strengths 19,40] \
        [--oracle /path/to/pngloss] [--out DIR] [--impl auto]

Without --dir, it runs on the seeded stand-ins for the suite's eleven images
(pngloss_jax.corpus), written to a temporary directory. Prints a per-file
table (sizes, ratio, PSNR, byte-parity vs the oracle when given) and one
JSON summary line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

from pngloss_jax import codec
from pngloss_jax.metrics import psnr_rgba
from pngloss_jax.pipeline import compress_many


def run_oracle(oracle: str, data: bytes, strength: int, bleed: int = 2) -> bytes:
    proc = subprocess.run(
        [oracle, "-f", "-s", str(strength), "-b", str(bleed), "-"],
        input=data, capture_output=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr.decode(errors="replace"))
    return proc.stdout


def run_suite(paths, strengths, oracle=None, out_dir=None, impl="auto",
              mesh=None, verbose=True):
    files = {p: open(p, "rb").read() for p in paths}
    results = []
    total_in = total_out = 0
    total_mp = 0.0
    parity_ok = True

    # ONE batched dispatch per shape bucket across ALL (file, strength)
    # pairs — mixed strengths share lanes (per-image strength vector), so
    # the reference's 1,089 sequential suite invocations collapse into a
    # handful of device programs
    jobs = [(p, s) for s in strengths for p in paths]
    datas = [files[p] for p, _ in jobs]
    per_job_strength = [s for _, s in jobs]
    t0 = time.time()
    outs = compress_many(datas, per_job_strength, impl=impl, mesh=mesh)
    total_time = time.time() - t0

    in_decoded: dict[str, object] = {}
    for (p, strength), data, res in zip(jobs, datas, outs):
        name = os.path.basename(p)
        if res.error is not None:
            results.append(dict(file=name, strength=strength,
                                error=str(res.error)))
            continue
        if p not in in_decoded:
            in_decoded[p] = codec.decode(data)
        img = in_decoded[p]
        qimg = codec.decode(res.data)
        mp = img.width * img.height / 1e6
        total_mp += mp
        p_db = psnr_rgba(img.rgba, qimg.rgba)
        row = dict(
            file=name, strength=strength, in_bytes=len(data),
            out_bytes=len(res.data),
            ratio=round(len(res.data) / len(data), 4),
            psnr_db=round(p_db, 2) if p_db != float("inf") else "inf",
        )
        total_in += len(data)
        total_out += len(res.data)
        if oracle:
            ref = run_oracle(oracle, data, strength)
            row["byte_identical"] = res.data == ref
            parity_ok &= row["byte_identical"]
            if not row["byte_identical"]:
                row["oracle_bytes"] = len(ref)
                rimg = codec.decode(ref)
                row["oracle_psnr_db"] = round(psnr_rgba(img.rgba, rimg.rgba), 2)
        results.append(row)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(
                    out_dir, f"{name[:-4]}-s{strength}.png"), "wb") as f:
                f.write(res.data)
        if verbose:
            print(json.dumps(row), file=sys.stderr)

    summary = dict(
        files=len(paths), strengths=list(strengths),
        total_in=total_in, total_out=total_out,
        ratio=round(total_out / max(total_in, 1), 4),
        mp_per_s=round(total_mp / max(total_time, 1e-9), 3),
        seconds=round(total_time, 3),
    )
    if oracle:
        summary["all_byte_identical"] = parity_ok
    return results, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default=None,
                    help="directory of PNGs (default: the seeded stand-ins)")
    ap.add_argument("--strengths", default="19")
    ap.add_argument("--oracle", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--impl", default="auto", choices=["auto", "cuda", "xla"])
    ap.add_argument("--files", default=None,
                    help="comma-separated basenames (default: all *.png)")
    args = ap.parse_args(argv)

    if args.dir is None:
        import tempfile

        from pngloss_jax import corpus

        args.dir = tempfile.mkdtemp(prefix="pngloss-suite-")
        corpus.write_suite(args.dir)
    paths = sorted(glob.glob(os.path.join(args.dir, "*.png")))
    if args.files:
        wanted = set(args.files.split(","))
        paths = [p for p in paths if os.path.basename(p) in wanted]
    strengths = [int(s) for s in args.strengths.split(",")]

    _, summary = run_suite(paths, strengths, oracle=args.oracle,
                           out_dir=args.out, impl=args.impl)
    print(json.dumps(summary))
    return 0 if summary.get("all_byte_identical", True) else 1


if __name__ == "__main__":
    sys.exit(main())
