"""Throughput benchmark: megapixels per second of compress_many at -s 19.

Input: seeded 512x512 RGB PNGs (pngloss_jax.corpus). Timing: host clock
around whole compress_many calls (decode, device optimize, encode; the call
returns encoded bytes, so the device work is finished), after one warm-up
call that compiles. The device path is the one --impl selects.

Prints the device and the card's name and power limit, then one JSON line.
Exits non-zero when JAX finds no GPU: the numbers describe the card.

    python bench.py [--batch 25] [--impl auto]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

STRENGTH = 19
REPEATS = 3


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def bench_inputs(batch: int, side: int = 512, seed: int = 100) -> list[bytes]:
    """`batch` distinct seeded side x side RGB PNGs."""
    from pngloss_jax import corpus

    return [corpus.encode_png(corpus.synth_rgba(side, side, "rgb", seed + i),
                              "rgb") for i in range(batch)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=25)
    ap.add_argument("--impl", default="auto", choices=["auto", "cuda", "xla"])
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"# device: {device}; card: {card()}", file=sys.stderr)
    if dev.platform != "gpu":
        print("bench.py measures the GPU; JAX found none", file=sys.stderr)
        return 1

    from pngloss_jax.pipeline import compress_many

    pngs = bench_inputs(args.batch)
    t0 = time.perf_counter()
    compress_many(pngs, STRENGTH, impl=args.impl)
    warmup = time.perf_counter() - t0
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for r in compress_many(pngs, STRENGTH, impl=args.impl):
            r.unwrap()
        times.append(time.perf_counter() - t0)
    mp = args.batch * 512 * 512 / 1e6
    print(json.dumps({
        "metric": "compress_many_mp_per_s",
        "value": mp / min(times),
        "unit": "MP/s",
        "times_s": times,
        "warmup_s": warmup,
        "batch": args.batch,
        "strength": STRENGTH,
        "impl": args.impl,
        "device": device,
        "card": card(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
