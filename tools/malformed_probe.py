"""Differential probe: malformed-PNG catalog vs the C oracle.

For every specimen in tools/malformed.catalog():
  * run the oracle CLI on it (stdin -> stdout), record exit code + bytes
  * decode with the NATIVE codec in an isolated subprocess (so a SIGABRT
    is recorded, not fatal), record accept/reject + pixels hash
  * decode with the PYPNG codec in-process under a broad except
  * when oracle and pypng both accept, run the full in-process pipeline
    and byte-compare the final output

Prints one line per category and a divergence summary.  Exit 0 iff no
divergences.  Usage:
  python tools/malformed_probe.py            # full table
  python tools/malformed_probe.py --only trns  # substring filter
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

ORACLE = "/tmp/pngloss_oracle/pngloss"


def img_hash(img) -> str:
    meta = (img.rgba.shape, img.gamma, img.color_transform,
            [(c.name, c.data, c.location) for c in img.chunks])
    return hashlib.sha224(img.rgba.tobytes() + repr(meta).encode()).hexdigest()[:16]


def decode_subprocess(which: str, path: str) -> dict:
    """Decode `path` with codec `which` in a fresh process; JSON result."""
    code = (
        "import sys, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from malformed_probe import img_hash\n"
        "data = open(sys.argv[1], 'rb').read()\n"
        "from pngloss_jax.codec import pypng, native\n"
        "mod = native if %r == 'native' else pypng\n"
        "try:\n"
        "    img = mod.decode(data)\n"
        "    print(json.dumps({'ok': True, 'hash': img_hash(img),\n"
        "                      'w': img.width, 'h': img.height}))\n"
        "except pypng.PngDecodeError as e:\n"
        "    print(json.dumps({'ok': False, 'err': str(e), 'typed': True,\n"
        "                      'code': getattr(e, 'exit_code', 25)}))\n"
        "except Exception as e:\n"
        "    print(json.dumps({'ok': False, 'err': repr(e), 'typed': False}))\n"
        % (REPO, os.path.join(REPO, "tools"), which)
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code, path],
                       capture_output=True, timeout=120, env=env)
    if r.returncode != 0 or not r.stdout.strip():
        return {"ok": False, "crash": True,
                "rc": r.returncode, "stderr": r.stderr.decode()[-300:]}
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_oracle(png: bytes, strength: int = 19) -> tuple[int, bytes, str]:
    r = subprocess.run([ORACLE, "-f", "-s", str(strength), "-b", "2", "-"],
                       input=png, capture_output=True, timeout=120)
    return r.returncode, r.stdout, r.stderr.decode()[:200]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    ap.add_argument("--pixels", action="store_true",
                    help="also run the full pipeline byte-compare on accepts")
    args = ap.parse_args()

    from malformed import catalog

    import jax
    jax.config.update("jax_platforms", "cpu")

    from pngloss_jax.codec import pypng

    div = []
    os.makedirs("/tmp/malformed", exist_ok=True)
    for name, png in catalog():
        if args.only and args.only not in name:
            continue
        path = f"/tmp/malformed/{name}.png"
        with open(path, "wb") as f:
            f.write(png)
        orc_rc, orc_out, orc_err = run_oracle(png)
        nat = decode_subprocess("native", path)
        try:
            img = pypng.decode(png)
            pyr = {"ok": True, "hash": img_hash(img)}
        except pypng.PngDecodeError as e:
            pyr = {"ok": False, "err": str(e), "typed": True,
                   "code": getattr(e, "exit_code", 25)}
        except Exception as e:  # untyped leak — a defect by itself
            pyr = {"ok": False, "err": repr(e), "typed": False}

        problems = []
        orc_ok = orc_rc == 0
        if nat.get("crash"):
            problems.append(f"NATIVE CRASH rc={nat.get('rc')}")
        elif nat["ok"] != orc_ok:
            problems.append(f"native accept={nat['ok']} oracle rc={orc_rc}")
        if pyr["ok"] != orc_ok:
            problems.append(f"pypng accept={pyr['ok']} oracle rc={orc_rc}")
        if not pyr["ok"] and not pyr.get("typed", False):
            problems.append(f"pypng UNTYPED {pyr['err'][:60]}")
        if nat.get("ok") and pyr["ok"] and nat["hash"] != pyr["hash"]:
            problems.append("native!=pypng pixels")
        if not orc_ok and not nat.get("ok") and not nat.get("crash") \
                and not pyr["ok"]:
            ours = pyr.get("code", 25)
            if ours != orc_rc:
                problems.append(f"exit code ours={ours} oracle={orc_rc}")

        out_cmp = ""
        if args.pixels and orc_ok and pyr["ok"]:
            from pngloss_jax import pipeline
            from pngloss_jax import codec as C
            q, filters = pipeline.optimize_rgba(img.rgba, 19, 2)
            try:
                mine = C.encode(q, row_filters=filters, gamma=img.gamma,
                                color_transform=img.color_transform,
                                chunks=img.chunks)
                out_cmp = "BYTES-OK" if mine == orc_out else "BYTES-DIFF"
            except Exception as e:
                out_cmp = f"ENC-FAIL {e!r}"
            if out_cmp != "BYTES-OK":
                problems.append(out_cmp)

        status = "DIVERGE" if problems else "ok"
        if problems:
            div.append((name, problems))
        print(f"{status:8s} {name:32s} oracle rc={orc_rc:3d} "
              f"native={'crash' if nat.get('crash') else nat.get('ok')} "
              f"pypng={pyr['ok']} {'; '.join(problems)}"
              + (f"  [oracle: {orc_err.strip()[:80]}]" if problems else ""))

    print(f"\n{len(div)} divergent categories")
    return 1 if div else 0


if __name__ == "__main__":
    sys.exit(main())
