"""Run a series of cell runs, each in its own process as the benchmark's driver runs them.

    python3 -m bench_port.tools.series --out chiprun_out/NAME.jsonl RUN [RUN ...]

Each RUN is ``workload:seed:seconds:trace[:control]``. Every run's last stdout
line, its earlier JSON lines, the tail of its stderr, its exit code and its
wall seconds go to ``--out`` as one JSON line; a summary line per run is printed.
The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"card": card()}), flush=True)
    with open(out, "a") as f:
        for spec in args.runs:
            parts = spec.split(":")
            wl, seed, secs, trace = parts[:4]
            cmd = [sys.executable, "-m", "bench_port.run", "--workload", wl, "--seed", seed, "--seconds", secs,
                   "--trace", trace]
            if len(parts) > 4:
                cmd += ["--control", parts[4]]
            t0 = time.perf_counter()
            try:
                p = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
                rc, so, se = p.returncode, p.stdout, p.stderr
            except subprocess.TimeoutExpired as e:
                rc, so, se = 124, e.stdout or "", e.stderr or ""
                so, se = (x.decode() if isinstance(x, bytes) else x for x in (so, se))
            wall = time.perf_counter() - t0
            lines = [ln for ln in so.splitlines() if ln.startswith("{")]
            rec = {"spec": spec, "rc": rc, "wall_s": wall, "lines": lines[:-1],
                   "result": json.loads(lines[-1]) if lines and rc == 0 else None, "stderr_tail": se[-4000:]}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            r = rec["result"] or {}
            print(json.dumps({"spec": spec, "rc": rc, "wall_s": round(wall, 1), "correct": r.get("correct"),
                              "metrics": {k: v["value"] for k, v in r.get("metrics", {}).items()},
                              "checks": r.get("checks"), "err": None if rc == 0 else se[-1500:]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
