"""Which operations on the loop path PyTorch calls nondeterministic on the card.

    PYTHONPATH=. python3 tools/determinism_probe.py [--frames N] [--out PATH]

Tracks the first N frames (default: all 260) of ``chip_smoke.py``'s ``loop``
path (the reference loop test's orbit: keyframes, local BA, the vocabulary,
loop detection and closure, the global BA after it) with
``torch.use_deterministic_algorithms(True, warn_only=True)``: PyTorch then
warns at each call of an operation that has no deterministic CUDA
implementation, and runs the deterministic one where it has it. Each warning
is counted by its message and the innermost frame of the port on the stack.
A diagnostic only: the mode is switched off again before the script ends and
is never set in the package. Prints one line per (message, site) and as the
last line one JSON object with them; ``--out`` writes it too.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import traceback
import warnings

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if args.frames is not None:
        chip_smoke.LOOP_FRAMES = args.frames
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        stack = [f for f in traceback.extract_stack() if "dialog_tpu_torch" in f.filename]
        where = f"{pathlib.Path(stack[-1].filename).name}:{stack[-1].lineno}" if stack else f"{filename}:{lineno}"
        sites[(str(message).split("\n")[0][:160], where)] += 1

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():   # restores showwarning on exit
            warnings.simplefilter("always")
            warnings.showwarning = record
            run = chip_smoke.run_loop_path("loop", torch.device("cuda"))
    finally:
        torch.use_deterministic_algorithms(False)
    for (msg, where), n in sites.most_common():
        print(f"{n:6d}  {where}  {msg}")
    out = {"card": card, "frames": len(run["eng"].trajectory), "gba_runs": run["eng"].stats["gba_runs"],
           "closed": len(run["eng"]._loop.closed_loops),
           "sites": [{"message": m, "site": w, "count": n} for (m, w), n in sites.most_common()]}
    print(json.dumps(out))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
