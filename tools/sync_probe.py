"""Which source lines make the host wait for the card on the batched path.

    PYTHONPATH=. python3 tools/sync_probe.py [mono|stereo] [--out PATH]

Tracks 16 frames of the workload per frame, then five batches through the
batched frontend and ``Engine.track_batch`` and a ``flush``, with
``torch.cuda.set_sync_debug_mode("warn")`` on: PyTorch then warns at every
call that synchronises the host with the stream (``.item()``, ``nonzero``, a
copy from pageable host memory such as ``torch.tensor(x, device="cuda")``).
Each warning is counted under the section it fell in (``extract<k>``,
``track_batch<k>``, ``flush``) and the innermost three frames of the port on
the stack. Prints the totals per section, then one line per (section, site),
and as the last line one JSON object with both; ``--out`` writes it too.
Event waits (the batch's pull) are not stream syncs and are not counted.
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

from dialog_tpu_torch.profile_main_path import BATCH, FPS_FIRST, WORKLOADS, extract_batch, track_frames
from dialog_tpu_torch.system import Engine

N_BATCHES = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config", nargs="?", choices=("mono", "stereo"), default="mono")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    make_cfg, make_frames, method, fps = WORKLOADS[args.config]
    cfg = make_cfg()
    _, frames = make_frames(cfg, FPS_FIRST + N_BATCHES * BATCH)
    dev = torch.device("cuda")
    eng = Engine(cfg, device=dev)
    track_frames(eng, method, frames, 0, FPS_FIRST, fps)

    counts: collections.Counter = collections.Counter()
    section = ["start"]

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        port = [f for f in traceback.extract_stack() if "dialog_tpu_torch" in f.filename]
        site = " < ".join(f"{f.filename.split('dialog_tpu_torch/')[-1]}:{f.lineno}" for f in port[-3:][::-1])
        counts[(section[0], site)] += 1

    warnings.showwarning = show
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    kfs = []
    for k in range(N_BATCHES):
        i = FPS_FIRST + k * BATCH
        section[0] = f"extract{k}"
        batch = extract_batch(cfg, frames, i, dev)
        section[0] = f"track_batch{k}"
        eng.track_batch(batch, [float(i + j) / fps for j in range(BATCH)])
        kfs.append(eng.kf_count)
    section[0] = "flush"
    eng.flush()
    kfs.append(eng.kf_count)
    torch.cuda.set_sync_debug_mode("default")

    totals: collections.Counter = collections.Counter()
    for (s, _), n in counts.items():
        totals[s] += n
    print(f"{args.config}, B={BATCH}, on {card}: stream syncs per section {dict(totals)}; "
          f"keyframes after each track_batch and the flush {kfs}")
    for (s, site), n in sorted(counts.items(), key=lambda x: (x[0][0], -x[1])):
        print(s, n, site)
    out = {"card": card, "config": args.config, "batch": BATCH, "syncs_per_section": dict(totals),
           "keyframes_after_each_section": kfs, "frames_ok": [r.state for r in eng.trajectory].count("OK"),
           "sites": [{"section": s, "site": site, "syncs": n} for (s, site), n in counts.items()]}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
