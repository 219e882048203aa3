"""How the bench's mono relocalization after the blanked frames depends on the engine's draws (ROADMAP D22, D3).

    PYTHONPATH=. python3 tools/reloc_draw_sweep.py [--device cuda|cpu] [--seeds 0-15] [--warm-end 104]
        [--out FILE.json]

Runs ``tum_mono_kf10``'s warm-up (``chip_smoke.bench_reloc_margin``: the
bench's scene, images, configuration and schedule, frames 48-51 blanked) once
per seed, with the engine's generator reseeded, so that the two-view
initialization's minimal sets, the vocabulary's first words and the PnP sets
come from another stream each time. Per seed: the frame the engine
initialized at, and at the relocalization after the blanked frames the
candidate keyframe, the matches, the PnP inliers with the engine's draw and
with 16 further draws, and the refined inliers, each beside its gate. The last
line is a JSON object with every seed's line and the share of seeds that
relocalized. Imports no JAX: it runs on the card (the default) or, with
``--device cpu``, on the CPU (each seed about 1.5 min at 2 threads with
``--warm-end 56``, which gives the same frame-52 attempt).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def seeds_arg(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", default="0-15", help="generator seeds, e.g. 0-15 or 1000,3,7")
    ap.add_argument("--warm-end", type=int, default=chip_smoke.BENCH_WARM_END)
    ap.add_argument("--threads", type=int, default=2, help="torch CPU threads")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        from dialog_tpu_torch.kernels import build
        build.load_all()
    else:
        smi = "the CPU"
    runs = [chip_smoke.bench_reloc_margin(dev, smi, seed=s, warm_end=args.warm_end) for s in seeds_arg(args.seeds)]
    out = {"device": smi, "warm_end": args.warm_end, "runs": runs,
           "relocalized": sum(r["relocalized"] for r in runs), "seeds": len(runs)}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
