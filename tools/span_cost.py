"""What one of the port's spans (``instrument.span``) costs the host that runs it.

    PYTHONPATH=. python3 tools/span_cost.py [--n 1000000] [--out PATH]

Times, on the host clock and ``--n`` times each: the check of the profiler's
flag that ``span`` makes, ``with span(...)`` with no profiler active, and
``with span(...)`` under a ``torch.profiler`` session that traces the host
(the span recorded; ``--n`` / 100 times there). Prints one JSON line with
the nanoseconds of each, the torch version and the class ``span`` records
with.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from dialog_tpu_torch import instrument


def per_call_ns(fn, n: int) -> float:
    """Nanoseconds a call of ``fn(n)``'s loop body takes, the best of three runs."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter_ns()
        fn(n)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def flag(n):
    for _ in range(n):
        autograd_profiler._is_profiler_enabled


def spans(n):
    span = instrument.span
    for _ in range(n):
        with span("slam::probe"):
            pass


def loop(n):
    for _ in range(n):
        pass


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()
    base = per_call_ns(loop, args.n)
    out = {"torch": torch.__version__, "records_with": repr(instrument._RecordFunctionFast), "n": args.n,
           "loop_ns": base}
    for name, fn in (("flag_ns", flag), ("span_off_ns", spans)):
        out[name] = per_call_ns(fn, args.n) - base
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out["span_on_ns"] = per_call_ns(spans, args.n // 100) - base
    out["spans_recorded"] = sum(1 for e in prof.profiler.kineto_results.events() if e.name() == "slam::probe")
    text = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
