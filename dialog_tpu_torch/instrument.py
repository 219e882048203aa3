"""Observability: structured run logging, timing, and profiler hooks.

The reference's only observability is stdout banners and an end-of-run
timing printout (SURVEY.md §5 "Metrics / logging"). Here: a JSONL run log
with per-frame records and the engine's capacity events, a frame timer with
percentile stats, and a ``torch.profiler`` trace context that writes a
Chrome trace (chrome://tracing or Perfetto read it).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional


class RunLogger:
    """Per-frame JSONL log (state, tracked count, pose, wall time)."""

    def __init__(self, path: Optional[str] = None):
        self._f = open(path, "w") if path else None
        self.frames = 0

    def log_frame(self, rec, wall_s: float, extra: dict[str, Any] | None = None):
        self.frames += 1
        if self._f is None:
            return
        row = {
            "frame": rec.frame_id,
            "ts": rec.timestamp,
            "state": rec.state,
            "tracked": rec.n_tracked,
            "ref_kf": rec.ref_kf,
            "wall_ms": round(wall_s * 1e3, 3),
            "t": [round(float(x), 6) for x in rec.t],
        }
        if extra:
            row.update(extra)
        self._f.write(json.dumps(row) + "\n")

    def log_event(self, kind: str, **kw):
        if self._f is None:
            return
        self._f.write(json.dumps({"event": kind, **kw}) + "\n")

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class FrameTimer:
    """Wall-clock stats matching the reference mains' median/mean printout."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def stats(self) -> dict[str, float]:
        import numpy as np

        if not self.times:
            return {}
        t = np.sort(np.asarray(self.times))
        return {
            "median_ms": float(np.median(t) * 1e3),
            "mean_ms": float(t.mean() * 1e3),
            "p90_ms": float(np.percentile(t, 90) * 1e3),
            "fps": float(1.0 / max(t.mean(), 1e-9)),
        }


@contextlib.contextmanager
def profile_trace(logdir: str, device="cuda"):
    """Trace the block under ``torch.profiler`` (the host, and the card's
    kernels unless ``device`` is the CPU) and write it to
    ``logdir/trace.json`` as a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
