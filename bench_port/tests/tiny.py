"""Tiny configurations of the benchmark's two kinds of cell, for its CPU tests.

Besides the cells of ``BENCHMARK.json``, the tests drive the queued cells whose
configuration and traffic files are here already (a stereo configuration
through the batched entry, and the per-frame entry), with their per-layer
metrics, at a tiny size and with the limits of ``QUEUED``."""

from __future__ import annotations

import copy
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent.parent


def _load(path):
    with open(path) as f:
        return json.load(f)


QUEUED_CELLS = [
    {"name": "kitti00_stereo.batch8", "config": "kitti00_stereo", "traffic": "batch8", "chips": 1, "why": "tests"},
    {"name": "tum1_mono.online", "config": "tum1_mono", "traffic": "online", "chips": 1, "why": "tests"},
]
QUEUED_METRICS = [
    {"name": "stereo_device_ms", "unit": "ms/frame", "workloads": ["kitti00_stereo.batch8"]},
    {"name": "track_host_ms.step", "unit": "ms/frame", "workloads": ["tum1_mono.online"]},
    {"name": "frame_ms_p95.online", "unit": "ms", "workloads": ["tum1_mono.online"]},
]
# the queued cells' limits in these tests: the batched mono cell's, and the stereo right-x's
QUEUED = {"kitti00_stereo.batch8": {"ur_err": 0.005}, "tum1_mono.online": {}}


def bench() -> dict:
    """``BENCHMARK.json`` with the queued cells and their metrics."""
    b = _load(HERE.parent / "BENCHMARK.json")
    names = {w["name"] for w in b["workloads"]}
    b["workloads"] += [w for w in QUEUED_CELLS if w["name"] not in names]
    metrics = {m["name"] for m in b["per_layer"]}
    b["per_layer"] += [m for m in QUEUED_METRICS if m["name"] not in metrics]
    for m in b["per_layer"]:
        if "workloads" in m and m["name"] not in {q["name"] for q in QUEUED_METRICS}:
            m["workloads"] = m["workloads"] + [w["name"] for w in QUEUED_CELLS]
    return b


def config(name: str) -> dict:
    """``configs/<name>.json`` at a size the CPU runs in seconds a frame: smaller images,
    fewer features and smaller capacities; the scene's kind and the limits as they are."""
    conf = copy.deepcopy(_load(HERE / "configs" / f"{name}.json"))
    e = conf["engine"]
    if conf["scene"].get("stereo"):
        e.update(width=620, height=188, fx=359.428, fy=359.428, cx=303.6, cy=92.6, bf=193.0724, n_features=600,
                 max_features=640)
        conf["scene"].update(points=6000, frames=168)
    else:
        e.update(width=320, height=240, cx=159.3, cy=127.7, fx=258.7, fy=258.2, n_features=300, max_features=320)
        conf["scene"].update(points=1200, frames=200)
    e.update(max_keyframes=48, max_landmarks=4096, max_new_landmarks=1024, max_local_kfs=8, max_fixed_kfs=8,
             max_local_lms=1024, max_local_obs=4096, vocab_words=128, local_ba_iters=3, max_frames_between_kf=8)
    return conf


def limits(workload: str) -> dict:
    path = HERE / "limits" / f"{workload}.json"
    if path.exists():
        return _load(path)
    return dict(_load(HERE / "limits" / "tum1_mono.batch8.json"), **QUEUED[workload])


def traffic(name: str) -> dict:
    t = copy.deepcopy(_load(HERE / "traffic" / f"{name}.json"))
    t.update(warm_kfs=3, warm_max_frames=60, trace_frames=8)
    t["samples"] = {"frames": 2, "match": 3, "pose": 8, "schur": 2}
    return t
