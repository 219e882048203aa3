"""Run one cell of the port's benchmark on one CUDA card and print its result.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, output-check limits and per-layer
metrics are found by the names in ``BENCHMARK.json`` (at the root of the
checkout): ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json``, ``metrics/<metric>.py``. Set-up renders the
configuration's scene, builds the port's kernels where the checkout has not
built them yet (``build/dialog_tpu_torch/``), and warms the cell's entry; the
window then feeds the traffic for ``--seconds``. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from profiled
stretches after the window. The seed draws which answers the check samples. Then the sampled answers of the window are held to the
plain reference (``checks.py``), and the last stdout line is the result:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` and, traced,
``breakdown``; ``checks`` (each compared number and its limit) comes last, and
the same numbers are the last lines of stderr.

``--control 1`` also reads the reference's float32 and TF32 runs, and two
pose faults planted in it, against its float64 run (the limits' upper ends);
``--device cpu`` skips the look for a card (the harness's own tests at a tiny
size).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dialog_tpu")
# One process, few threads: the port's host path is one Python thread launching kernels, and the
# libraries' default pools of spinning threads (one a core) only contend with it for the cores.
THREADS = 1
_POOLS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def fail(msg: str, code: int = 2):
    print(f"bench_port: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot, compared whole) is forbidden."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_of(bench: dict, workload: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        fail(f"no workload {workload!r} in BENCHMARK.json")
    return cells[workload]


def breakdown(tr, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps by the host range open in them."""
    from .trace import within

    by_name = {}
    for e in tr.device:
        by_name[e.name] = by_name.get(e.name, 0) + e.dur_ns
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((e.start_ns, e.start_ns + e.dur_ns) for e in tr.device)
    gaps, end = {}, None
    layers = sorted(tr.ranges, key=lambda k: sum(e - s for s, e in tr.ranges[k]))   # innermost (shortest) first
    for s, e in spans:
        if end is not None and s > end:
            mid = (s + end) // 2
            who = next((k for k in layers if within(tr.ranges[k], mid)), "outside the harness's ranges")
            gaps[who] = gaps.get(who, 0) + (s - end)
        end = e if end is None else max(end, e)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:120], v * 1e-9] for k, v in ops], "idle_gaps": [[k, v * 1e-9] for k, v in idle]}


def build_trace(window: dict, runner):
    """The ``Trace`` of a traced run: the device's busy and traced seconds from the stretch traced on
    the device alone, everything else from the stretch traced on host and device, with the roofline
    work of each kernel's calls counted."""
    import torch

    from .trace import Trace, reduce_events, union_seconds

    cuda = torch.autograd.DeviceType.CUDA
    dev_only = window["trace"]["device"]
    dev_events = reduce_events(dev_only["prof"].profiler.kineto_results.events(), cuda)[0]
    tr = window["trace"]["host"]
    device, host, ranges = reduce_events(tr["prof"].profiler.kineto_results.events(), cuda)
    sh = runner.probes.shapes
    schur = []
    for w in sh["schur"]:
        C = w["C"]
        live = (w["obs_w"] > 0) & (w["obs_cam"] >= 0) & (w["obs_cam"] < C)
        n = live.sum(dim=1)
        schur.append({"n_cams": C, "n_points": int((n > 0).sum()), "n_obs": int(n.sum()),
                      "n_pairs": int((n * (n + 1) // 2).sum()), "stereo": w["stereo"]})
    frame_ms = [1e3 * s for s in runner.frame_s]
    busy_s = 1e-9 * union_seconds((e.start_ns, e.start_ns + e.dur_ns) for e in dev_events)
    return Trace(window_s=dev_only["window_s"], busy_s=busy_s,
                 device=device, host=host, ranges=ranges, frames=tr["frames"], keyframes=tr["keyframes"],
                 shapes={"fast": sh["fast"], "hamming": sh["hamming"], "schur": schur}, frame_ms=frame_ms,
                 busy_frames=dev_only["frames"],
                 window_rate=window["content"]["frames"] / max(window["content"]["seconds"], 1e-9))


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, conf: dict | None = None, traffic: dict | None = None,
             limits: dict | None = None) -> dict:
    """One run; returns the result line's object (``checks`` last) and prints the earlier lines."""
    import torch

    from . import checks
    from .harness import Runner, load_json

    cell = cell_of(bench, workload)
    conf = conf or load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = traffic or load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    dev = torch.device(device)
    if dev.type == "cuda":
        from dialog_tpu_torch.kernels import build

        build.load_all()
        torch.cuda.reset_peak_memory_stats(dev)
    import dialog_tpu_torch  # noqa: F401  (pins exact float32 products)

    runner = Runner(conf, traffic, seed, dev, traced=trace)
    setup = runner.warm_up()
    profiler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        def profiler(host: bool):
            if dev.type != "cuda":
                return profile(activities=[ProfilerActivity.CPU])
            return profile(activities=([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA])
    # objects made by set-up are left out of the collector's later passes: a full pass over them
    # inside the window is a pause of a size set by set-up, not by the window's work
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    window = runner.window(seconds, profiler)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    content = dict(window["content"], setup=setup)
    print(json.dumps({"window": content}), flush=True)

    metrics = {}
    out_device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
    result_extra = {}
    names = [m for m in (bench["per_layer"] if trace else bench["end_to_end"])
             if "workloads" not in m or workload in m["workloads"]]
    if trace:
        tr = build_trace(window, runner)
        out_device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        for m in names:
            v = load_reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result_extra["breakdown"] = breakdown(tr)
        kernels = {k: sum(1 for e in tr.device if k in e.name) for k in ("fast_levels", "hamming_", "schur_")}
        stretches = {k: {"frames": v["frames"], "seconds": v["window_s"], "keyframes": v["keyframes"]}
                     for k, v in window["trace"].items()}
        print(json.dumps({"traced": {"stretches": stretches, "window_frames_timed": len(tr.frame_ms),
                                     "kernel_events": kernels}}), flush=True)
        window["trace"].clear()
    else:
        values = {"frames_per_s": content["frames"] / content["seconds"], "setup_s": setup_s}
        for m in names:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    # the program's state goes before the reference runs; the samples keep what the check reads
    gc.unfreeze()
    del runner.eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers, other = checks.run(runner, window, control)
    limits = limits or load_json(HERE / "limits" / f"{workload}.json")
    correct, table = checks.verdict(numbers, limits)
    missing = [k for k in limits if k not in table]
    if missing:
        correct = False
        other["missing"] = missing
    print(json.dumps({"readings": numbers, **other}), flush=True)
    lv = window["liveness"]
    return {"correct": correct, "attempted": content["frames"], "failed": lv["lost"] + lv["unanswered"],
            "metrics": metrics, "device": out_device, **result_extra, "checks": table}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    for var in _POOLS:   # before numpy and torch are loaded
        os.environ[var] = str(THREADS)
    bench_path = HERE.parent / "BENCHMARK.json"
    if not bench_path.exists():
        fail(f"{bench_path} is missing")
    with open(bench_path) as f:
        bench = json.load(f)
    cell = cell_of(bench, args.workload)
    import torch

    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(1)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            fail("no CUDA device: this benchmark measures the port on a card")
        if torch.cuda.device_count() < int(cell["chips"]):
            fail(f"the cell needs {cell['chips']} cards, {torch.cuda.device_count()} are visible")
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), args.device, bool(args.control))
    bad = forbidden_modules()
    if bad:
        fail("modules of JAX or the JAX package are loaded: " + ", ".join(bad))
    for name, (v, lim) in result["checks"].items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
