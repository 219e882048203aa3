"""How large float32 rounding reads in kernel C's reduced camera system, under each candidate measure.

On the card, over a configuration's own windows (the benchmark's scene and
entry, set-up then ``--batches`` batches of 8)::

    python3 -m bench_port.tools.schur_study --seed N [--config kitti00_stereo] [--save PATH]

keeps every call of ``kernels.schur.schur_reduce`` (kernel C) and reads it
against the float64 reference with the compared measures of
``reference.schur.measures`` and this study's others (``study_measures``); beside it the reference's own float32 and TF32
runs, and each window's conditioning (the largest condition number of a
landmark's damped Hll). ``--save`` writes up to ``--keep`` of the windows'
inputs, the landmarks without a live observation left out (they add nothing
to the reduction). On the CPU, the saved windows through the port's plain
float32 reduction (``schur_reduce_plain``) against the same reference::

    python3 -m bench_port.tools.schur_study --load PATH [PATH ...]

Prints one JSON line per window and a summary line.
"""

from __future__ import annotations

import argparse
import json

import torch

NAMES = ("R", "t", "cam_opt", "xyz", "obs_cam", "obs_uv", "obs_w", "lam")


def _inputs(args, kwargs) -> dict:
    d = dict(zip(NAMES, args[:8]))
    d.update(delta2=kwargs.get("delta2", 5.991), delta2_stereo=kwargs.get("delta2_stereo", 7.815),
             obs_ur=kwargs.get("obs_ur"), bf=kwargs.get("bf", 0.0))
    return d


def _compact(inp: dict) -> dict:
    """The window without its landmarks that have no live observation, on the CPU."""
    C = inp["R"].shape[0]
    live = ((inp["obs_w"] > 0) & (inp["obs_cam"] >= 0) & (inp["obs_cam"] < C)).any(dim=1)
    out = {}
    for k, v in inp.items():
        if isinstance(v, torch.Tensor):
            v = v[live] if k in ("xyz", "obs_cam", "obs_uv", "obs_w", "obs_ur") else v
            v = v.detach().cpu().clone()
        out[k] = v
    return out


def _cond(ref: dict) -> float:
    ev = torch.linalg.eigvalsh(ref["Hll_d"])
    live = ref["ok"].any(dim=1)
    return float((ev[:, -1] / ev[:, 0].clamp(min=1e-300))[live].max()) if bool(live.any()) else 0.0


def study_measures(prog: dict, ref: dict, inp: dict) -> dict:
    """The compared measures, and the candidates the study read beside them:

    * ``s_rel``: |dS|_F / |S|_F, against the reduced system itself (PR 14's kind of measure);
    * ``g_terms``: |d(g_c - g_red)| / (|g_c| + |g_red|), the reduced gradient against its terms;
    * ``y_rel``: |dY|_F / |Y|_F and ``gl_rel``: |dg_l| / |g_l|, the landmark side's outputs that hold no
      inverse."""
    from bench_port.reference import schur as ref_schur

    d = lambda k: prog[k].double() - ref[k].double()  # noqa: E731
    n = lambda x: float(torch.linalg.norm(x.double().reshape(-1)))  # noqa: E731
    out = ref_schur.measures(prog, ref, inp["cam_opt"], float(inp["lam"]))
    dS = -d("S_pair")
    S = -ref["S_pair"].double().clone()
    ar = torch.arange(dS.shape[0])
    dS[ar, :, ar, :] += d("Hcc")
    S[ar, :, ar, :] += ref["Hcc"].double()
    out.update(s_rel=n(dS) / max(n(S), 1e-300),
               g_terms=n(d("g_c") - d("g_red")) / max(n(ref["g_c"]) + n(ref["g_red"]), 1e-300),
               y_rel=n(d("Y")) / max(n(ref["Y"]), 1e-300), gl_rel=n(d("g_l")) / max(n(ref["g_l"]), 1e-300))
    return out


FAULTS = {   # the landmark side of the program's answer altered, as a fault in kernel C would
    "Y_1pct": lambda o: dict(o, Y=o["Y"] * 1.01),
    "g_l_1pct": lambda o: dict(o, g_l=o["g_l"] * 1.01),
    "Hll_inv_1pct": lambda o: dict(o, Hll_inv=o["Hll_inv"] * 1.01),
}


def _line(i, inp, cam, program: dict, modes, faults=()) -> dict:
    from bench_port.reference import schur as ref_schur

    c = dict(cam, bf=inp["bf"])
    ref = ref_schur.reduce(inp, c, "f64")
    line = {"window": i, "lam": float(inp["lam"]), "max_cond_hll": _cond(ref),
            "program": study_measures(program, ref, inp)}
    for mode in modes:
        line[mode] = study_measures(ref_schur.reduce(inp, c, mode), ref, inp)
    for name in faults:
        line[name] = study_measures(FAULTS[name](program), ref, inp)
    return line


def _summarise(lines) -> dict:
    out = {"windows": len(lines), "max_cond_hll": max((ln["max_cond_hll"] for ln in lines), default=0.0)}
    for ln in lines:
        for side, meas in ln.items():
            if not isinstance(meas, dict):
                continue
            s = out.setdefault(side, {})
            for k, v in meas.items():
                lo, hi = s.get(k, (float("inf"), 0.0))
                s[k] = (min(lo, v), max(hi, v))
    return out


def on_card(args) -> None:
    from bench_port.checks import _SCHUR_OUT
    from bench_port.harness import HERE, Runner, camera, load_json

    import dialog_tpu_torch  # noqa: F401  (pins exact float32 products)

    conf = load_json(HERE / "configs" / f"{args.config}.json")
    traffic = load_json(HERE / "traffic" / "batch8.json")
    traffic["samples"] = {"schur": 100000}
    runner = Runner(conf, traffic, args.seed, torch.device(args.device), traced=False)
    runner.warm_up()
    runner.probes.install()
    try:
        for _ in range(args.batches):
            runner.feed_batch()
        runner.eng.flush()
    finally:
        runner.probes.remove()
    cam = camera(conf)
    calls = [x for x in runner.probes.samples["schur"].items if x is not None]
    lines, keep = [], []
    every = max(1, len(calls) // max(args.keep, 1))
    for i, (a, kw, out) in enumerate(calls):
        inp = _inputs(a, kw)
        line = _line(i, inp, cam, dict(zip(_SCHUR_OUT, out)), ("f32", "tf32"))
        print(json.dumps(line), flush=True)
        lines.append(line)
        if args.save and i % every == 0 and len(keep) < args.keep:
            keep.append(_compact(inp))
    if args.save:
        torch.save({"config": args.config, "seed": args.seed, "cam": cam, "windows": keep}, args.save)
    print(json.dumps({"summary": _summarise(lines), "seed": args.seed, "config": args.config}), flush=True)


def on_cpu(args) -> None:
    from dialog_tpu_torch.kernels.schur import schur_reduce_plain

    from bench_port.checks import _SCHUR_OUT

    lines = []
    for path in args.load:
        saved = torch.load(path, weights_only=False)
        cam = saved["cam"]
        for inp in saved["windows"]:
            out = schur_reduce_plain(inp["R"], inp["t"], inp["cam_opt"], inp["xyz"], inp["obs_cam"], inp["obs_uv"],
                                     inp["obs_w"], inp["lam"], cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                                     delta2=inp["delta2"], obs_ur=inp["obs_ur"], bf=inp["bf"],
                                     delta2_stereo=inp["delta2_stereo"])
            line = _line(len(lines), inp, cam, dict(zip(_SCHUR_OUT, out)), ("f32", "tf32"), tuple(FAULTS))
            line.update(seed=saved["seed"], config=saved["config"])
            print(json.dumps(line), flush=True)
            lines.append(line)
    print(json.dumps({"summary": _summarise(lines), "files": args.load}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="kitti00_stereo")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", default=None)
    ap.add_argument("--keep", type=int, default=4)
    ap.add_argument("--load", nargs="*", default=None)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.load:
        on_cpu(args)
    else:
        on_card(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
