"""The JAX reference engine on the port's stereo and RGB-D workloads.

    JAX_PLATFORMS=cpu python tools/reference_ate.py stereo
    JAX_PLATFORMS=cpu python tools/reference_ate.py rgbd

Runs ``dialog_tpu``'s ``Engine.track_stereo`` / ``track_rgbd`` on the same
rendered frames that ``chip_smoke.py`` feeds the port
(``dialog_tpu_torch.profile_main_path.WORKLOADS``), with loop closing off and
no vocabulary within the run, so that it takes the port's path. Prints the
state per frame, the keyframe count and the metric ATE (no scale alignment)
over the OK frames. ``chip_smoke.py`` takes its stereo ATE bound from this
run (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import time

import jax.numpy as jnp
import numpy as np

from dialog_tpu.config import EngineConfig as JConfig, Sensor as JSensor
from dialog_tpu.eval.ate import ate_rmse
from dialog_tpu.system import Engine
from dialog_tpu_torch.profile_main_path import WORKLOADS


def reference_config(tcfg) -> JConfig:
    kw = {f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__ if f != "sensor"}
    return JConfig(**kw, sensor=JSensor(tcfg.sensor.value)).replace(vocab_min_kfs=1000)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workload", choices=["stereo", "rgbd"])
    args = ap.parse_args()
    make_cfg, make_frames, method, fps = WORKLOADS[args.workload]
    tcfg = make_cfg()
    scene, frames = make_frames(tcfg)
    eng = Engine(reference_config(tcfg))
    eng.loop_closing_enabled = False
    t0 = time.perf_counter()
    for i, x in enumerate(frames):
        rec = getattr(eng, method)(*[jnp.asarray(a) for a in x], float(i) / fps)
        print(f"frame {i}: {rec.state} tracked={rec.n_tracked} kfs={eng.kf_count} "
              f"t={time.perf_counter() - t0:.1f}s", flush=True)
    ok = np.array([r.state == "OK" for r in eng.trajectory])
    est = eng.positions[ok]
    gt = np.stack([-scene.R[i].T @ scene.t[i] for i in range(len(frames))])[ok]
    out = {"workload": args.workload, "frames": len(frames), "state": eng.state, "kf_count": eng.kf_count,
           "ok_frames": int(ok.sum()), "first_ok": int(np.argmax(ok)) if ok.any() else -1,
           "ate_m": float(ate_rmse(est, gt, with_scale=False)) if ok.sum() >= 3 else None}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
