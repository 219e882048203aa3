"""One rank of a landmark-sharded global BA, or of a block BA over a
process group, as a process of its own.

    python -m dialog_tpu_torch.gba_rank JOB.json RANK

``JOB.json`` holds ``address`` (``tcp://host:port`` of rank 0), ``world``
(the number of ranks), ``backend`` (``gloo`` or ``nccl``), ``device``
(``cpu`` or ``cuda``) and ``jobs``: a list of ``{"config": {field: value},
"map": "<save_map .npz>", "iters": n, "out": "<.npz>"}``, each with an
optional ``"pcg": {"cg_iters": n, "cg_tol": x}`` (the PCG branch's CG budget). The rank joins the
group (``distributed.initialize``), and for each job loads the map, runs
``optim.global_ba.global_bundle_adjustment`` on it over the group (each rank
its slice of the landmarks) and writes the map's ``R``, ``t``, ``xyz`` and
``obs_lm`` after it, with the solve's wall seconds, the group's size, the
landmark rows this rank held (and how many of them live) and its launches of
kernel C, into ``out`` with ``.rank<RANK>`` before the
suffix. A job with ``"kind": "block"`` runs
``optim.block_ba.block_bundle_adjustment`` instead, with the job's
``n_blocks``, ``rounds``, ``iters``, ``cams_pb`` and ``lms_pb`` (each rank
solves its share of the active blocks), and writes its two drop counts
beside. A job with ``"kind": "problem"`` loads a ``BAProblem`` saved as an
``.npz`` of its fields (``"problem"``), takes this rank's landmark slice
(``global_ba.shard_problem``) and times ``timed_solve`` on it over the
group: ``seconds`` is then per LM iteration. Every rank must
be given the same jobs. With ``device`` ``cuda`` rank r runs on card r
modulo the cards there are.

Several ranks may share one card with the gloo backend, which carries CUDA
tensors (NCCL refuses two ranks on one device). ``launch`` starts the ranks
of a job file from a parent process and reads their results back.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BLOCK_ARGS = ("n_blocks", "rounds", "iters", "cams_pb", "lms_pb")   # a block job's arguments
SCHUR_COUNTS = ("schur_reduce", "schur_reduce_stereo", "schur_reduce_frozen")
WARM_ITERS, TIMED_ITERS = 2, 5   # a problem job's solves: one to warm up, one timed


def config_to_json(cfg) -> dict:
    """An ``EngineConfig`` as plain JSON values (the sensor by its value)."""
    import dataclasses

    return {f.name: (v.value if f.name == "sensor" else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


def config_from_json(d: dict):
    from .config import EngineConfig, Sensor

    return EngineConfig(**{k: (Sensor(v) if k == "sensor" else v) for k, v in d.items()})


def rank_out(path: str, rank: int) -> str:
    stem, dot, suffix = path.rpartition(".")
    return f"{stem}.rank{rank}{dot}{suffix}" if dot else f"{path}.rank{rank}"


def free_address() -> str:
    """A ``tcp://`` address on this host whose port was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def launch(spec: dict, job_path: str, timeout: float, cwd=None) -> list[list[dict]]:
    """Write ``spec`` to ``job_path``, run its ``world`` ranks as processes
    to their end (each killed after ``timeout`` seconds), raise if any
    failed, and return each rank's outputs, job by job."""
    with open(job_path, "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen([sys.executable, "-m", "dialog_tpu_torch.gba_rank", job_path, str(r)], cwd=cwd,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(spec["world"])]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, logs[r][1][-2000:] if r < len(logs) else "") for r, p in enumerate(procs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"global BA ranks failed: {failed}")
    return [[dict(np.load(rank_out(job["out"], r))) for job in spec["jobs"]] for r in range(spec["world"])]


def timed_solve(prob, cfg, group=None) -> float:
    """Seconds per LM iteration of the global BA's solve
    (``global_ba.solve_global_problem``) of ``prob`` over ``group``:
    ``TIMED_ITERS`` iterations after ``WARM_ITERS`` (the device synchronised
    on the card)."""
    from .optim.global_ba import solve_global_problem

    sync = torch.cuda.synchronize if prob.R.device.type == "cuda" else (lambda: None)
    solve_global_problem(prob, cfg, WARM_ITERS, group)
    sync()
    t0 = time.perf_counter()
    solve_global_problem(prob, cfg, TIMED_ITERS, group)
    sync()
    return (time.perf_counter() - t0) / TIMED_ITERS


def solve_problem(job: dict, cfg, device, rank: int, group) -> None:
    """A ``"problem"`` job: this rank's slice of the saved problem, timed."""
    import torch.distributed as dist

    from .optim.global_ba import shard_problem
    from .optim.local_ba import BAProblem

    with np.load(job["problem"]) as z:
        prob = BAProblem(**{k: torch.from_numpy(z[k]).to(device) for k in z.files})
    part = shard_problem(prob, group) if group is not None else prob
    dist.barrier(group)
    seconds = timed_solve(part, cfg, group)
    np.savez(rank_out(job["out"], rank), seconds=seconds, world=dist.get_world_size(group) if group else 1,
             rows_held=part.lm_ids.shape[0])


def main(argv=None) -> int:
    import torch.distributed as dist

    from . import distributed
    from .containers import load_map
    from .kernels import common
    from .optim.block_ba import block_bundle_adjustment
    from .optim.global_ba import global_bundle_adjustment

    job_path, rank = (argv or sys.argv[1:])[:2]
    rank = int(rank)
    with open(job_path) as f:
        spec = json.load(f)
    torch.set_num_threads(2)
    if spec["device"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    distributed.initialize(spec["address"], spec["world"], rank, backend=spec["backend"])
    group = distributed.default_group()
    try:
        for job in spec["jobs"]:
            cfg = config_from_json(job["config"])
            if job.get("kind") == "problem":
                solve_problem(job, cfg, spec["device"], rank, group)
                continue
            m = load_map(cfg, job["map"], device=spec["device"])
            dist.barrier(group)
            common.reset_launch_counts()
            t0 = time.perf_counter()
            stats = {}
            if job.get("kind") == "block":
                out = block_bundle_adjustment(m, cfg, **{k: job[k] for k in BLOCK_ARGS}, group=group, stats=stats)
            else:
                out = global_bundle_adjustment(m, cfg, iters=job["iters"], group=group, **job.get("pcg", {}))
            if spec["device"] == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            world = dist.get_world_size(group) if group is not None else 1
            lo, hi, per = distributed.landmark_slice(cfg.max_landmarks, rank, world)
            np.savez(rank_out(job["out"], rank), R=out.kfs.R.cpu().numpy(), t=out.kfs.t.cpu().numpy(),
                     xyz=out.lms.xyz.cpu().numpy(), obs_lm=out.kfs.obs_lm.cpu().numpy(), seconds=seconds,
                     world=world, rows_held=per, live_held=int(m.lms.valid[lo:hi].sum()),
                     schur_launches=sum(common.launches[k] for k in SCHUR_COUNTS),
                     **{k: stats.get(k, 0) for k in ("block_ba_obs_dropped", "block_ba_kf_dropped")})
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
