"""On-card kernel parity check: each CUDA kernel against its plain version.

    python -m dialog_tpu_torch.kernels.selfcheck

At the reference's selfcheck shapes (``kernels/selfcheck.py`` of the JAX
package): kernel B as ``hamming_best2`` at n = 700, m = 900 in its four gate
cases (none, spatial, spatial + octave band, column radii) and in its mutual
mode, bit for bit; kernel A on a 123 x 210 image (neither side a multiple of
its 64 x 24 tile) at two thresholds, and in its batched launch (three
images), bit for bit; kernel C through ``optim.local_ba.solve_ba`` (5 LM
iterations) on the card against the same solve on a CPU copy (the plain
reduction), mono, stereo (a right-x on 60% of the observations) and with
half the landmarks frozen, R and t within 2e-3 and xyz within 5e-3 (the
reference's bounds). Prints one line per check and exits non-zero on a
mismatch; raises where there is no CUDA card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

SOLVE_TOL_RT = 2e-3
SOLVE_TOL_XYZ = 5e-3


def _device():
    if not torch.cuda.is_available():
        raise RuntimeError("kernels.selfcheck runs on a CUDA card, and there is none")
    return torch.device("cuda")


def check_hamming(n: int = 700, m: int = 900, seed: int = 0) -> dict:
    """Kernel B against its plain version, bit for bit: ``hamming_best2`` in
    its four gate cases, and the mutual mode."""
    from .hamming import hamming_best2, hamming_best2_filled, mutual_match_fused, mutual_match_plain

    dev = _device()
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    a = to(rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32))
    b = to(rng.integers(0, 2**32, (m, 8), dtype=np.uint32).view(np.int32))
    va, vb = to(rng.random(n) > 0.1), to(rng.random(m) > 0.1)
    uva = to(rng.uniform(0, 640, (n, 2)).astype(np.float32))
    uvb = to(rng.uniform(0, 640, (m, 2)).astype(np.float32))
    r2 = to((rng.uniform(20, 200, n) ** 2).astype(np.float32))
    oa, ob = to(rng.integers(0, 8, n).astype(np.int32)), to(rng.integers(0, 8, m).astype(np.int32))
    r2c = to((rng.uniform(20, 200, m) ** 2).astype(np.float32))
    out = {}
    for name, kw in [
        ("plain", {}),
        ("spatial", dict(uv_a=uva, uv_b=uvb, radius2=r2)),
        ("spatial+oct", dict(uv_a=uva, uv_b=uvb, radius2=r2, oct_a=oa, oct_b=ob, octave_band=1)),
        ("col-radius", dict(uv_a=uva, uv_b=uvb, radius2_cols=r2c)),
    ]:
        got = hamming_best2(a, b, va, vb, **kw)
        want = hamming_best2_filled(a, b, va, vb, **kw)
        out[name] = all(torch.equal(g, w) for g, w in zip(got, want))
    kw = dict(uv_a=uva, uv_b=uvb, radius2=r2, oct_a=oa, oct_b=ob, octave_band=1, max_dist=110, ratio=0.9)
    got = mutual_match_fused(a, b, va, vb, **kw)
    want = mutual_match_plain(a, b, va, vb, **kw)
    out["mutual"] = all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
    return out


def check_fast(h: int = 123, w: int = 210, seed: int = 1) -> dict:
    """Kernel A against its plain version, bit for bit, one image and a batch."""
    from .fast import fast_nms_rank, fast_nms_rank_levels_batch, fast_nms_rank_levels_batch_plain, \
        fast_nms_rank_plain

    dev = _device()
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
    stack = torch.from_numpy(rng.uniform(0, 255, (3, h, w)).astype(np.float32)).to(dev)
    out = {}
    for name, (min_th, th_fast, border) in [("default", (7.0, 20.0, 19)), ("low-th", (3.0, 10.0, 8))]:
        out[name] = torch.equal(fast_nms_rank(img, min_th, th_fast, border),
                                fast_nms_rank_plain(img, min_th, th_fast, border))
    levels = [stack, stack[:, ::2, ::2].contiguous()]
    got = fast_nms_rank_levels_batch(levels, 7.0, 20.0, 19)
    want = fast_nms_rank_levels_batch_plain(levels, 7.0, 20.0, 19)
    out["batch"] = all(torch.equal(g, x) for g, x in zip(got, want))
    return out


def _solve_pair(prob, cfg) -> dict:
    """``solve_ba`` on the card and on a CPU copy: max |dR|, |dt|, |dxyz|."""
    from ..optim.local_ba import solve_ba

    Rk, tk, xk, _ = solve_ba(prob, cfg, iters=5)
    cpu = type(prob)(*[x.cpu() if isinstance(x, torch.Tensor) else x for x in prob])
    Rp, tp, xp, _ = solve_ba(cpu, cfg, iters=5)
    live = cpu.lm_ids < cfg.max_landmarks
    return {"R": float((Rk.cpu() - Rp).abs().max()), "t": float((tk.cpu() - tp).abs().max()),
            "xyz": float((xk.cpu() - xp)[live].abs().max())}


def check_schur(seed: int = 0) -> dict:
    """Kernel C through ``solve_ba``: mono, stereo and half the landmarks
    frozen, each within the reference's bounds. Values: (within, max diffs)."""
    from ..optim.synth_problem import FIXTURE_CFG as CFG, make_problem

    dev = _device()
    st_cfg = CFG.replace(bf=CFG.fx * 0.12)
    mono = make_problem(seed=seed, device=dev)[0]
    stereo = make_problem(seed=seed + 1, cfg=st_cfg, stereo_frac=0.6, device=dev)[0]
    frozen = mono._replace(lm_opt=torch.from_numpy(np.random.default_rng(seed).random(mono.xyz.shape[0]) < 0.5)
                           .to(dev))
    out = {}
    for name, prob, cfg in [("mono", mono, CFG), ("stereo", stereo, st_cfg), ("frozen", frozen, CFG)]:
        d = _solve_pair(prob, cfg)
        out[name] = (d["R"] < SOLVE_TOL_RT and d["t"] < SOLVE_TOL_RT and d["xyz"] < SOLVE_TOL_XYZ, d)
    return out


def run() -> dict:
    """Every check: name -> (passed, detail)."""
    res = {f"hamming[{k}]": (v, None) for k, v in check_hamming().items()}
    res.update({f"fast[{k}]": (v, None) for k, v in check_fast().items()})
    res.update({f"schur[{k}]": v for k, v in check_schur().items()})
    return res


def main() -> int:
    res = run()
    print("device:", torch.cuda.get_device_name(0))
    for name, (ok, detail) in res.items():
        print(f"{name}: {'OK' if ok else 'MISMATCH'}" + (f" {detail}" if detail else ""))
    return 0 if all(ok for ok, _ in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
