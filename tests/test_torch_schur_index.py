"""Kernel C's index of observations by camera, and the port's default device.

All on the CPU, where ``schur_reduce`` takes its plain version:

* ``camera_index`` on seeded slots with pads, negative cameras, zero weights,
  a camera nobody observes and a landmark that sees one camera twice:
  ``cam_ptr`` monotone and ending at the number of live slots, each camera's
  slots in increasing flat order (the order the kernel sums in), every live
  slot exactly once;
* the kernel's data flow replayed in numpy (per-slot terms from the plain
  version's own pieces, repeated cameras of a landmark merged into the
  first, camera-side sums walked through the index, S_pair from camera
  pairs c <= d and their transpose) against ``schur_reduce_plain``: 1e-5 of
  each output's largest magnitude (f32 terms, summed in float64 in another
  order);
* ``schur_reduce(..., cam_index=idx)`` and ``solve_ba`` on CPU tensors are the
  plain path bit for bit, index or not;
* every entry point that makes tensors defaults to the card: without one it
  raises, and with ``device="cpu"`` it does not.
"""

import numpy as np
import pytest
import torch

from dialog_tpu.optim.synth_problem import FIXTURE_CFG, make_problem
from dialog_tpu_torch import containers, interop
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.datasets import synth
from dialog_tpu_torch.kernels import schur
from dialog_tpu_torch.optim import local_ba as tba
from dialog_tpu_torch.optim.lm import chol3x3, huber_weight, tri_inv3x3_lower
from dialog_tpu_torch.system import Engine

import jax

torch.set_num_threads(2)

CFG = EngineConfig(max_features=64, max_keyframes=8, max_landmarks=256, max_local_lms=64,
                   max_local_kfs=3, max_fixed_kfs=2, max_obs_per_lm=6)
BF = CFG.fx * 0.12


def _slots(seed, C, P, O):
    """Seeded obs_cam / obs_w: pads (camera C), negative cameras, zero
    weights; camera C-1 unobserved, landmark 0 dead, landmark 1 sees camera 1
    in its first two slots."""
    rng = np.random.default_rng(seed)
    obs_cam = rng.integers(0, C - 1, (P, O)).astype(np.int32)
    obs_w = rng.choice([0.0, 1.0, 0.694, 0.482], (P, O), p=[0.15, 0.35, 0.3, 0.2]).astype(np.float32)
    obs_cam[rng.random((P, O)) < 0.2] = C
    obs_cam[rng.random((P, O)) < 0.05] = -2
    obs_cam[0] = C
    obs_cam[1, :2], obs_w[1, :2] = 1, 1.0
    return obs_cam, obs_w


def _problem(seed, C=5, P=40, O=6, stereo=False):
    """``schur_reduce`` arguments around ``_slots``: cameras near the identity,
    points in a box in front of them, observed where they project plus noise."""
    from dialog_tpu_torch import geometry as geo

    rng = np.random.default_rng(seed + 1000)
    obs_cam, obs_w = _slots(seed, C, P, O)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    R, t = geo.se3_retract(torch.eye(3).repeat(C, 1, 1), torch.zeros(C, 3), f32(rng.normal(0, 0.05, (C, 6))))
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(5, 10, P)], -1)
    safe = np.clip(obs_cam, 0, C - 1)
    Xc = np.einsum("poij,pj->poi", R.numpy()[safe], pts) + t.numpy()[safe]
    obs_uv = np.stack([CFG.fx * Xc[..., 0] / Xc[..., 2] + CFG.cx, CFG.fy * Xc[..., 1] / Xc[..., 2] + CFG.cy], -1)
    obs_uv += rng.normal(0, 1.5, obs_uv.shape)
    obs_ur = np.where(rng.random((P, O)) < 0.5, obs_uv[..., 0] - BF / Xc[..., 2] + rng.normal(0, 1.0, (P, O)), -1.0)
    cam_opt = np.ones(C, bool)
    cam_opt[0] = False
    args = (R.contiguous(), t.contiguous(), torch.tensor(cam_opt), f32(pts), torch.tensor(obs_cam), f32(obs_uv),
            torch.tensor(obs_w), torch.tensor(1e-2), CFG.fx, CFG.fy, CFG.cx, CFG.cy, CFG.chi2_mono)
    kw = dict(obs_ur=f32(obs_ur), bf=BF, delta2_stereo=CFG.chi2_stereo) if stereo else {}
    return args, kw


@pytest.mark.parametrize("seed,C,P,O", [(0, 5, 40, 6), (1, 2, 7, 1), (2, 33, 101, 12), (3, 64, 64, 16)])
def test_camera_index_groups_every_live_slot_once(seed, C, P, O):
    obs_cam, obs_w = _slots(seed, max(C, 3), P, max(O, 2))
    C, O = max(C, 3), max(O, 2)
    idx = schur.camera_index(torch.tensor(obs_cam), torch.tensor(obs_w), C)
    ptr, obs = idx.cam_ptr.numpy(), idx.cam_obs.numpy()
    live = (obs_cam >= 0) & (obs_cam < C) & (obs_w > 0)
    assert ptr.dtype == np.int32 and obs.dtype == np.int32
    assert ptr.shape == (C + 1,) and obs.shape == (P * O,)
    assert ptr[0] == 0 and np.all(np.diff(ptr) >= 0) and ptr[-1] == live.sum()
    assert ptr[C - 1] == ptr[C]                                      # the unobserved camera's list is empty
    assert sorted(obs[: ptr[-1]]) == list(np.flatnonzero(live.reshape(-1)))   # every live slot, once
    assert sorted(obs) == list(range(P * O))                        # the rest are the dead slots
    for c in range(C):
        mine = obs[ptr[c]:ptr[c + 1]]
        assert np.all(obs_cam.reshape(-1)[mine] == c)
        assert np.all(np.diff(mine) > 0)                            # increasing flat order
    both = obs[ptr[1]:ptr[2]]
    assert O in both and O + 1 in both                              # landmark 1's two slots of camera 1


def _replay_kernel(args, kw, idx):
    """The CUDA kernel's data flow in numpy, sums in float64."""
    R, t, cam_opt, xyz, obs_cam, obs_uv, obs_w, lam, fx, fy, cx, cy, delta2 = args
    obs_ur, bf, d2s = kw.get("obs_ur"), kw.get("bf", 0.0), kw.get("delta2_stereo", 7.815)
    C, (P, O) = R.shape[0], obs_cam.shape
    valid = (obs_w > 0.0) & (obs_cam >= 0) & (obs_cam < C)
    r, J_c, J_l, ok = schur.observation_terms(R, t, xyz, obs_cam, obs_uv, valid, fx, fy, cx, cy, cam_opt, obs_ur, bf)
    chi2 = torch.sum(r * r, -1) * obs_w
    w = torch.where(ok, obs_w * huber_weight(chi2, schur.observation_delta2(obs_ur, bf, delta2, d2s)), 0.0)
    Hll = torch.einsum("poki,po,pokj->pij", J_l, w, J_l)
    g_l = torch.einsum("poki,po,pok->pi", J_l, w, r)
    dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Li = tri_inv3x3_lower(chol3x3(Hll + (lam * torch.clamp(dll, min=1e-9) + 1e-9)[..., None] * torch.eye(3)))
    Hi = torch.einsum("pki,pkj->pij", Li, Li)
    Y = torch.einsum("poki,po,pokj->poij", J_c, w, J_l)
    # per-slot scratch: Z, the camera-side summands, the slot's S_pair camera
    Z = torch.einsum("poij,pjk->poik", Y, Li.transpose(-1, -2)).double().numpy().reshape(P * O, 6, 3)
    terms = dict(Hcc=torch.einsum("poki,po,pokj->poij", J_c, w, J_c), g_c=torch.einsum("poki,po,pok->poi", J_c, w, r),
                 g_red=torch.einsum("poij,pjk,pk->poi", Y, Hi, g_l))
    counts = (ok & cam_opt[torch.clamp(obs_cam, 0, C - 1).long()]).numpy()
    cam = obs_cam.numpy()
    scam = np.full(P * O, -1)
    for p in range(P):
        first = {}
        for o in range(O):
            if not counts[p, o]:
                continue
            if cam[p, o] in first:                       # a repeated camera: merged into its first slot
                Z[first[cam[p, o]]] += Z[p * O + o]
            else:
                first[cam[p, o]] = p * O + o
                scam[p * O + o] = cam[p, o]
    ptr, obs = idx.cam_ptr.numpy(), idx.cam_obs.numpy()
    out = {k: np.zeros((C,) + tuple(v.shape[2:])) for k, v in terms.items()}
    S = np.zeros((C, 6, C, 6))
    for c in range(C):
        if not cam_opt[c]:
            continue
        mine = obs[ptr[c]:ptr[c + 1]]
        for k, v in terms.items():
            out[k][c] = v.double().numpy().reshape((P * O,) + out[k].shape[1:])[mine].sum(0)
        for d in range(c, C):
            if not cam_opt[d]:
                continue
            for n in mine:
                if scam[n] != c:
                    continue
                base = (n // O) * O
                hits = [base + o2 for o2 in range(O) if scam[base + o2] == d]
                assert len(hits) <= 1
                if hits:
                    S[c, :, d, :] += Z[n] @ Z[hits[0]].T
            S[d, :, c, :] = S[c, :, d, :].T
    return Hi.numpy(), g_l.numpy(), Y.numpy(), out["Hcc"], out["g_c"], out["g_red"], S


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_data_flow_through_the_index_matches_plain(seed, stereo):
    args, kw = _problem(seed, stereo=stereo)
    idx = schur.camera_index(args[4], args[6], args[0].shape[0])
    want = schur.schur_reduce_plain(*args, **kw)
    got = _replay_kernel(args, kw, idx)
    assert float(want[6][1, :, 1, :].abs().max()) > 0     # the repeated camera's block is there
    for name, g, w in zip(["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"], got, want):
        w = w.numpy()
        assert g.shape == w.shape, name
        if name == "Hll_inv":
            assert np.all(np.abs(g - w).max((1, 2)) <= 1e-5 * np.abs(w).max((1, 2))), name
        else:
            assert float(np.abs(g - w).max()) <= 1e-5 * float(np.abs(w).max()), name


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_schur_reduce_on_cpu_ignores_the_index(stereo):
    args, kw = _problem(2, stereo=stereo)
    idx = schur.camera_index(args[4], args[6], args[0].shape[0])
    with_idx = schur.schur_reduce(*args, **kw, cam_index=idx)
    without = schur.schur_reduce(*args, **kw)
    plain = schur.schur_reduce_plain(*args, **kw)
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(with_idx, without, plain))


@pytest.mark.parametrize("seed,stereo", [(0, False), (4, True)], ids=["mono", "stereo"])
def test_solve_ba_on_cpu_is_the_plain_path_bit_for_bit(seed, stereo, monkeypatch):
    jcfg = FIXTURE_CFG.replace(bf=FIXTURE_CFG.fx * 0.12) if stereo else FIXTURE_CFG
    tcfg = EngineConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__ if f != "sensor"})
    prob = interop.problem_from_numpy(jax.device_get(make_problem(seed=seed, cfg=jcfg, stereo_frac=0.5 * stereo)[0]),
                                      device="cpu")
    got = tba.solve_ba(prob, tcfg, iters=5)
    seen = []

    def plain_only(*args, cam_index=None, **kw):
        seen.append(cam_index)
        return schur.schur_reduce_plain(*args, **kw)

    monkeypatch.setattr(tba.schur_kernel, "schur_reduce", plain_only)
    want = tba.solve_ba(prob, tcfg, iters=5)
    assert seen == [None] * 5                 # no index is built for CPU tensors
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _scene_and_frame():
    scene = synth.make_scene(seed=1, n_points=80, n_frames=4, cfg=CFG)
    return scene, synth.observe(scene, 0, device="cpu")[0]


ENTRY_POINTS = {
    "Engine": lambda **kw: Engine(CFG, **kw).m.kfs.R,
    "empty_map": lambda **kw: containers.empty_map(CFG, **kw).kfs.R,
    "load_map": None,   # needs a file: see the test
    "numpy_to_tensor": lambda **kw: interop.numpy_to_tensor(np.zeros(3, np.float32), **kw),
    "frame_from_numpy": lambda **kw: interop.frame_from_numpy(
        {f: v.numpy() for f, v in _scene_and_frame()[1]._asdict().items()}, **kw).uv,
    "map_from_numpy": lambda **kw: interop.map_from_numpy(
        interop.map_to_numpy(containers.empty_map(CFG, device="cpu")), **kw).kfs.R,
    "problem_from_numpy": lambda **kw: interop.problem_from_numpy(
        dict(dict.fromkeys(tba.BAProblem._fields), xyz=np.zeros((4, 3), np.float32)), **kw).xyz,
    "synth.observe": lambda **kw: synth.observe(_scene_and_frame()[0], 1, **kw)[0].uv,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, tmp_path):
    make = ENTRY_POINTS[name]
    if name == "load_map":
        path = str(tmp_path / "map.npz")
        containers.save_map(containers.empty_map(CFG, device="cpu"), path)
        make = lambda **kw: containers.load_map(CFG, path, **kw).kfs.R  # noqa: E731
    assert make(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):   # PyTorch's own allocation refuses
            make()
