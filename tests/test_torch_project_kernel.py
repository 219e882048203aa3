"""The projection search's glue kernels (``kernels/project.py``,
``csrc/project.cu``): ``project_gate`` before kernel B, ``invert_matches``
after it.

On the CPU (every test not marked ``cuda``): the wrappers take their plain
versions for CPU tensors and count no launch; the plain versions against a
loop written out row by row (``invert_matches``: the last row wins, drops,
the merge); the plain gates and octave against the problem judged in
float64 (``projection_gates``), where each gate alone rejects some rows;
the local-map form's masks against the separate steps the search took
before; the argument checks the card path runs before it
builds anything (``_gate_checks``, ``_invert_checks``).

On the card (marked ``cuda``, skipped without a GPU; no JAX, so they run with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_project_kernel.py``): ``project_gate`` against
``project_gate_plain`` at TUM1 shapes (N = 1,024 and max_local_lms 8,192,
L = 32,768, F = 1,024) and KITTI00 shapes (N = 2,048 and 8,192, L =
262,144, F = 2,048), frustum on and off, with ids at the sentinel L,
negative ids, invalid landmarks, points behind the camera and on the image
border: the descriptors and free equal; uv within 1e-4 px on the points 1 m
or more in front of the camera, or where wider within the float32
resolution of f (R X + t) / z (8 steps of |X| + |t| through f / z and 2 of
the coordinate: the kernel rounds each product and sum of R X + t once,
PyTorch's product may fuse them, and f / z scales the difference; 1.2e-4 px
read at KITTI00's f = 718.9); radius2 within 1e-6 relative; vis,
seen differ only on rows within 1e-4 of a gate (relative to the boundary,
u and v to the image's size), the octave only where its unrounded value lies
within 1e-5 of an integer, so they agree on at least 99.9% of the other rows
(the problem plants 0.4% of its rows on a gate, where either answer is
rounding's), and each gate alone rejects some rows of the problem
(``projection_gates``), so a kernel that drops one fails.
``invert_matches`` against its plain version bit for bit, with duplicate
matches, out-of-range rows and ids, and the merge. One batched tracked frame
launches exactly 3 ``project_gate`` and 3 ``invert_matches``, a fuse exactly
1 ``project_gate``, and every kernel-B argument taken from a search is
unchanged after the next batch.
"""

import math

import numpy as np
import pytest
import torch

from dialog_tpu_torch.config import KITTI00, TUM1, EngineConfig
from dialog_tpu_torch.kernels import common
from dialog_tpu_torch.kernels import project as pk
from dialog_tpu_torch.optim.synth_problem import camera, make_match_problem, make_projection_problem, projection_gates

torch.set_num_threads(2)

SF, LEVELS = 1.2, 8
# a row may differ from the plain version only this close to a boundary: a gate's (relative to its size), and
# the octave's unrounded value to an integer (logf is within an ulp, ~1e-6 here; the problem puts most rows'
# unrounded octave 1e-4 below an integer, as dmax = dist * sf ** k does, where the answer is sure)
GATE_NEAR, OCTAVE_NEAR = 1e-4, 1e-5
# (camera, L, the motion search's N, max_local_lms, F)
CASES = {"tum1": (camera(TUM1), 32768, 1024, 8192, 1024), "kitti00": (camera(KITTI00), 262144, 2048, 8192, 2048)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _split(p):
    """(ids, the other arguments) of a ``make_projection_problem``."""
    p = dict(p)
    return p.pop("ids"), p


# ---------------------------------------------------------------------------------------------------------------
# on the CPU


def test_module_imports_without_cuda_and_cpu_takes_the_plain_versions():
    common.reset_launch_counts()
    for frustum in (False, True):
        for F in (0, 64):
            ids, kw = _split(make_projection_problem(seed=0, L=512, N=200, F=F, frustum=frustum, device="cpu"))
            got, want = pk.project_gate(ids, **kw), pk.project_gate_plain(ids, **kw)
            for a, b in zip(got, want):
                assert (a is None and b is None) or (a.device.type == "cpu" and torch.equal(a, b))
            assert (got.seen is None) == (F == 0) and (got.free is None) == (F == 0)
    for prior in (False, True):
        q = make_match_problem(seed=3, N=200, F=64, L=512, prior=prior, device="cpu")
        got, want = pk.invert_matches(**q), pk.invert_matches_plain(**q)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sum(common.launches.values()) == 0


@pytest.mark.parametrize("prior", [False, True], ids=["alone", "merged"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_invert_matches_plain_against_rows(prior, seed):
    q = make_match_problem(seed=seed, N=300, F=40, L=100, prior=prior, device="cpu")
    match, ids, F, L = q["match_ft"].numpy(), q["ids"].numpy(), q["F"], q["L"]
    want = np.full(F, -1, np.int32)
    for n in range(match.shape[0]):                               # the last row wins
        if 0 <= match[n] < F:
            want[match[n]] = ids[n] if 0 <= ids[n] < L else -1
    if prior:
        want = np.where(q["prior"].numpy() >= 0, q["prior"].numpy(), want)
    got, cnt = pk.invert_matches_plain(**q)
    np.testing.assert_array_equal(got.numpy(), want)
    assert cnt.dtype == torch.int64 and int(cnt) == int((want >= 0).sum())
    assert len(set(match[(match >= 0) & (match < F)])) < int(((match >= 0) & (match < F)).sum())   # duplicates


def test_local_map_form_matches_the_separate_masks():
    """With lm_of_feat, the plain form's vis, seen and free are the masks the
    local-map search built around the frustum gate before."""
    ids, kw = _split(make_projection_problem(seed=4, L=512, N=300, F=80, frustum=True, device="cpu"))
    lm, fv = kw.pop("lm_of_feat"), kw.pop("feat_valid")
    base = pk.project_gate_plain(ids, **kw)
    got = pk.project_gate_plain(ids, **kw, lm_of_feat=lm, feat_valid=fv)
    held = set(int(x) for x in lm if 0 <= x < 512)
    already = torch.tensor([int(i) in held for i in np.clip(ids.numpy(), 0, 511)])
    assert torch.equal(got.vis, base.vis & ~already) and torch.equal(got.seen, base.vis | already)
    assert torch.equal(got.free, fv & (lm < 0))
    for a, b in [(got.desc, base.desc), (got.uv, base.uv), (got.octave, base.octave), (got.radius2, base.radius2)]:
        assert torch.equal(a, b)
    assert 0 < int(got.vis.sum()) < int(base.vis.sum())


def test_radius2_is_the_octave_scaled_radius():
    ids, kw = _split(make_projection_problem(seed=7, L=256, N=256, radius=15.0, device="cpu"))
    got = pk.project_gate_plain(ids, **kw)
    r = 15.0 * torch.pow(torch.tensor(SF, dtype=torch.float32), got.octave.to(torch.float32))
    assert torch.equal(got.radius2, r * r)
    assert int(got.octave.min()) == 0 and int(got.octave.max()) == LEVELS - 1


@pytest.mark.parametrize("frustum", [False, True], ids=["plain-gate", "frustum"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_gates_match_float64(case, frustum):
    """The plain version's vis and octave against the problem judged in
    float64, on every row not near a boundary (GATE_NEAR, OCTAVE_NEAR); and each gate
    alone rejects some rows, so a version that drops one differs."""
    cam, L, N, _, _ = CASES[case]
    p = make_projection_problem(seed=11, L=L, N=N, cam=cam, frustum=frustum, device="cpu")
    g = projection_gates(p)
    ids, kw = _split(p)
    got = pk.project_gate_plain(ids, **kw)
    want = g["ok"] & np.all(list(g["gates"].values()), 0)
    clear = g["margin"] > GATE_NEAR
    np.testing.assert_array_equal(got.vis.numpy()[clear], want[clear])
    s = np.clip(ids.numpy(), 0, L - 1)
    X, R, t = (kw[k].numpy().astype(np.float64) for k in ("xyz", "R", "t"))
    dist = np.linalg.norm(X[s] + R.T @ t, axis=-1)
    ratio = np.maximum(kw["dmax"].numpy().astype(np.float64)[s] / np.maximum(dist, 1e-6), 1e-6)
    octave = np.clip(np.ceil(np.log(ratio) / math.log(SF) - 1e-4), 0, LEVELS - 1)
    sure = g["octave"] > OCTAVE_NEAR
    np.testing.assert_array_equal(got.octave.numpy()[sure], octave[sure])
    assert set(g["alone"]) == ({"z", "u0", "u1", "v0", "v1"} | ({"view", "dmin", "dmax"} if frustum else set()))
    assert all(n > 0 for n in g["alone"].values()), g["alone"]
    assert clear.mean() > 0.99 and sure.mean() > 0.99


def _full_args(frustum=True, F=8):
    return _split(make_projection_problem(seed=9, L=64, N=16, F=F, frustum=frustum, device="cpu"))


@pytest.mark.parametrize("bad", ["ids-dtype", "xyz-shape", "desc-dtype", "valid-dtype", "R-shape", "t-dtype",
                                 "normal-missing", "dmin-shape", "lm-without-valid", "feat_valid-shape",
                                 "non-contiguous", "misaligned-desc", "no-slot", "no-level", "too-many-features"])
def test_gate_checks_raise_before_any_build(bad):
    ids, kw = _full_args()
    L = kw["xyz"].shape[0]
    if bad == "ids-dtype":
        ids = ids.long()
    elif bad == "xyz-shape":
        kw["xyz"] = kw["xyz"][:, :2].contiguous()
    elif bad == "desc-dtype":
        kw["desc"] = kw["desc"].to(torch.int64)
    elif bad == "valid-dtype":
        kw["valid"] = kw["valid"].to(torch.uint8)
    elif bad == "R-shape":
        kw["R"] = kw["R"].reshape(9)
    elif bad == "t-dtype":
        kw["t"] = kw["t"].double()
    elif bad == "normal-missing":
        kw["normal"] = None
    elif bad == "dmin-shape":
        kw["dmin"] = kw["dmin"][: L - 1]
    elif bad == "lm-without-valid":
        kw["feat_valid"] = None
    elif bad == "feat_valid-shape":
        kw["feat_valid"] = kw["feat_valid"][:-1]
    elif bad == "non-contiguous":
        kw["R"] = kw["R"].t()
    elif bad == "misaligned-desc":
        kw["desc"] = torch.zeros((L * 8 + 1,), dtype=torch.int32)[1:].view(L, 8)
    elif bad == "no-slot":
        kw.update(xyz=kw["xyz"][:0], desc=kw["desc"][:0], dmax=kw["dmax"][:0], valid=kw["valid"][:0],
                  normal=kw["normal"][:0], dmin=kw["dmin"][:0])
    elif bad == "no-level":
        kw["n_levels"] = 0
    elif bad == "too-many-features":
        kw["lm_of_feat"] = torch.full((pk.MAX_SET_FEATURES + 1,), -1, dtype=torch.int32)
        kw["feat_valid"] = torch.ones((pk.MAX_SET_FEATURES + 1,), dtype=torch.bool)
    with pytest.raises(ValueError):
        pk._gate_checks(ids, **kw)


def test_gate_checks_pass_every_form():
    for frustum in (False, True):
        for F, slots in ((0, 0), (8, 64), (100, 256), (1024, 2048)):   # the hash set: 2 F slots or more, at least 64
            ids, kw = _full_args(frustum=frustum, F=F)
            if not frustum:
                kw.update(normal=None, dmin=None)
            assert pk._gate_checks(ids, **kw) == slots


@pytest.mark.parametrize("bad", ["match-dtype", "ids-shape", "prior-shape", "no-slot", "negative-F"])
def test_invert_checks_raise_before_any_build(bad):
    match, ids = torch.zeros(10, dtype=torch.int32), torch.zeros(10, dtype=torch.int32)
    prior, F, L = torch.full((6,), -1, dtype=torch.int32), 6, 20
    if bad == "match-dtype":
        match = match.long()
    elif bad == "ids-shape":
        ids = ids[:9]
    elif bad == "prior-shape":
        prior = prior[:5]
    elif bad == "no-slot":
        L = 0
    elif bad == "negative-F":
        F = -1
    with pytest.raises(ValueError):
        pk._invert_checks(match, ids, F, L, prior)
    pk._invert_checks(torch.zeros(10, dtype=torch.int32), torch.zeros(10, dtype=torch.int32), 6, 20,
                      torch.full((6,), -1, dtype=torch.int32))


def test_another_device_raises():
    x = torch.empty(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pk.invert_matches(x, x, 4, 8)
    with pytest.raises(ValueError):
        pk.project_gate(x, *[None] * 6, **camera(TUM1), scale_factor=SF, n_levels=LEVELS, radius=1.0)
    assert sum(common.launches.values()) == 0


# ---------------------------------------------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
@pytest.mark.parametrize("merge", [False, True], ids=["motion", "local-map"])
@pytest.mark.parametrize("frustum", [False, True], ids=["plain-gate", "frustum"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_project_gate_against_plain(cuda, case, frustum, merge):
    cam, L, N_motion, N_local, F = CASES[case]
    N = N_local if merge else N_motion
    p = make_projection_problem(seed=11, L=L, N=N, F=F if merge else 0, cam=cam, frustum=frustum, device=cuda)
    ids, kw = _split(p)
    n0 = common.launches["project_gate"]
    got, again = pk.project_gate(ids, **kw), pk.project_gate(ids, **kw)
    want = pk.project_gate_plain(ids, **kw)
    torch.cuda.synchronize()
    assert common.launches["project_gate"] == n0 + 2
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(got.desc, want.desc)
    g = projection_gates(p)
    gate, octave, z, scale = g["margin"], g["octave"], g["z"], g["scale"]
    assert all(n > 0 for n in g["alone"].values()), f"a gate rejects no row alone: {g['alone']}"
    # uv on the points 1 m or more in front of the camera: 1e-4 px, or where wider the float32 resolution of
    # f (R X + t) / z (PyTorch's product may fuse the multiply-adds of R X + t, the kernel rounds each once):
    # 8 steps of |X| + |t| through f / z, and 2 of the pixel coordinate itself
    front = torch.from_numpy(z >= 1.0).to(cuda)
    f = torch.tensor([p["fx"], p["fy"]], dtype=torch.float64, device=cuda)
    res = torch.from_numpy(8 * 2.0**-23 * scale / np.maximum(np.abs(z), 1.0)).to(cuda)
    tol = torch.clamp(res[:, None] * f + 2 * 2.0**-23 * torch.abs(want.uv.double()), min=1e-4)
    err = (got.uv - want.uv).abs()
    over = (err > tol) & front[:, None]
    assert not bool(over.any()), f"uv: {int(over.sum())} coordinates off, largest {float(err[over].max())}"
    assert torch.allclose(got.radius2, want.radius2, rtol=1e-6, atol=0)
    masks = [("vis", got.vis, want.vis, gate), ("octave", got.octave, want.octave, octave)]
    if merge:
        masks.append(("seen", got.seen, want.seen, gate))
        assert torch.equal(got.free, want.free)
    for name, a, b, margin in masks:
        diff, near = (a != b).cpu().numpy(), margin <= (OCTAVE_NEAR if name == "octave" else GATE_NEAR)
        assert (diff & ~near).sum() <= 1e-3 * (~near).sum(), f"{name}: {diff.sum()} of {N} rows differ"
        assert near[diff].all(), f"{name}: rows differ away from any boundary, margins {margin[diff]}"
    assert 0.2 * N < int(want.vis.sum()) < N


@pytest.mark.cuda
@pytest.mark.parametrize("prior", [False, True], ids=["alone", "merged"])
@pytest.mark.parametrize("N,F,L", [(1024, 1024, 32768), (8192, 2048, 262144), (0, 1024, 32768), (64, 8, 16)])
def test_invert_matches_against_plain(cuda, N, F, L, prior):
    q = make_match_problem(seed=N + F, N=N, F=F, L=L, prior=prior, device=cuda)
    n0 = common.launches["invert_matches"]
    got = pk.invert_matches(**q)
    want = pk.invert_matches_plain(**q)
    torch.cuda.synchronize()
    assert common.launches["invert_matches"] == n0 + 1
    assert torch.equal(got[0], want[0]) and got[1].dtype == want[1].dtype and int(got[1]) == int(want[1])


def _tracked_engine(dev):
    """An engine on ``dev`` through 24 synthetic frames per frame and in
    batches of 4, then: for each later batch, the launches of each
    ``fused_track_multi`` call and of each fuse, and every kernel-B call's
    tensors with a copy taken when the call returned."""
    from dialog_tpu_torch import mapping, matching, tracking
    from dialog_tpu_torch.containers import FrameArrays
    from dialog_tpu_torch.datasets import synth
    from dialog_tpu_torch.system import OK, Engine

    cfg = EngineConfig(max_features=512, max_keyframes=64, max_landmarks=8192, max_local_lms=1024,
                       max_frames_between_kf=8, vocab_words=256)
    N, B = 40, 4
    scene = synth.make_scene(seed=51, n_points=700, n_frames=N, cfg=cfg)
    frames = [synth.observe(scene, i, noise_px=0.4, device="cpu")[0] for i in range(N)]
    eng = Engine(cfg, device=dev)
    rec = {"multi": [], "fuse": [], "match": []}
    saved = (tracking.fused_track_multi, mapping.fuse_landmarks_into_kf, matching.mutual_match_fused)

    def counted(key, fn, size=lambda a: 1):
        def wrapper(*a, **k):
            n0 = dict(common.launches)
            out = fn(*a, **k)
            rec[key].append((size(a), {n: common.launches[n] - n0[n] for n in ("project_gate", "invert_matches")}))
            return out
        return wrapper

    def kept(*a, **k):
        out = saved[2](*a, **k)
        ts = [x for x in (*a, *k.values()) if isinstance(x, torch.Tensor)]
        rec["match"].append((ts, [x.clone() for x in ts]))
        return out

    tracking.fused_track_multi = counted("multi", saved[0], lambda a: a[2].uv.shape[0])
    mapping.fuse_landmarks_into_kf = counted("fuse", saved[1])
    matching.mutual_match_fused = kept
    try:
        for i in range(0, N, B):
            batch = FrameArrays(*[torch.stack(x).to(dev) for x in zip(*frames[i : i + B])])
            eng.track_batch(batch, [j / 30.0 for j in range(i, i + B)])
        eng.flush()
    finally:
        tracking.fused_track_multi, mapping.fuse_landmarks_into_kf, matching.mutual_match_fused = saved
    assert eng.state == OK
    return rec


@pytest.mark.cuda
def test_batched_frames_launch_three_of_each_and_keep_kernel_b_inputs(cuda):
    rec = _tracked_engine(cuda)
    assert rec["multi"] and rec["fuse"] and rec["match"]
    for B, n in rec["multi"]:
        assert n == {"project_gate": 3 * B, "invert_matches": 3 * B}
    for _, n in rec["fuse"]:
        assert n == {"project_gate": 1, "invert_matches": 0}
    torch.cuda.synchronize()
    for ts, copies in rec["match"]:
        assert all(torch.equal(x, c) for x, c in zip(ts, copies))
