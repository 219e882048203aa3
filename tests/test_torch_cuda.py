"""Kernels A, B and C on the card against their plain PyTorch versions.

These tests need an NVIDIA GPU and skip without one. They import no JAX, so
they also run where only PyTorch is installed; the repository's conftest
imports JAX, so on such a machine skip it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: A and B are integer and min/max computations, bit-exact: kernel
A level by level and all levels of a pyramid in one launch (plain and
cell-padded outputs, odd sizes, a full 32-level table), kernel B as
``hamming_best2`` and in its mutual mode (one pass, packed column keys)
against the two-call plain form, with B whole in shared memory and in chunks.
C sums
in another order than the plain version: its direct outputs within 1e-4 of
each output's largest magnitude on a well-conditioned problem, bitwise equal
from run to run, and a 5-iteration ``solve_ba`` within the reference's
``kernels/selfcheck`` bounds (R and t 2e-3, xyz 5e-3); the same for its
stereo variant, with a right-x on half the observations. Both variants also
run over P, O and C off the block sizes, with frozen cameras, dead
landmarks and repeated cameras, and with the camera index given or built.

The batched paths: kernel A over a batch of images in one launch, bit for
bit against its plain version and against the one-image launch; the batched
frontends (``extract_features_batch``, ``extract_and_match_stereo_batch``)
bit for bit against the per-image entries on the card; the pinned,
event-guarded pull of the pipelined engine against a blocking copy; and
``Engine.track_batch`` on the card against the same engine on the CPU
(synthetic observations: the same states frame by frame and positions within
5e-3 of the sweep's ~2 m, which is what f32 sums taken in another order
leave after 48 frames of pose optimization and five local BAs).

Loop closing: ``solve_pose_graph`` on the card against the CPU on a seeded
Sim3 graph of the mono capacities (K = 256, a 1,792 x 1,792 system, 25
iterations: s, R and t within 1e-4, where an f32 solve on the CPU sits
within 5e-6 of a float64 one), and on a map the engine built on the card,
the guided Sim3 match count (kernel B's mutual mode against the plain form)
equal on the card and on the CPU, with ``compute_sim3`` from the same
minimal sets giving the same outcome and a similarity within 1e-3.

Global BA: kernel C at global BA's camera counts (C = 128 and 192, P =
4,096 slots, O = 12) against its plain version as above; the Schur PCG on
the card against the CPU on a seeded problem (three LM iterations: R, t and
landmarks within 1e-4, the CG iterations within two); ``build_global_problem``
on the card against the CPU, its integer fields and gathered floats bit for
bit; two gloo ranks on CUDA tensors (``python -m dialog_tpu_torch.gba_rank``)
against one rank on the card, for the dense branch and the PCG, within the
CPU test's bounds (``tests/test_torch_distributed.py``: poses 1e-4,
landmarks 1e-3).

Block BA: kernel C's frozen-landmark mode (``lm_opt``, both variants)
against its plain version as above, with the frozen rows' g_l and Y exactly
zero; ``block_bundle_adjustment`` on the card against the CPU and a float64
solve on a small stereo corridor (t within 2e-3, R within 5e-4), its
launches, and a repeat bit for bit. The
fixed-order segment sum and the global BA and pose graph built on it repeat
bit for bit (ROADMAP D15).

The pose LM kernel (``kernels/pose.py``, one launch a ``pose_optimization``
call): against the plain loop on the card and against the float64
reference (``bench_port/reference/pose.py``), mono and stereo (a right-x on
half the observations), (rounds, iters) = (2, 6) and (4, 10), N = 2,048,
1,024, 1,000 and 37, and on hard problems (30% outliers past the Huber
knee, 300 points behind the camera, no valid observation, none at all, a
start whose LM rejects steps): the same inlier set, R and t within 1e-4 (the CPU pose
tests' tolerance against JAX), the cost within float32 rounding of a sum
(relative 1e-5), two calls bit for bit in fresh tensors, one launch a
call; the wrapper raises on a wrong type, shape or device, a
non-contiguous tensor and the stereo form without u_right. N has no limit
of the kernel's own.

The port's periphery on the card machine (which has no cv2): the kernels'
self-check (``kernels.selfcheck``, every case), and PNG files written by
``datasets.png.write_png`` decoding back to their arrays bit for bit and
feeding the frontend on the card as the same array would.
"""

import numpy as np
import pytest
import torch

from dialog_tpu_torch import frontend as fe
from dialog_tpu_torch import geometry as geo
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.datasets import synth
from dialog_tpu_torch.kernels import common
from dialog_tpu_torch.kernels import fast, hamming, schur
from dialog_tpu_torch.kernels import pose as pose_kernel
from dialog_tpu_torch.optim import pose_only
from dialog_tpu_torch.optim.local_ba import BAProblem, solve_ba
from dialog_tpu_torch.optim.synth_problem import make_pose_problem

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)

CFG = EngineConfig(width=640, height=480, n_features=1000, max_features=1024, max_local_kfs=16,
                   max_fixed_kfs=16, max_local_lms=2048, max_obs_per_lm=8)
STEREO_CFG = CFG.replace(bf=CFG.fx * 0.12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ba_problem(dev, seed=0, n_cams=12, n_pts=1500, stereo_frac=0.0):
    """Cameras on an arc observing a box of points, poses and points perturbed;
    with ``stereo_frac`` that share of the observations carries a right-x."""
    rng = np.random.default_rng(seed)
    C, P, O = CFG.max_local_kfs + CFG.max_fixed_kfs, CFG.max_local_lms, CFG.max_obs_per_lm
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(6, 10, n_pts)], -1)
    R = np.tile(np.eye(3), (C, 1, 1))
    t = np.zeros((C, 3))
    for c in range(n_cams):
        eye = np.array([(c / (n_cams - 1) - 0.5) * 4.0, 0.1, 0.0])
        fwd = np.array([0.0, 0.0, 8.0]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0, -1, 0])
        right /= np.linalg.norm(right)
        R[c] = np.stack([right, np.cross(fwd, right), fwd])
        t[c] = -R[c] @ eye
    obs_cam = np.full((P, O), C, np.int32)
    obs_uv = np.zeros((P, O, 2))
    obs_z = np.ones((P, O))
    for p in range(n_pts):
        for o, c in enumerate(rng.choice(n_cams, O, replace=False)):
            Xc = R[c] @ pts[p] + t[c]
            obs_cam[p, o] = c
            obs_z[p, o] = Xc[2]
            obs_uv[p, o] = [CFG.fx * Xc[0] / Xc[2] + CFG.cx, CFG.fy * Xc[1] / Xc[2] + CFG.cy]
    obs_uv += rng.normal(0, 0.5, obs_uv.shape)
    obs_ur = obs_uv[..., 0] - STEREO_CFG.bf / obs_z + rng.normal(0, 0.5, obs_z.shape)
    obs_ur = np.where(rng.random(obs_z.shape) < stereo_frac, obs_ur, -1.0)
    ok = obs_cam < C
    cam_opt = np.zeros(C, bool)
    cam_opt[2:n_cams] = True
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    Rt, tt = geo.se3_retract(f32(R), f32(t), f32(rng.normal(0, 0.02, (C, 6)) * cam_opt[:, None]))
    xyz = np.zeros((P, 3))
    xyz[:n_pts] = pts + rng.normal(0, 0.05, pts.shape)
    return BAProblem(
        cam_slots=torch.arange(C, dtype=torch.int32, device=dev), cam_opt=torch.tensor(cam_opt, device=dev),
        R=Rt.contiguous(), t=tt.contiguous(), lm_ids=torch.arange(P, dtype=torch.int32, device=dev),
        xyz=f32(xyz), obs_cam=torch.tensor(obs_cam, device=dev), obs_uv=f32(obs_uv), obs_w=f32(ok * 1.0),
        obs_ok=torch.tensor(ok, device=dev), obs_feat=torch.zeros((P, O), dtype=torch.int32, device=dev),
        obs_ur=f32(np.where(ok, obs_ur, -1.0)) if stereo_frac > 0 else None,
    )


def _reduce_args(prob, lam):
    return (prob.R, prob.t, prob.cam_opt, prob.xyz, prob.obs_cam, prob.obs_uv, prob.obs_w, lam,
            CFG.fx, CFG.fy, CFG.cx, CFG.cy, CFG.chi2_mono)


def test_fast_kernel_bit_exact_on_pyramid(cuda):
    scene = synth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=CFG)
    img = torch.from_numpy(synth.render_image(scene, 5)).to(cuda)
    rnd = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (123, 210)).astype(np.float32)).to(cuda)
    cases = [(lvl, 7.0, 20.0, fe.BORDER) for lvl in fe.build_pyramid(img, CFG)]
    cases += [(rnd, 7.0, 20.0, 19), (rnd, 3.0, 10.0, 8)]
    before = common.launches["fast_nms_rank"]
    for im, min_th, th_fast, border in cases:
        got = fast.fast_nms_rank(im, min_th, th_fast, border)
        want = fast.fast_nms_rank_plain(im, min_th, th_fast, border)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tuple(im.shape)
    assert common.launches["fast_nms_rank"] == before + len(cases)


@pytest.mark.parametrize("case", ["plain", "spatial", "spatial+oct", "col-radius"])
def test_hamming_kernel_bit_exact(cuda, case):
    rng = np.random.default_rng(11)
    n, m = 2048, 1024
    to = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    a = to(rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32))
    b = to(rng.integers(0, 2**32, (m, 8), dtype=np.uint32).view(np.int32))
    va, vb = to(rng.random(n) > 0.1), to(rng.random(m) > 0.1)
    uva, uvb = to(rng.uniform(0, 640, (n, 2)).astype(np.float32)), to(rng.uniform(0, 640, (m, 2)).astype(np.float32))
    r2, r2c = to((rng.uniform(20, 200, n) ** 2).astype(np.float32)), to((rng.uniform(20, 200, m) ** 2).astype(np.float32))
    oa, ob = to(rng.integers(0, 8, n).astype(np.int32)), to(rng.integers(0, 8, m).astype(np.int32))
    kw = {"plain": {}, "spatial": dict(uv_a=uva, uv_b=uvb, radius2=r2),
          "spatial+oct": dict(uv_a=uva, uv_b=uvb, radius2=r2, oct_a=oa, oct_b=ob, octave_band=1),
          "col-radius": dict(uv_a=uva, uv_b=uvb, radius2_cols=r2c)}[case]
    before = dict(common.launches)
    got = hamming.hamming_best2(a, b, va, vb, **kw)
    want = hamming.hamming_best2_filled(a, b, va, vb, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert common.launches["hamming_best2"] == before["hamming_best2"] + 1
    assert common.launches["hamming_mutual"] == before["hamming_mutual"]


def test_hamming_kernel_ties_go_to_lowest_column(cuda):
    a = torch.from_numpy(np.random.default_rng(7).integers(0, 2**32, (8, 8), dtype=np.uint32).view(np.int32)).to(cuda)
    idx, best, second = hamming.hamming_best2(a, torch.cat([a, a]), torch.ones(8, dtype=torch.bool, device=cuda),
                                              torch.ones(16, dtype=torch.bool, device=cuda))
    assert idx.cpu().tolist() == list(range(8))
    assert int(best.abs().sum()) == 0 and int(second.abs().sum()) == 0


def _rand_img(rng, h, w, dev):
    return torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)


@pytest.mark.parametrize("case", ["mono-pyramid", "mono-pyramid-cells", "kitti-pyramid-cells", "odd-sizes",
                                  "odd-sizes-pad5", "32-levels", "no-border", "negative-min-th"])
def test_fast_levels_bit_exact_in_one_launch(cuda, case):
    rng = np.random.default_rng(3)
    th, pad = (7.0, 20.0, fe.BORDER), 1
    if case.startswith("mono"):
        scene = synth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=CFG)
        levels = fe.build_pyramid(torch.from_numpy(synth.render_image(scene, 5)).to(cuda), CFG)
        pad = fe.CELL if case.endswith("cells") else 1
    elif case.startswith("kitti"):
        kcfg = CFG.replace(width=1241, height=376)
        levels, pad = fe.build_pyramid(_rand_img(rng, 376, 1241, cuda), kcfg), fe.CELL
    elif case.startswith("odd"):
        levels = [_rand_img(rng, h, w, cuda) for h, w in [(61, 63), (62, 14), (15, 125), (1, 1), (7, 300),
                                                          (129, 65), (40, 39), (14, 62), (28, 124)]]
        th, pad = ((2.0, 9.0, 4), 5) if case.endswith("pad5") else ((7.0, 20.0, 19), 1)
    elif case == "32-levels":
        levels, th, pad = [_rand_img(rng, 30 + 3 * i, 97 - 2 * i, cuda) for i in range(fast.MAX_LEVELS)], (4.0, 15.0, 6), 8
    elif case == "no-border":
        levels, th = [_rand_img(rng, 90, 131, cuda), _rand_img(rng, 33, 70, cuda)], (0.0, 5.0, 0)
    else:
        levels, th = [_rand_img(rng, 90, 131, cuda), _rand_img(rng, 33, 70, cuda)], (-1.0, 4.0, 3)
    before = common.launches["fast_nms_rank"]
    got = fast.fast_nms_rank_levels(levels, *th, pad_to=pad)
    assert common.launches["fast_nms_rank"] == before + 1
    want = fast.fast_nms_rank_levels_plain(levels, *th, pad_to=pad)
    torch.cuda.synchronize()
    assert len(got) == len(want) == len(levels)
    for l, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.equal(g, w), (l, tuple(levels[l].shape))
    if case == "mono-pyramid":
        assert sum(int((g > 0).sum()) for g in got) > 500   # the image has corners to find


def test_fast_levels_table_is_reused_across_calls(cuda):
    """One cached table template serves every call with the same level
    shapes: each call fills its own copy's pointers, and an earlier call's
    outputs stay as they were."""
    rng = np.random.default_rng(5)
    first = [_rand_img(rng, 200, 260, cuda), _rand_img(rng, 77, 91, cuda)]
    second = [_rand_img(rng, 200, 260, cuda), _rand_img(rng, 77, 91, cuda)]
    got1 = fast.fast_nms_rank_levels(first, 7.0, 20.0, 19, pad_to=16)
    got2 = fast.fast_nms_rank_levels(second, 7.0, 20.0, 19, pad_to=16)
    torch.cuda.synchronize()
    for got, levels in ((got1, first), (got2, second)):
        want = fast.fast_nms_rank_levels_plain(levels, 7.0, 20.0, 19, pad_to=16)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got1[0], got2[0])


def test_fast_levels_raises_on_what_the_kernel_does_not_take(cuda):
    img = torch.zeros((40, 50), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="levels"):
        fast.fast_nms_rank_levels([img] * (fast.MAX_LEVELS + 1), 7.0, 20.0, 19)
    with pytest.raises(ValueError, match="contiguous"):
        fast.fast_nms_rank_levels([img, img.T], 7.0, 20.0, 19)
    with pytest.raises(ValueError):
        fast.fast_nms_rank_levels([img, img.double()], 7.0, 20.0, 19)
    with pytest.raises(ValueError):
        fast.fast_nms_rank_levels([img, img.cpu()], 7.0, 20.0, 19)
    with pytest.raises(ValueError, match="pad_to"):
        fast.fast_nms_rank_levels([img], 7.0, 20.0, 19, pad_to=0)
    assert fast.fast_nms_rank_levels([], 7.0, 20.0, 19) == []


def _match_inputs(n, m, seed, dev):
    """Random descriptors, positions, radii and octaves; the first half of the
    shorter side has a partner on the other: its descriptor with a few bits
    flipped, a few pixels away, in the same octave."""
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    uva = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    uvb = rng.uniform(0, 640, (m, 2)).astype(np.float32)
    oa, ob = rng.integers(0, 8, n).astype(np.int32), rng.integers(0, 8, m).astype(np.int32)
    k = min(n, m) // 2
    b[:k] = a[:k] ^ (rng.integers(0, 2, (k, 8), dtype=np.uint32) << rng.integers(0, 32, (k, 8), dtype=np.uint32))
    uvb[:k] = uva[:k] + rng.normal(0, 3, (k, 2)).astype(np.float32)
    ob[:k] = oa[:k]
    return dict(a=to(a.view(np.int32)), b=to(b.view(np.int32)),
                va=to(rng.random(n) > 0.1), vb=to(rng.random(m) > 0.1), uva=to(uva), uvb=to(uvb),
                r2=to((rng.uniform(20, 200, n) ** 2).astype(np.float32)),
                r2c=to((rng.uniform(20, 200, m) ** 2).astype(np.float32)), oa=to(oa), ob=to(ob))


def _gates(x, case):
    return {"plain": {}, "spatial": dict(uv_a=x["uva"], uv_b=x["uvb"], radius2=x["r2"]),
            "oct": dict(oct_a=x["oa"], oct_b=x["ob"], octave_band=1),
            "spatial+oct": dict(uv_a=x["uva"], uv_b=x["uvb"], radius2=x["r2"], oct_a=x["oa"], oct_b=x["ob"],
                                octave_band=1)}[case]


# B whole in shared memory (up to 4,736 columns) and in chunks of 2,368 (two and three chunks)
@pytest.mark.parametrize("shape", [(700, 900), (2048, 1024), (8192, 2048), (37, 4736), (300, 4737), (530, 6000)])
@pytest.mark.parametrize("case", ["plain", "spatial", "oct", "spatial+oct"])
def test_mutual_match_kernel_bit_exact(cuda, shape, case):
    x = _match_inputs(*shape, 21, cuda)
    kw = dict(**_gates(x, case), max_dist=110, ratio=0.9)
    before = dict(common.launches)
    got = hamming.mutual_match_fused(x["a"], x["b"], x["va"], x["vb"], **kw)
    want = hamming.mutual_match_plain(x["a"], x["b"], x["va"], x["vb"], **kw)
    torch.cuda.synchronize()
    assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
    assert common.launches["hamming_mutual"] == before["hamming_mutual"] + 1
    assert common.launches["hamming_best2"] == before["hamming_best2"]
    assert int((got[0] >= 0).sum()) > min(shape) // 8   # most partners are found


@pytest.mark.parametrize("case", ["few-descriptors", "few-descriptors-gated", "one-descriptor", "closed-gates",
                                  "no-valid-row", "no-valid-column", "N=0", "M=0", "N=1", "M=1"])
def test_mutual_match_kernel_ties_and_empty_sides(cuda, case):
    x = _match_inputs(600, 500, 22, cuda)
    rng = np.random.default_rng(23)
    few = x["a"][:5]
    a, b, va, vb = x["a"], x["b"], x["va"], x["vb"]
    kw = dict(max_dist=110, ratio=0.9)
    if case.startswith("few"):
        a = few[torch.from_numpy(rng.integers(0, 5, 600)).to(cuda)]
        b = few[torch.from_numpy(rng.integers(0, 5, 500)).to(cuda)]
        kw = dict(max_dist=256, ratio=2.0, **(_gates(x, "spatial+oct") if case.endswith("gated") else {}))
    elif case == "one-descriptor":
        a, b = few[:1].expand(600, 8).contiguous(), few[:1].expand(500, 8).contiguous()
        kw = dict(max_dist=256, ratio=2.0)
    elif case == "closed-gates":
        kw.update(uv_a=x["uva"], uv_b=x["uvb"] + 5000.0, radius2=x["r2"])
    elif case == "no-valid-row":
        va = torch.zeros_like(va)
    elif case == "no-valid-column":
        vb = torch.zeros_like(vb)
    elif case in ("N=0", "N=1"):
        n = int(case[-1])
        a, va = a[:n], torch.ones_like(va[:n])
    else:
        m = int(case[-1])
        b, vb = b[:m], torch.ones_like(vb[:m])
    got = hamming.mutual_match_fused(a, b, va, vb, **kw)
    want = hamming.mutual_match_plain(a, b, va, vb, **kw)
    torch.cuda.synchronize()
    assert all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", ["plain", "spatial+oct", "col-radius"])
def test_hamming_kernel_bit_exact_in_chunks(cuda, case):
    x = _match_inputs(530, 6000, 24, cuda)
    kw = dict(uv_a=x["uva"], uv_b=x["uvb"], radius2_cols=x["r2c"]) if case == "col-radius" else _gates(x, case)
    got = hamming.hamming_best2(x["a"], x["b"], x["va"], x["vb"], **kw)
    want = hamming.hamming_best2_filled(x["a"], x["b"], x["va"], x["vb"], **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_hamming_kernels_raise_on_what_they_do_not_take(cuda):
    x = _match_inputs(64, 48, 25, cuda)
    with pytest.raises(ValueError, match="together"):
        hamming.mutual_match_fused(x["a"], x["b"], x["va"], x["vb"], uv_a=x["uva"])
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros((64 * 8 + 1,), dtype=torch.int32, device=cuda)
        hamming.mutual_match_fused(flat[1:].view(64, 8), x["b"], x["va"], x["vb"])
    with pytest.raises(ValueError, match="contiguous"):
        hamming.mutual_match_fused(x["a"], x["b"], x["va"], x["vb"], uv_a=x["uva"].T.contiguous().T, uv_b=x["uvb"])
    n = 1 << hamming.ROW_BITS
    big = torch.zeros((n, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="rows"):
        hamming.mutual_match_fused(big, x["b"], torch.ones(n, dtype=torch.bool, device=cuda), x["vb"])


def test_schur_kernel_matches_plain_and_repeats(cuda):
    prob = _ba_problem(cuda)
    lam = torch.tensor(1e-3, device=cuda)
    got = schur.schur_reduce(*_reduce_args(prob, lam))
    again = schur.schur_reduce(*_reduce_args(prob, lam))
    want = schur.schur_reduce_plain(*_reduce_args(prob, lam))
    torch.cuda.synchronize()
    for name, g, w in zip(["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"], got, want):
        assert g.shape == w.shape, name
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name
    assert all(torch.equal(g, h) for g, h in zip(got, again))


def test_schur_kernel_solve_matches_plain_solve(cuda):
    prob = _ba_problem(cuda, seed=1)
    Rk, tk, xk, _ = solve_ba(prob, CFG, iters=5, chi2_th=CFG.chi2_mono)
    prob_cpu = BAProblem(*[x.cpu() if isinstance(x, torch.Tensor) else x for x in prob])
    Rp, tp, xp, _ = solve_ba(prob_cpu, CFG, iters=5, chi2_th=CFG.chi2_mono)
    assert float((Rk.cpu() - Rp).abs().max()) < 2e-3
    assert float((tk.cpu() - tp).abs().max()) < 2e-3
    assert float((xk.cpu() - xp).abs().max()) < 5e-3


def test_schur_kernel_stereo_matches_plain_and_repeats(cuda):
    prob = _ba_problem(cuda, seed=2, stereo_frac=0.5)
    lam = torch.tensor(1e-3, device=cuda)
    st = dict(obs_ur=prob.obs_ur, bf=STEREO_CFG.bf, delta2_stereo=STEREO_CFG.chi2_stereo)
    before = dict(common.launches)
    got = schur.schur_reduce(*_reduce_args(prob, lam), **st)
    again = schur.schur_reduce(*_reduce_args(prob, lam), **st)
    want = schur.schur_reduce_plain(*_reduce_args(prob, lam), **st)
    mono = schur.schur_reduce_plain(*_reduce_args(prob, lam))
    torch.cuda.synchronize()
    assert common.launches["schur_reduce_stereo"] == before["schur_reduce_stereo"] + 2
    assert common.launches["schur_reduce"] == before["schur_reduce"]
    n_pts = 1500
    for k, (name, g, w, m) in enumerate(zip(["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"],
                                            got, want, mono)):
        assert g.shape == w.shape, name
        if k < 3:   # per-landmark outputs: the observed landmarks (padding holds 1/1e-9)
            g, w, m = g[:n_pts], w[:n_pts], m[:n_pts]
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * scale, name
        assert float((m - w).abs().max()) > 1e-2 * scale, name   # the uR rows count
    assert all(torch.equal(g, h) for g, h in zip(got, again))


def test_schur_kernel_stereo_solve_matches_plain_solve(cuda):
    prob = _ba_problem(cuda, seed=3, stereo_frac=0.5)
    Rk, tk, xk, _ = solve_ba(prob, STEREO_CFG, iters=5, chi2_th=CFG.chi2_mono)
    prob_cpu = BAProblem(*[x.cpu() if isinstance(x, torch.Tensor) else x for x in prob])
    Rp, tp, xp, _ = solve_ba(prob_cpu, STEREO_CFG, iters=5, chi2_th=CFG.chi2_mono)
    assert float((Rk.cpu() - Rp).abs().max()) < 2e-3
    assert float((tk.cpu() - tp).abs().max()) < 2e-3
    assert float((xk.cpu() - xp).abs().max()) < 5e-3


def _random_problem(dev, seed, C, P, O, stereo, frozen=False):
    """``schur_reduce`` arguments on random geometry: cameras near the identity
    looking at a box of points, each slot's camera drawn at random (so a
    landmark may see a camera twice), a fifth of the slots pads (camera C),
    some negative cameras and zero weights, landmark 0 without a live slot,
    landmark 1 with two live slots of one camera, camera 0 frozen (all of
    them with ``frozen``); with ``stereo`` half the slots carry a right-x."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    R, t = geo.se3_retract(torch.eye(3).repeat(C, 1, 1), torch.zeros(C, 3),
                           torch.tensor(rng.normal(0, 0.05, (C, 6)), dtype=torch.float32))
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(5, 10, P)], -1)
    obs_cam = rng.integers(0, C, (P, O))
    obs_w = rng.choice([0.0, 1.0, 0.694, 0.482], (P, O), p=[0.1, 0.4, 0.3, 0.2])
    if O >= 2:
        obs_cam[1, :2], obs_w[1, :2] = 1 % C, 1.0
    obs_cam[rng.random((P, O)) < 0.2] = C
    obs_cam[rng.random((P, O)) < 0.05] = -3
    if O >= 2:
        obs_cam[1, :2] = 1 % C
    obs_cam[0] = C
    safe = np.clip(obs_cam, 0, C - 1)
    Xc = np.einsum("poij,pj->poi", R.numpy()[safe], pts) + t.numpy()[safe]
    obs_uv = np.stack([CFG.fx * Xc[..., 0] / Xc[..., 2] + CFG.cx, CFG.fy * Xc[..., 1] / Xc[..., 2] + CFG.cy], -1)
    obs_uv += rng.normal(0, 1.5, obs_uv.shape)
    obs_ur = obs_uv[..., 0] - STEREO_CFG.bf / Xc[..., 2] + rng.normal(0, 1.0, (P, O))
    obs_ur = np.where(rng.random((P, O)) < 0.5, obs_ur, -1.0)
    cam_opt = rng.random(C) < 0.6
    cam_opt[0] = False
    cam_opt[1 % C] = C > 1
    args = (f32(R).contiguous(), f32(t).contiguous(), torch.tensor(cam_opt & (not frozen), device=dev), f32(pts),
            torch.tensor(obs_cam, dtype=torch.int32, device=dev), f32(obs_uv), f32(obs_w),
            torch.tensor(1e-1, device=dev), CFG.fx, CFG.fy, CFG.cx, CFG.cy, CFG.chi2_mono)
    kw = dict(obs_ur=f32(obs_ur), bf=STEREO_CFG.bf, delta2_stereo=STEREO_CFG.chi2_stereo) if stereo else {}
    return args, kw


def _assert_reduction_matches(got, want):
    """Each output within 1e-4 of the plain version, relative to the output's
    largest magnitude; Hll^-1 block by block (the block of a landmark without
    a live slot holds 1/1e-9)."""
    for name, g, w in zip(["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"], got, want):
        assert g.shape == w.shape, name
        d, m = (g - w).abs(), w.abs()
        if name == "Hll_inv":
            assert bool((d.amax((1, 2)) <= 1e-4 * m.amax((1, 2))).all()), name
        else:
            assert float(d.max()) <= 1e-4 * float(m.max()) + 1e-30, name


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("O", [1, 8, 12, 16, 24, 32])
@pytest.mark.parametrize("C", [2, 33, 64, 96])
def test_schur_kernel_shapes_match_plain_and_repeat(cuda, stereo, O, C):
    """O covers the three lane groups a landmark can take (8 lanes up to O = 8,
    16 up to 16, a whole warp up to 32 = MAX_OBS); P = 1003 is no multiple of
    the landmarks a block holds (16, 8 or 4);
    the problem has a landmark without a live slot and one that sees a camera
    twice. Damping 0.1 bounds each scaled landmark block's condition number
    by 31, so f32 rounding stays well inside 1e-4."""
    args, kw = _random_problem(cuda, 100 * C + O, C, 1003, O, stereo)
    got = schur.schur_reduce(*args, **kw)
    again = schur.schur_reduce(*args, **kw)
    want = schur.schur_reduce_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_reduction_matches(got, want)
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    if O >= 2:   # the duplicate camera's cross terms are in S_pair's diagonal block
        assert float(want[6][1 % C, :, 1 % C, :].abs().max()) > 0


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_schur_kernel_all_cameras_frozen(cuda, stereo):
    args, kw = _random_problem(cuda, 5, 33, 1003, 12, stereo, frozen=True)
    got = schur.schur_reduce(*args, **kw)
    want = schur.schur_reduce_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_reduction_matches(got[:2], want[:2])
    assert all(int(torch.count_nonzero(g)) == 0 for g in got[2:])


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_schur_kernel_index_given_or_built(cuda, stereo):
    args, kw = _random_problem(cuda, 6, 33, 1003, 12, stereo)
    idx = schur.camera_index(args[4], args[6], 33)
    got = schur.schur_reduce(*args, **kw, cam_index=idx)
    own = schur.schur_reduce(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, h) for g, h in zip(got, own))
    assert int(idx.cam_ptr[-1]) == int(((args[4] >= 0) & (args[4] < 33) & (args[6] > 0)).sum())


def test_schur_kernel_scratch_is_linear_in_the_observations(cuda):
    """At C=64, P=8192, O=12 the wrapper allocates under 40 MB beyond its
    seven outputs (index included), whatever C^2 x P is."""
    args, kw = _random_problem(cuda, 7, 64, 8192, 12, True)
    schur.schur_reduce(*args, **kw)   # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = schur.schur_reduce(*args, **kw)
    torch.cuda.synchronize()
    outputs = sum(x.numel() * x.element_size() for x in out)
    assert torch.cuda.max_memory_allocated() - base - outputs < 40e6


def test_schur_kernel_raises_where_it_has_no_path(cuda):
    prob = _ba_problem(cuda, n_pts=50)
    lam = torch.tensor(1e-3, device=cuda)
    with pytest.raises(ValueError, match="lm_opt"):   # a frozen-landmark mask of the wrong shape or type
        schur.schur_reduce(*_reduce_args(prob, lam), lm_opt=torch.ones(prob.xyz.shape[0] - 1, dtype=torch.bool,
                                                                        device=cuda))
    with pytest.raises(ValueError, match="lm_opt"):
        schur.schur_reduce(*_reduce_args(prob, lam), lm_opt=torch.ones(prob.xyz.shape[0], device=cuda))
    args, _ = _random_problem(cuda, 8, 4, 16, schur.MAX_OBS + 1, False)
    with pytest.raises(ValueError, match="observations per landmark"):
        schur.schur_reduce(*args)
    args, _ = _random_problem(cuda, 9, schur.MAX_CAMS + 1, 16, 4, False)
    with pytest.raises(ValueError, match="cameras"):
        schur.schur_reduce(*args)


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("O", [4, 12, 32])
def test_schur_kernel_frozen_landmarks_match_plain_and_repeat(cuda, stereo, O):
    """Kernel C's frozen-landmark mode (``lm_opt``) against the plain version:
    a seeded half of the landmarks frozen; each output within 1e-4 as
    above, the frozen rows' g_l and Y exactly zero, the call bitwise
    repeatable and counted as ``schur_reduce_frozen``, and the frozen
    landmarks' observations still in Hcc (pose-only edges)."""
    args, kw = _random_problem(cuda, 300 + O, 33, 1003, O, stereo)
    lm_opt = torch.from_numpy(np.random.default_rng(O).random(1003) < 0.5).to(cuda)
    before = dict(common.launches)
    got = schur.schur_reduce(*args, **kw, lm_opt=lm_opt)
    again = schur.schur_reduce(*args, **kw, lm_opt=lm_opt)
    want = schur.schur_reduce_plain(*args, **kw, lm_opt=lm_opt)
    free = schur.schur_reduce_plain(*args, **kw)
    torch.cuda.synchronize()
    assert common.launches["schur_reduce_frozen"] == before["schur_reduce_frozen"] + 2
    assert all(common.launches[k] == before[k] for k in ("schur_reduce", "schur_reduce_stereo"))
    _assert_reduction_matches(got, want)
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    frozen = ~lm_opt
    assert int(torch.count_nonzero(got[1][frozen])) == 0 and int(torch.count_nonzero(got[2][frozen])) == 0
    assert float((want[3] - free[3]).abs().max()) == 0.0   # Hcc does not depend on lm_opt
    assert float((want[6] - free[6]).abs().max()) > 1e-3 * float(free[6].abs().max())


def test_block_ba_on_the_card_follows_the_cpu(cuda):
    """Block BA on a small KITTI-style stereo corridor (``build_corridor_map``
    with each observation's right-x added from the truth, moved off its truth
    block by block): every block solve runs kernel C in its frozen-landmark
    mode, stereo rows included (rounds x 2 half-steps x n_blocks / 2 blocks x
    iters launches); the camera-centre error falls at least 2.5-fold; the
    card within 2e-3 in t and 5e-4 in R of the CPU and of a float64 solve
    (the CPU's f32 solve lies 5.6e-4 in t from the float64 one on this
    corridor, 72 m long: f32 sums in another order; without the right-x,
    where only the frozen boundary fixes each block's scale, 1.9e-3); and a
    second run on the card bit-equal."""
    from dialog_tpu_torch.config import KITTI00
    from dialog_tpu_torch.optim.block_ba import block_bundle_adjustment
    from dialog_tpu_torch.optim.synth_problem import build_corridor_map, perturb_block_local

    n_kf, lpk, nb, rounds, iters = 90, 100, 6, 2, 4
    cfg = KITTI00.replace(max_keyframes=128, max_landmarks=16384, max_features=512)
    m = build_corridor_map(cfg, n_kf=n_kf, lm_per_kf=lpk, device="cpu")
    kfs = m.kfs
    ok = kfs.feat_valid & (kfs.obs_lm >= 0)
    z = torch.einsum("kj,kfj->kf", kfs.R[:, 2], m.lms.xyz[kfs.obs_lm.clamp(min=0).long()]) + kfs.t[:, None, 2]
    m = m._replace(kfs=kfs._replace(u_right=torch.where(ok, kfs.uv[..., 0] - cfg.bf / z.clamp(min=1e-3), -1.0)))
    t_gt = m.kfs.t[:n_kf].clone()
    m = perturb_block_local(m, n_kf, lpk, -(-n_kf // nb), seed=1)
    kw = dict(n_blocks=nb, rounds=rounds, iters=iters, cams_pb=32, lms_pb=2048)

    def err(x):
        c = -torch.einsum("kij,ki->kj", x.kfs.R[:n_kf].cpu(), x.kfs.t[:n_kf].cpu())
        return float((c + t_gt).norm(dim=1).mean())

    def to(x, f):
        return type(x)(*[to(y, f) if hasattr(y, "_fields") else f(y) for y in x])

    on_card = to(m, lambda y: y.to(cuda))
    common.reset_launch_counts()
    got = block_bundle_adjustment(on_card, cfg, **kw)
    torch.cuda.synchronize()
    launches = dict(common.launches)
    again = block_bundle_adjustment(on_card, cfg, **kw)
    want = block_bundle_adjustment(m, cfg, **kw)
    exact = block_bundle_adjustment(to(m, lambda y: y.double() if y.is_floating_point() else y), cfg, **kw)
    assert launches["schur_reduce_frozen"] == rounds * 2 * (nb // 2) * iters
    assert launches["schur_reduce"] == launches["schur_reduce_stereo"] == 0
    for ref in (want, exact):
        dt = float((got.kfs.t.cpu().double() - ref.kfs.t.double()).abs().max())
        dR = float((got.kfs.R.cpu().double() - ref.kfs.R.double()).abs().max())
        assert dt < 2e-3 and dR < 5e-4, (dt, dR, err(m), err(got), err(want))
    assert err(got) < err(m) / 2.5 and err(want) < err(m) / 2.5, (err(m), err(got), err(want))
    for a, b in zip((got.kfs.R, got.kfs.t, got.lms.xyz), (again.kfs.R, again.kfs.t, again.lms.xyz)):
        assert torch.equal(a, b)


def test_segment_sum_repeats_on_the_card(cuda):
    """``ops.segment_sum`` gives the same bits on every call on the card (a
    float ``index_add_`` does not: ROADMAP D15) and agrees with the CPU."""
    from dialog_tpu_torch import ops

    rng = np.random.default_rng(0)
    n, n_rows = 400_000, 2049
    idx = torch.from_numpy(rng.integers(-10, n_rows + 10, n))
    vals = torch.from_numpy(rng.normal(0, 1, (n, 6)).astype(np.float32))
    order = ops.segment_order(idx.to(cuda), n_rows)
    got = ops.segment_sum(vals.to(cuda), order)
    assert all(torch.equal(got, ops.segment_sum(vals.to(cuda), order)) for _ in range(3))
    want = ops.segment_sum(vals, ops.segment_order(idx, n_rows))
    assert float((got.cpu() - want).abs().max()) < 1e-4


def test_global_ba_and_pose_graph_repeat_on_the_card(cuda):
    """The global BA (the PCG branch: its segment sums in a fixed order) and
    the pose graph repeat bit for bit on the card (ROADMAP D15, closed)."""
    from dialog_tpu_torch.optim.global_ba import global_bundle_adjustment
    from dialog_tpu_torch.optim.pose_graph import solve_pose_graph
    from dialog_tpu_torch.optim.synth_problem import make_pose_graph
    from test_torch_distributed import BRANCHES, engine_map

    cfg, m = engine_map(BRANCHES["pcg"])
    m = type(m)(*[type(x)(*[y.to(cuda) for y in x]) if hasattr(x, "_fields") else x.to(cuda) for x in m])
    a = global_bundle_adjustment(m, cfg, iters=4)
    b = global_bundle_adjustment(m, cfg, iters=4)
    for x, y in zip((a.kfs.R, a.kfs.t, a.lms.xyz, a.kfs.obs_lm), (b.kfs.R, b.kfs.t, b.lms.xyz, b.kfs.obs_lm)):
        assert torch.equal(x, y)
    pg = make_pose_graph(seed=0, K=256, device=cuda)
    p, q = solve_pose_graph(pg, iters=10), solve_pose_graph(pg, iters=10)
    assert all(torch.equal(x, y) for x, y in zip(p, q))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        fast.fast_nms_rank(torch.zeros((64, 64), dtype=torch.float64, device=cuda), 7.0, 20.0, 19)
    a = torch.zeros((16, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        hamming.hamming_best2(a, a, torch.ones(16, device=cuda), torch.ones(16, dtype=torch.bool, device=cuda))


# ---------------------------------------------------------------------------
# the pose LM kernel
# ---------------------------------------------------------------------------

POSE_HARD = {"outliers": dict(outlier_share=0.3), "behind": dict(n_behind=300), "none-valid": dict(valid_share=0.0),
             "far-start": dict(off=0.15), "no-observation": dict(n=0)}


def _pose(p, chi2, rounds, iters, fn=pose_only.pose_optimization):
    return fn(**p, chi2_th=chi2, rounds=rounds, iters=iters)


def _assert_pose_close(got, want):
    assert torch.equal(got.inlier, want.inlier) and int(got.n_inliers) == int(want.n_inliers)
    assert float((got.R - want.R).abs().max()) < 1e-4 and float((got.t - want.t).abs().max()) < 1e-4
    assert abs(float(got.cost) - float(want.cost)) <= 1e-5 * abs(float(want.cost)) + 1e-6


def _pose_checks(p, chi2, rounds, iters):
    """One launch a call, two calls bit for bit in fresh tensors, and the
    plain loop's answer on the card; returns the kernel's answer."""
    name = "pose_lm_stereo" if p["use_stereo"] else "pose_lm"
    common.reset_launch_counts()
    got = _pose(p, chi2, rounds, iters)
    again = _pose(p, chi2, rounds, iters)
    torch.cuda.synchronize()
    assert common.launches[name] == 2 and sum(common.launches.values()) == 2
    for a, b in zip(got, again):
        assert a.is_cuda and torch.equal(a, b) and (a.numel() == 0 or a.data_ptr() != b.data_ptr())
    assert got.n_inliers.dtype == torch.int64 and got.inlier.dtype == torch.bool
    _assert_pose_close(got, _pose(p, chi2, rounds, iters, pose_only.pose_optimization_plain))
    return got


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("rounds,iters", [(2, 6), (4, 10)])
@pytest.mark.parametrize("n", [2048, 1024, 1000, 37])
def test_pose_kernel_matches_plain_and_float64_reference(cuda, stereo, rounds, iters, n):
    from bench_port.reference import pose as ref_pose

    p = make_pose_problem(seed=n + rounds, n=n, stereo=stereo, device=cuda)
    chi2 = 7.815 if stereo else 5.991
    got = _pose_checks(p, chi2, rounds, iters)
    cam = dict(fx=p["fx"], fy=p["fy"], cx=p["cx"], cy=p["cy"], bf=p["bf"])
    R, t, inlier, _ = ref_pose.pose_optimization(p["R0"], p["t0"], p["X"], p["uv"], p["inv_sigma2"], p["valid"],
                                                 cam, chi2, rounds, iters, u_right=p["u_right"], mode="f64")
    assert torch.equal(got.inlier, inlier)
    assert float((got.R.double() - R).abs().max()) < 1e-4 and float((got.t.double() - t).abs().max()) < 1e-4


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("case", list(POSE_HARD))
def test_pose_kernel_hard_cases(cuda, stereo, case):
    p = make_pose_problem(**{"seed": 7, "n": 1024, "stereo": stereo, "device": cuda, **POSE_HARD[case]})
    got = _pose_checks(p, 7.815 if stereo else 5.991, 2, 6)
    if case in ("none-valid", "no-observation"):
        assert int(got.n_inliers) == 0 and float(got.cost) == 0.0 and torch.equal(got.t, p["t0"])
    else:
        assert int(got.n_inliers) > 0.5 * int(p["valid"].sum())


def test_pose_kernel_raises_on_what_it_does_not_take(cuda):
    p = make_pose_problem(seed=1, n=64, stereo=True, device=cuda)
    args = [p[k] for k in ("R0", "t0", "X", "uv", "inv_sigma2", "valid")]
    cam = (p["fx"], p["fy"], p["cx"], p["cy"], 5.991, 2, 6)
    bad = {2: p["X"].double(), 3: p["uv"].t().contiguous().t(), 4: p["inv_sigma2"][:63],
           5: p["valid"].to(torch.uint8), 0: p["R0"].cpu(), 1: p["t0"].reshape(1, 3)}
    assert not bad[3].is_contiguous()
    for i, x in bad.items():
        with pytest.raises(ValueError):
            pose_kernel.pose_lm(*args[:i], x, *args[i + 1 :], *cam)
    with pytest.raises(ValueError):
        pose_kernel.pose_lm(*args, *cam, u_right=None, bf=60.0, stereo=True)
    with pytest.raises(ValueError):
        pose_kernel.pose_lm(*args, p["fx"], p["fy"], p["cx"], p["cy"], 5.991, -1, 6)
    with pytest.raises(ValueError):
        pose_kernel.pose_lm(*[a.cpu() for a in args], *cam)


# ---------------------------------------------------------------------------
# the batched paths
# ---------------------------------------------------------------------------

KITTI_SMALL = dict(width=1241, height=376, n_features=2000, max_features=2048)


def _pyramid_stack(rng, B, cfg, dev):
    imgs = torch.from_numpy(rng.uniform(0, 255, (B, cfg.height, cfg.width)).astype(np.float32)).to(dev)
    # blocks of flat colour with noise on top: corners of every score, not only noise
    imgs = (imgs * 0.2 + 200.0 * (torch.arange(cfg.width, device=dev) // 37 % 2)
            * (torch.arange(cfg.height, device=dev)[:, None] // 29 % 2))
    return [p.contiguous() for p in fe.build_pyramid(imgs, cfg)]


@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("size", ["640x480", "1241x376"])
def test_fast_batch_bit_exact_in_one_launch(cuda, B, size):
    cfg = CFG if size == "640x480" else CFG.replace(**KITTI_SMALL)
    pyr = _pyramid_stack(np.random.default_rng(B), B, cfg, cuda)
    th = (float(cfg.min_th_fast), float(cfg.ini_th_fast), fe.BORDER)
    before = dict(common.launches)
    got = fast.fast_nms_rank_levels_batch(pyr, *th, pad_to=fe.CELL)
    assert common.launches["fast_nms_rank_batch"] == before["fast_nms_rank_batch"] + 1
    assert common.launches["fast_nms_rank"] == before["fast_nms_rank"]
    want = fast.fast_nms_rank_levels_batch_plain(pyr, *th, pad_to=fe.CELL)
    torch.cuda.synchronize()
    assert len(got) == cfg.n_levels
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    assert int((got[0] > 1000).sum()) > 100 * B
    # image by image through the one-image launch: the same bits
    for b in range(B):
        single = fast.fast_nms_rank_levels([p[b] for p in pyr], *th, pad_to=fe.CELL)
        assert all(torch.equal(s, g[b]) for s, g in zip(single, got))


def test_fast_batch_odd_sizes_and_errors(cuda):
    rng = np.random.default_rng(3)
    odd = [torch.from_numpy(rng.uniform(0, 255, (3, h, w)).astype(np.float32)).to(cuda)
           for h, w in [(61, 63), (62, 14), (15, 125), (1, 1), (7, 300), (129, 65), (40, 39)]]
    for th, pad in [((7.0, 20.0, 19), 1), ((2.0, 9.0, 4), 16), ((5.0, 12.0, 1), 5)]:
        got = fast.fast_nms_rank_levels_batch(odd, *th, pad_to=pad)
        want = fast.fast_nms_rank_levels_batch_plain(odd, *th, pad_to=pad)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        fast.fast_nms_rank_levels_batch([odd[0], odd[1][:2]], 7.0, 20.0, 19)
    with pytest.raises(ValueError):
        fast.fast_nms_rank_levels_batch([odd[0][0]], 7.0, 20.0, 19)
    with pytest.raises(ValueError):
        fast.fast_nms_rank_levels_batch([odd[0].transpose(1, 2)], 7.0, 20.0, 19)


@pytest.mark.parametrize("size", ["640x480", "1241x376"])
def test_batched_frontend_equals_per_image_on_the_card(cuda, size):
    cfg = CFG if size == "640x480" else CFG.replace(**KITTI_SMALL)
    scene = synth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=cfg)
    imgs = torch.from_numpy(np.stack([synth.render_image(scene, i) for i in range(4)])).to(cuda)
    before = dict(common.launches)
    batch = fe.extract_features_batch(imgs, cfg)
    assert common.launches["fast_nms_rank_batch"] == before["fast_nms_rank_batch"] + 1
    assert common.launches["fast_nms_rank"] == before["fast_nms_rank"]
    for b in range(imgs.shape[0]):
        one = fe.extract_features(imgs[b], cfg)
        for name in one._fields:
            assert torch.equal(getattr(one, name), getattr(batch, name)[b]), (b, name)
    assert int(batch.valid.sum()) > 0.8 * cfg.n_features * imgs.shape[0]


def test_batched_stereo_frontend_equals_per_pair_on_the_card(cuda):
    from dialog_tpu_torch import stereo
    from dialog_tpu_torch.config import KITTI00

    cfg = KITTI00.replace(max_keyframes=16, max_landmarks=4096)
    scene = synth.make_scene(seed=7, n_points=6000, n_frames=168, cfg=cfg)
    scene_r = scene._replace(t=scene.t - np.array([cfg.baseline, 0.0, 0.0], np.float32))
    left = torch.from_numpy(np.stack([synth.render_image(scene, i) for i in range(3)])).to(cuda)
    right = torch.from_numpy(np.stack([synth.render_image(scene_r, i) for i in range(3)])).to(cuda)
    before = dict(common.launches)
    batch = stereo.extract_and_match_stereo_batch(left, right, cfg)
    assert common.launches["fast_nms_rank_batch"] == before["fast_nms_rank_batch"] + 1
    for b in range(3):
        one = stereo.stereo_match_frames(fe.extract_features(left[b], cfg), fe.extract_features(right[b], cfg), cfg,
                                         img_left=left[b], img_right=right[b])
        for name in one._fields:
            assert torch.equal(getattr(one, name), getattr(batch, name)[b]), (b, name)
    assert int((batch.depth > 0).sum()) > 3 * 500


def test_pinned_pull_returns_the_blocking_copy(cuda):
    from dialog_tpu_torch.containers import pack_map_meta
    from dialog_tpu_torch.system import Engine

    eng = Engine(CFG.replace(max_keyframes=16, max_landmarks=1024), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for _ in range(5):
        # a long queue of work ahead of the copy: the bytes are right only after the event
        x = torch.randn((2048, 2048), device=cuda, generator=gen)
        for _ in range(20):
            x = x @ x * 1e-3
        packed = x[:8, :26].contiguous()
        pull = eng._start_pull(packed)
        assert pull[0].is_pinned() and pull[1] is not None
        got = Engine._finish_pull(pull)
        want = torch.cat([packed.reshape(-1), pack_map_meta(eng.m)]).cpu().numpy()
        np.testing.assert_array_equal(got, want)


def test_track_batch_on_the_card_follows_the_cpu_engine(cuda):
    from dialog_tpu_torch.containers import FrameArrays
    from dialog_tpu_torch.system import OK, Engine

    cfg = EngineConfig(max_features=512, max_keyframes=64, max_landmarks=8192, max_local_lms=1024,
                       max_frames_between_kf=8, vocab_words=256)
    N, B = 48, 4
    scene = synth.make_scene(seed=51, n_points=700, n_frames=N, cfg=cfg)
    frames = [synth.observe(scene, i, noise_px=0.4, device="cpu")[0] for i in range(N)]
    engines = {}
    for dev in ("cpu", cuda):
        eng = Engine(cfg, device=dev)
        common.reset_launch_counts()
        # both engines draw the same two-view minimal sets
        eng._gen = torch.Generator(device="cpu").manual_seed(cfg.n_features)
        for i in range(0, N, B):
            batch = FrameArrays(*[torch.stack(x).to(dev) for x in zip(*frames[i : i + B])])
            eng.track_batch(batch, [j / 30.0 for j in range(i, i + B)])
        eng.flush()
        engines[str(dev)] = eng
    a, b = engines["cpu"], engines[str(cuda)]
    assert [r.state for r in a.trajectory] == [r.state for r in b.trajectory]
    assert len(b.trajectory) == N and b.state == OK and a.kf_count == b.kf_count
    ok = np.array([r.state == OK for r in a.trajectory])
    assert float(np.abs(a.positions[ok] - b.positions[ok]).max()) < 5e-3
    # the card's engine ran each tracked frame's two pose optimizations as pose LM launches
    first_ok = int(np.argmax(ok))
    assert common.launches["pose_lm"] >= 2 * int(ok[first_ok + 1 :].sum()) > 0
    assert common.launches["pose_lm_stereo"] == 0


def test_pose_graph_on_the_card_follows_the_cpu(cuda):
    from dialog_tpu_torch.optim.pose_graph import solve_pose_graph
    from dialog_tpu_torch.optim.synth_problem import make_pose_graph

    got = solve_pose_graph(make_pose_graph(seed=0, K=256, device=cuda), iters=25)
    want = solve_pose_graph(make_pose_graph(seed=0, K=256, device="cpu"), iters=25)
    for g, w in zip(got[:3], want[:3]):
        assert float((g.cpu() - w).abs().max()) < 1e-4
    assert float(got[3]) < 1e-6 and float(want[3]) < 1e-6


def test_guided_sim3_matches_and_compute_sim3_on_the_card(cuda):
    from dialog_tpu_torch import loopclosing as lc
    from dialog_tpu_torch.sim3 import draw_sim3_sets
    from dialog_tpu_torch.system import Engine

    cfg = EngineConfig(max_features=512, max_keyframes=32, max_landmarks=8192, max_local_lms=1024,
                       max_frames_between_kf=4, vocab_min_kfs=1000)
    scene = synth.make_scene(seed=51, n_points=900, n_frames=40, cfg=cfg)
    eng = Engine(cfg, device=cuda)
    for i in range(40):
        eng.track_features(synth.observe(scene, i, noise_px=0.4, device=cuda)[0], i / 30.0)
    assert eng.kf_count >= 5
    m = eng.m
    m_cpu = type(m)(*[type(x)(*[None if y is None else y.cpu() for y in x]) if hasattr(x, "_fields") else x.cpu()
                      for x in m])
    seq = m.kfs.seq.cpu().numpy()
    live = [int(k) for k in np.argsort(seq) if bool(m.kfs.valid[k])]
    cur = live[-1]
    closed = 0
    for cand in live[-4:-1]:
        R = m.kfs.R[cand] @ m.kfs.R[cur].T
        t = m.kfs.t[cand] - R @ m.kfs.t[cur]
        s = torch.ones((), device=cuda)
        common.reset_launch_counts()
        n_card = int(lc._guided_sim3_matches(m, cur, cand, s, R, t, cfg))
        assert common.launches["hamming_mutual"] == 1
        n_cpu = int(lc._guided_sim3_matches(m_cpu, cur, cand, s.cpu(), R.cpu(), t.cpu(), cfg))
        assert n_card == n_cpu and n_card > 0
        pick = {}

        def draw(valid, iters, generator=None, pick=pick):
            if "p" not in pick:
                pick["p"] = draw_sim3_sets(valid.cpu(), iters, torch.Generator().manual_seed(cand))
            return pick["p"]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lc, "draw_sim3_sets", draw)
            a = lc.LoopCloser(cfg).compute_sim3(m, cur, cand)
            b = lc.LoopCloser(cfg).compute_sim3(m_cpu, cur, cand)
        assert (a is None) == (b is None)
        if a is not None:
            closed += 1
            assert abs(a.s - b.s) < 1e-3 and abs(a.n_inliers - b.n_inliers) <= 2
            np.testing.assert_allclose(a.R, b.R, atol=1e-3, rtol=0)
            np.testing.assert_allclose(a.t, b.t, atol=1e-3, rtol=0)
    assert closed >= 1


# --- global BA ---------------------------------------------------------------

@pytest.mark.parametrize("C", [128, 192])
def test_schur_kernel_at_global_ba_camera_counts(cuda, C):
    args, kw = _random_problem(cuda, 7, C, 4096, 12, stereo=False)
    got = schur.schur_reduce(*args)
    _assert_reduction_matches(got, schur.schur_reduce_plain(*args))
    assert all(torch.equal(a, b) for a, b in zip(got, schur.schur_reduce(*args)))


def test_schur_pcg_on_the_card_follows_the_cpu(cuda):
    from dialog_tpu_torch.optim.schur_pcg import solve_ba_pcg
    from dialog_tpu_torch.optim.synth_problem import FIXTURE_CFG, make_problem

    cpu = make_problem(seed=0, device="cpu")[0]
    card = make_problem(seed=0, device=cuda)[0]
    want = solve_ba_pcg(cpu, FIXTURE_CFG, iters=3, return_cg_iters=True)
    got = solve_ba_pcg(card, FIXTURE_CFG, iters=3, return_cg_iters=True)
    for g, w in zip(got[:3], want[:3]):
        assert float((g.cpu() - w).abs().max()) < 1e-4
    assert abs(int(got[4]) - int(want[4])) <= 2


def test_build_global_problem_on_the_card_equals_the_cpu(cuda):
    from dialog_tpu_torch.config import KITTI00
    from dialog_tpu_torch.optim.global_ba import build_global_problem
    from dialog_tpu_torch.optim.synth_problem import build_corridor_map

    cfg = KITTI00.replace(max_keyframes=64, max_landmarks=4096, max_features=512, max_obs_per_lm=3)
    m = build_corridor_map(cfg, n_kf=40, lm_per_kf=60, device="cpu")
    rng = np.random.default_rng(0)
    octave = torch.from_numpy(rng.integers(0, 8, m.kfs.octave.shape).astype(np.int32))
    m = m._replace(kfs=m.kfs._replace(octave=octave))
    want, n_want = build_global_problem(m, cfg)
    got, n_got = build_global_problem(type(m)(*[type(x)(*[y.to(cuda) for y in x]) if hasattr(x, "_fields")
                                                else x.to(cuda) for x in m]), cfg)
    assert int(n_got) == int(n_want) > 0
    for name in BAProblem._fields:
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            assert torch.equal(g.cpu(), w), name


@pytest.mark.parametrize("branch", ["dense", "pcg"])
def test_two_gloo_ranks_on_the_card_match_one(cuda, tmp_path, branch):
    import pathlib

    from dialog_tpu_torch.containers import load_map, save_map
    from dialog_tpu_torch.gba_rank import config_to_json, free_address, launch
    from dialog_tpu_torch.optim.global_ba import global_bundle_adjustment
    from test_torch_distributed import BRANCHES, engine_map

    cfg, m = engine_map(BRANCHES[branch])
    save_map(m, str(tmp_path / "m.npz"))
    want = global_bundle_adjustment(load_map(cfg, str(tmp_path / "m.npz"), device=cuda), cfg, iters=4)
    job = {"config": config_to_json(cfg), "map": str(tmp_path / "m.npz"), "iters": 4, "out": str(tmp_path / "o.npz")}
    spec = {"address": free_address(), "world": 2, "backend": "gloo", "device": "cuda", "jobs": [job]}
    got = [r[0] for r in launch(spec, str(tmp_path / "job.json"), timeout=300,
                                cwd=pathlib.Path(__file__).resolve().parent.parent)]
    assert [int(g["world"]) for g in got] == [2, 2]
    vk, vl = want.kfs.valid.cpu().numpy(), want.lms.valid.cpu().numpy()
    for g in got:
        np.testing.assert_allclose(g["R"][vk], want.kfs.R.cpu().numpy()[vk], atol=1e-4)
        np.testing.assert_allclose(g["t"][vk], want.kfs.t.cpu().numpy()[vk], atol=1e-4)
        np.testing.assert_allclose(g["xyz"][vl], want.lms.xyz.cpu().numpy()[vl], atol=1e-3)
    if branch == "dense":
        assert all(int(g["schur_launches"]) >= 4 for g in got)


def test_selfcheck_passes_on_the_card(cuda):
    from dialog_tpu_torch.kernels import selfcheck

    res = selfcheck.run()
    assert all(ok for ok, _ in res.values()), res
    assert selfcheck.main() == 0


def test_png_round_trip_on_the_card_machine(cuda, tmp_path):
    from dialog_tpu_torch.datasets import png

    rng = np.random.default_rng(4)
    gray = rng.integers(0, 256, (480, 640), dtype=np.uint8)
    rgb = np.stack([gray, gray, gray], -1)
    depth = rng.integers(0, 65536, (480, 640), dtype=np.uint16)
    for name, a, read in (("g", gray, png.read_gray), ("rgb", rgb, png.read_gray), ("d", depth, png.read_unchanged)):
        path = str(tmp_path / f"{name}.png")
        png.write_png(path, a)
        got = read(path)
        assert got.dtype == (np.uint16 if name == "d" else np.uint8)
        np.testing.assert_array_equal(got, gray if name == "rgb" else a)
    img = torch.from_numpy(png.read_gray(str(tmp_path / "rgb.png")).astype(np.float32)).to(cuda)
    got = fe.extract_features(img, CFG)
    want = fe.extract_features(torch.from_numpy(gray.astype(np.float32)).to(cuda), CFG)
    assert all(torch.equal(g, w) for g, w in zip(got, want))



@pytest.mark.parametrize("shape", [(700, 900), (2048, 2048), (5, 300, 400)])
def test_hamming_distance_matrix_on_the_card_equals_xor_popcount(cuda, shape):
    """``matching.hamming_distance_matrix`` on the card against the
    reference's definition, the popcount of the XOR (numpy's bit unpacking)."""
    from dialog_tpu_torch import matching

    rng = np.random.default_rng(12)
    *lead, n, m = shape
    a = rng.integers(0, 2**32, (*lead, n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (*lead, m, 8), dtype=np.uint32)
    a[..., 0, :], b[..., 0, :] = 0xFFFFFFFF, 0
    want = np.unpackbits((a[..., :, None, :] ^ b[..., None, :, :]).view(np.uint8), axis=-1).sum(-1)
    got = matching.hamming_distance_matrix(torch.from_numpy(a.view(np.int32)).to(cuda),
                                           torch.from_numpy(b.view(np.int32)).to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_read_profile_reads_what_the_event_list_reads(cuda):
    """``profile_main_path.read_profile`` (the raw event records) against ``prof.events()`` and
    ``key_averages()`` on a window of mixed kernels, copies, syncs and ``.item()`` reads: the same kernels, busy
    time (within the microsecond rounding of the event list) and the sync rows' counts (the event list folds an
    operator nested in one of the same name, ``aten::sum`` in ``aten::sum``, into one: the raw counts do not)."""
    from torch.profiler import ProfilerActivity, profile

    from dialog_tpu_torch import profile_main_path as pm

    x = torch.randn(256, 256, device=cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            y = (x @ x).relu().sum()
            y.item()
            x.cpu()
            torch.cuda.synchronize()
    got = pm.read_profile(prof)
    events = prof.events()
    kernels = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    assert got["device_kernels"] == kernels >= 60
    assert abs(got["device_busy_s"] - pm._busy_seconds(events)) <= 2e-6 * kernels
    rows = {r.key: r.count for r in prof.key_averages()}
    host = {k: n for k, (n, _) in got["host"].items()}
    assert {k: rows[k] for k in pm.SYNC_ROWS if k in rows} == {k: host[k] for k in pm.SYNC_ROWS if k in host}
    assert host["aten::item"] == 20 and host["cudaStreamSynchronize"] >= 20

def test_a_span_leaves_no_copy_on_the_devices_timeline(cuda):
    """``instrument.span`` under a profiler that traces host and device: a host event of operator
    scope that encloses the launches of its kernels, on the clock of the device's events, with no
    event of its own on the device's timeline. ``record_function``'s range beside it is a user
    annotation, which the profiler does copy onto the device's timeline: a reader of device events
    would take that copy for device work."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from dialog_tpu_torch.instrument import span

    x = torch.randn(256, 256, device=cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with span("slam::probe"):
                (x @ x).relu_()
            with record_function("bench::probe"):
                (x @ x).relu_()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_device = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    spans = [e for e in events if e.name() == "slam::probe"]
    assert len(spans) == 5 and not any(e.is_user_annotation() for e in spans)
    assert not any(e.name().startswith("slam::") for e in on_device)
    assert any(e.name() == "bench::probe" for e in on_device)
    launches = [e.start_ns() for e in events if "LaunchKernel" in e.name()]
    for s in spans:
        assert any(s.start_ns() <= t <= s.start_ns() + s.duration_ns() for t in launches)
    kernels = [e for e in on_device if not e.name().startswith(("Memcpy", "Memset", "bench::"))]
    assert kernels and abs(kernels[0].start_ns() - spans[0].start_ns()) < 10**9   # one clock, in ns
