"""The port at the full KITTI00 preset's capacities (``tests/test_kitti_capacity.py`` on the port).

The corridor map of ``synth_problem.build_corridor_map`` (1,100 live keyframes
of 2,048, 137,500 landmarks of 262,144, 4 observers each), a keyframe with a
3-iteration local BA at that occupancy, then the global problem, which must
select the PCG, and one ``global_bundle_adjustment(iters=1)``: finite poses
and landmarks, and the corridor's keyframes within 0.5 m of their places
(median), as the reference's soak test holds its own.

Marked ``slow``: a full-size configuration. It runs on the card when there is
one (``python -m pytest --noconftest -m slow tests/test_torch_kitti_capacity.py``)
and on the CPU otherwise; ``chip_smoke.py``'s ``gba_capacity`` phase drives the
same case on the card with its times.
"""

import pytest
import torch

from dialog_tpu_torch import mapping
from dialog_tpu_torch.config import KITTI00
from dialog_tpu_torch.containers import FrameArrays
from dialog_tpu_torch.optim.global_ba import DENSE_SCHUR_MAX_CAMS, build_global_problem, global_bundle_adjustment
from dialog_tpu_torch.optim.local_ba import local_bundle_adjustment
from dialog_tpu_torch.optim.synth_problem import build_corridor_map

pytestmark = pytest.mark.slow
torch.set_num_threads(2)

N_KF, STEP = 1100, 0.8


@pytest.fixture
def device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def test_capacity_pipeline(device):
    cfg = KITTI00
    m = build_corridor_map(cfg, n_kf=N_KF, step=STEP, device=device)
    assert int(m.kfs.valid.sum()) >= 1000
    k = N_KF - 1
    kfs = m.kfs
    frame = FrameArrays(uv=kfs.uv[k], uv_raw=kfs.uv[k], response=torch.where(kfs.feat_valid[k], 50.0, 0.0),
                        octave=kfs.octave[k], angle=kfs.angle[k], desc=kfs.desc[k], valid=kfs.feat_valid[k],
                        u_right=kfs.u_right[k], depth=kfs.depth[k])
    t_new = torch.tensor([0.0, 0.0, -(N_KF - 0.5) * STEP], device=device)
    m2 = mapping.process_new_keyframe(m, frame, torch.eye(3, device=device), t_new, kfs.obs_lm[k], N_KF, N_KF / 10.0,
                                      N_KF, k, cfg, spawn_depth=True, n_neighbors=cfg.kf_tri_neighbors)
    m2 = local_bundle_adjustment(m2, N_KF, cfg, iters=3)
    assert bool(m2.kfs.valid[N_KF]) and bool(torch.isfinite(m2.kfs.t[N_KF]).all())

    prob, _ = build_global_problem(m2, cfg)
    assert prob.cam_slots.shape[0] > DENSE_SCHUR_MAX_CAMS     # the PCG is selected
    m3 = global_bundle_adjustment(m2, cfg, iters=1)
    vk, vl = m3.kfs.valid, m3.lms.valid
    assert bool(torch.isfinite(m3.kfs.R[vk]).all() and torch.isfinite(m3.kfs.t[vk]).all())
    assert bool(torch.isfinite(m3.lms.xyz[vl]).all())
    t_err = (m3.kfs.t[:N_KF, 2] + torch.arange(N_KF, device=device) * STEP).abs()
    assert float(t_err.median()) < 0.5
