"""Both engines on the stereo path at full KITTI00 width (ROADMAP D7).

The first two pairs of the stereo path (``profile_main_path.WORKLOADS["stereo"]``:
1241x376, 2,048 features, 32,768 landmarks, ``make_scene(seed=7)``), both
engines with loop closing off and no vocabulary within the run, each on its
own frontend, driven by ``tools/stereo_parity_trace.py``'s ``drive``, which
also replays the port's tracking step and keyframe pipeline step by step on
the JAX engine's state at frame 1.

What the run shows, and these tests hold:

* through frame 1 the engines decide alike (state, n_tracked, keyframes) and
  their camera centres agree within 1e-3 m; after frame 0 their maps hold
  the same 519 landmarks;
* on the JAX engine's map, every step of the keyframe pipeline at frame 1
  agrees except ``triangulate_fanout``, and the port's tracking step agrees
  on the JAX engine's inputs;
* the candidates ``triangulate_fanout`` treats differently are rounding
  edges: the same float32 inputs, normal equations whose condition number
  passes 1e5, points that differ by more than 1e-4 relative between the
  packages. Candidate 1793 (matched to feature 1823 of keyframe 0) is the
  pinned one: its parallax cosine, evaluated in float64, lies below the gate's
  0.99995 at the JAX engine's point and above it at the port's, with a
  condition number above 1e7, so float32 has no digit to decide it with;
* R11 (a fault of the reference, mirrored): every landmark either package
  triangulates there lies within 5 cm in front of the new keyframe's camera,
  on a scene whose points lie 4-12 m away.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

import stereo_parity_trace as spt  # noqa: E402

PINNED = (1793, 1823)
PARALLAX_GATE = 0.99995


@pytest.fixture(scope="module")
def run():
    return spt.drive(seed=7, n_frames=2, frames_from="own", replay=True, log=lambda msg: None)


def test_engines_decide_alike_through_the_second_keyframe(run):
    rows = run["per_frame"]
    assert [r["jax"] for r in rows] == [r["port"] for r in rows]
    assert [r["jax"][0] for r in rows] == ["OK", "OK"] and rows[1]["jax"][2] == 2
    assert max(r["centre_gap_m"] for r in rows) < 1e-3
    assert rows[0]["lms_jax"] == rows[0]["lms_port"] == [519, 519]


def test_keyframe_pipeline_splits_only_at_triangulation(run):
    (kf,) = run["keyframes"]
    assert kf["frame"] == 1 and kf["split_steps"] == ["triangulate_fanout"]
    assert run["per_frame"][1]["track_replay"]["diffs"] == []
    cands = kf["first_split"]["candidates"]
    assert cands and all(c["rounding_edge"] for c in cands)
    for c in cands:
        assert c["normal_eq_cond"] > 1e5
        gap = np.linalg.norm(np.subtract(c["jax"]["X"], c["port"]["X"]))
        assert gap > spt.REL_TOL * np.linalg.norm(c["jax"]["X"])


def test_pinned_candidate_sits_on_both_sides_of_the_parallax_gate(run):
    (pin,) = [c for c in run["keyframes"][0]["first_split"]["candidates"] if tuple(c["features"]) == PINNED]
    assert pin["keyframes"] == [1, 0] and pin["jax_match"] == pin["port_match"] == PINNED[1]
    assert pin["jax_creates"] and not pin["port_creates"]
    cos_j, gate_j = pin["jax"]["parallax_cos"]
    cos_t, gate_t = pin["port"]["parallax_cos"]
    assert gate_j == gate_t == PARALLAX_GATE
    assert cos_j < PARALLAX_GATE < cos_t
    assert pin["normal_eq_cond"] > 1e7
    # every other gate passes at both points: the parallax alone decides
    for side in ("jax", "port"):
        for g in ("z_a", "z_b"):
            assert pin[side][g][0] > pin[side][g][1]
        for g in ("chi2_a", "chi2_b"):
            assert pin[side][g][0] < pin[side][g][1]
    assert pin["hamming"][0] <= pin["hamming"][1] and pin["epipolar_px2"][0] < pin["epipolar_px2"][1]


def test_r11_triangulated_points_lie_at_the_camera(run):
    for c in run["keyframes"][0]["first_split"]["candidates"]:
        for side in ("jax", "port", "float64"):
            assert 0.0 < c[side]["z_a"][0] < 0.5, (c["features"], side)
    depths = run["keyframes"][0]["first_split"]["new_depths_m"]
    for side in ("jax", "port"):
        assert depths[side] and 0.0 < min(depths[side]) and max(depths[side]) < 0.05, (side, depths[side])
