"""The port's CLI on the reference CLI tests' sequence layouts, on the CPU.

Sequences of 6 frames at 320x240 are written with cv2 in the layouts of
``tests/test_cli_tum_kitti.py`` and ``tests/test_cli_euroc.py`` (TUM colour
frames, 16-bit depth stamped 12 ms late, ground truth; KITTI stereo pairs
and a devkit poses file; EuRoC ``mav0``), and every subcommand and mode of
``dialog_tpu_torch.cli`` runs on them with ``--device cpu``: it reports the
same number of frames as the reference's CLI on the same files, passes the
reference tests' gates ("tracked" printed, one trajectory line per frame in
the TUM or KITTI format, stereo initialized on the first frame, the devkit
and ATE line after ``--gt``) and writes its render. The two engines may part
(ROADMAP D1, D3, D5), so gates and formats are compared, not trajectories.
R3: ``run-kitti --gt`` scores the frames tracked OK only (a LOST frame in
the sequence is left out); R8: ``run-tum`` and ``run-euroc`` pair each OK
frame with the ground-truth row at its timestamp; R2: an ATE that is not
finite prints as undefined.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from dialog_tpu.cli import main as ref_main
from dialog_tpu_torch import cli
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.datasets import png, synth

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

CFG = EngineConfig(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0, n_features=300, max_features=512)
N = 6
YAML = ("Camera.fx: 260.0\nCamera.fy: 260.0\nCamera.cx: 160.0\nCamera.cy: 120.0\nCamera.width: 320\n"
        "Camera.height: 240\nCamera.fps: {fps}\n{extra}ORBextractor.nFeatures: 300\n")


def _img(scene, i):
    return synth.render_image(scene, i).clip(0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    root = tmp_path_factory.mktemp("seqs")
    # TUM: colour frames, depth 12 ms late, ground truth
    tum = root / "tum"
    scene = synth.make_scene(seed=11, n_points=500, n_frames=N, cfg=CFG)
    os.makedirs(tum / "rgb")
    os.makedirs(tum / "depth")
    rgb, depth, gt = [], [], []
    for i in range(N):
        ts = 1305031102.175304 + i * 0.05
        g = _img(scene, i)
        cv2.imwrite(str(tum / "rgb" / f"{ts:.6f}.png"), np.stack([g, g, g], -1))
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        d16 = np.clip(synth.render_depth(scene, i) * 5000.0, 0, 65535).astype(np.uint16)
        cv2.imwrite(str(tum / "depth" / f"{ts + 0.012:.6f}.png"), d16)
        depth.append(f"{ts + 0.012:.6f} depth/{ts + 0.012:.6f}.png")
        C = -scene.R[i].T @ scene.t[i]
        gt.append(f"{ts:.6f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} 0 0 0 1")
    (tum / "rgb.txt").write_text("# color images\n# timestamp filename\n" + "\n".join(rgb) + "\n")
    (tum / "depth.txt").write_text("# depth images\n" + "\n".join(depth) + "\n")
    (tum / "groundtruth.txt").write_text("# ground truth\n" + "\n".join(gt) + "\n")
    # KITTI: stereo pairs (and a copy whose frame 3 is black in both cameras), devkit poses
    scene = synth.make_scene(seed=12, n_points=1500, n_frames=N, cfg=CFG)
    scene_r = scene._replace(t=scene.t - np.array([0.3, 0, 0], np.float32))
    rows = []
    for name in ("00", "01"):
        seq = root / "kitti" / name
        os.makedirs(seq / "image_0")
        os.makedirs(seq / "image_1")
        for i in range(N):
            for cam, sc in (("image_0", scene), ("image_1", scene_r)):
                img = np.zeros((240, 320), np.uint8) if name == "01" and i == 3 else _img(sc, i)
                cv2.imwrite(str(seq / cam / f"{i:06d}.png"), img)
        (seq / "times.txt").write_text("\n".join(f"{i * 0.1:.6e}" for i in range(N)) + "\n")
    for i in range(N):
        P = np.hstack([scene.R[i].T, (-scene.R[i].T @ scene.t[i])[:, None]])
        rows.append(" ".join(f"{x:.6e}" for x in P.reshape(-1)))
    (root / "kitti" / "gt.txt").write_text("\n".join(rows) + "\n")
    # EuRoC: mav0 with two cameras and ground truth
    euroc = root / "euroc"
    scene = synth.make_scene(seed=9, n_points=500, n_frames=N, cfg=CFG)
    scene_r = scene._replace(t=scene.t - np.array([0.11, 0, 0], np.float32))
    gt_rows = []
    for cam, sc in (("cam0", scene), ("cam1", scene_r)):
        d = euroc / "mav0" / cam / "data"
        os.makedirs(d)
        with open(euroc / "mav0" / cam / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i in range(N):
                ts_ns = int((1403636579 + i * 0.05) * 1e9)
                cv2.imwrite(str(d / f"{ts_ns}.png"), _img(sc, i))
                f.write(f"{ts_ns},{ts_ns}.png\n")
                if cam == "cam0":
                    gt_rows.append((ts_ns, *(-sc.R[i].T @ sc.t[i])))
    gd = euroc / "mav0" / "state_groundtruth_estimate0"
    os.makedirs(gd)
    with open(gd / "data.csv", "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m]\n")
        f.write("".join(",".join(str(x) for x in r) + "\n" for r in gt_rows))
    yamls = {}
    for name, fps, extra in (("tum", 20.0, "Camera.bf: 31.2\nDepthMapFactor: 5000.0\n"),
                             ("kitti", 10.0, "Camera.bf: 78.0\n"), ("euroc", 20.0, "Camera.bf: 28.6\n")):
        yamls[name] = root / f"{name}.yaml"
        yamls[name].write_text(YAML.format(fps=fps, extra=extra))
    return {"tum": str(tum), "kitti": str(root / "kitti" / "00"), "kitti_lost": str(root / "kitti" / "01"),
            "kitti_gt": str(root / "kitti" / "gt.txt"), "euroc": str(euroc), "yaml": yamls}


def _frames(printed: str) -> int:
    """The frame count of the 'tracked k/n' line."""
    return int(re.search(r"tracked \d+/(\d+)", printed).group(1))


# mode -> (argv after the subcommand's sequence, the sequence's key, the settings' key, trajectory fields)
RUNS = {
    "tum-mono": (["run-tum"], "tum", "tum", 8),
    "tum-pipelined": (["run-tum", "--pipelined"], "tum", "tum", 8),
    "tum-rgbd": (["run-tum", "--rgbd"], "tum", "tum", 8),
    "kitti-stereo-gt": (["run-kitti", "--gt", "{kitti_gt}"], "kitti", "kitti", 12),
    "kitti-mono": (["run-kitti", "--mono"], "kitti", "kitti", 12),
    "euroc-stereo": (["run-euroc"], "euroc", "euroc", 8),
    "euroc-mono": (["run-euroc", "--mono"], "euroc", "euroc", 8),
}


@pytest.mark.parametrize("mode", sorted(RUNS))
def test_cli_runs_under_the_reference_gates(seqs, tmp_path, capsys, mode):
    argv, seq, settings, fields = RUNS[mode]
    argv = [a.format(**seqs) for a in argv]
    argv = argv[:1] + [seqs[seq], "--settings", str(seqs["yaml"][settings])] + argv[1:]
    out, ref_out, img = tmp_path / "traj.txt", tmp_path / "ref_traj.txt", tmp_path / "map.png"
    cli.main(argv + ["--out", str(out), "--render", str(img), "--device", "cpu"])
    printed = capsys.readouterr().out
    ref_main(argv + ["--out", str(ref_out)])
    ref_printed = capsys.readouterr().out
    assert "tracked" in printed and "input wait:" in printed
    assert _frames(printed) == _frames(ref_printed) == N
    lines = out.read_text().splitlines()
    assert len(lines) == len(ref_out.read_text().splitlines()) == N
    assert all(len(line.split()) == fields for line in lines)
    assert png.read_unchanged(str(img)).shape == (910, 1170, 3)
    if "stereo" in mode or "rgbd" in mode:
        assert "keyframes: 0" not in printed   # stereo and RGB-D initialize on the first frame
    if "--gt" in argv:
        assert "KITTI devkit" in printed and "ATE RMSE" in printed


@pytest.mark.parametrize("trajectory", ["sweep", "loop"])
def test_run_synth(tmp_path, capsys, trajectory):
    """16 frames: the sweep initializes, the loop (a lap in 16 frames) never
    does, and its ATE prints as undefined (R2; the reference's run-synth
    raises there, stacking no ground truth: R7)."""
    out = tmp_path / "traj.txt"
    argv = ["run-synth", "--frames", "16", "--trajectory", trajectory]
    cli.main(argv + ["--out", str(out), "--device", "cpu"])
    printed = capsys.readouterr().out
    if trajectory == "sweep":
        ref_main(argv)
        assert _frames(capsys.readouterr().out) == 16
    else:
        with pytest.raises(ValueError, match="at least one array"):
            ref_main(argv)
    assert _frames(printed) == 16
    ate = re.search(r"ATE (undefined|[\d.]+ cm)", printed).group(1)
    assert (ate == "undefined") == (trajectory == "loop")
    assert len(out.read_text().splitlines()) == 16
    # the engine's counters, one JSON line after the timing line: on the sweep every keyframe
    # after the two of the initial map was taken by one trigger
    lines = printed.splitlines()
    at = next(i for i, line in enumerate(lines) if line.startswith("median track time:"))
    assert lines[at + 1].startswith("engine stats: {")
    stats = json.loads(lines[at + 1].removeprefix("engine stats: "))
    kfs = int(re.search(r"kfs (\d+)", printed).group(1))
    if trajectory == "sweep":
        assert stats["kf_weak"] + stats["kf_starving"] + stats["kf_stale"] == kfs - 2 > 0
    else:
        assert stats["kf_weak"] + stats["kf_starving"] + stats["kf_stale"] == kfs == 0


def test_r3_gt_scores_the_frames_tracked_ok_only(seqs, capsys):
    """Frame 3 of the sequence is black in both cameras: the engine loses
    it, and the devkit line scores the frames tracked OK, not the LOST
    placeholders (the reference scores every frame)."""
    cli.main(["run-kitti", seqs["kitti_lost"], "--settings", str(seqs["yaml"]["kitti"]), "--gt", seqs["kitti_gt"],
              "--device", "cpu"])
    printed = capsys.readouterr().out
    n_ok = int(re.search(r"tracked (\d+)/6 frames", printed).group(1))
    assert 0 < n_ok < N
    assert f"{n_ok}/{N} frames OK" in printed


class _Record:
    def __init__(self, timestamp, state):
        self.timestamp, self.state = timestamp, state


class _Run:
    """What ``cli._finish`` and ``gt_per_frame`` read of an engine."""

    def __init__(self, stamps, states, positions):
        self.trajectory = [_Record(t, s) for t, s in zip(stamps, states)]
        self.positions, self.kf_count, self.stats = positions, 2, {}


def test_r8_ground_truth_is_paired_by_timestamp(capsys):
    """Ground truth at 200 Hz from a second before the first frame, frames at
    20 Hz whose first three are not OK: each OK frame is scored against the
    row at its own timestamp (here the estimate is the truth at twice the
    scale, so the aligned ATE is 0), not the k-th row (the reference's
    pairing, which gives a large error on these files)."""
    gt_t = 100.0 + np.arange(1200) / 200.0
    gt_p = np.stack([np.sin(4 * (gt_t - 100.0)), np.cos(3 * (gt_t - 100.0)), 0.2 * (gt_t - 100.0)], 1)
    stamps = 101.0 + np.arange(40) / 20.0 + 1e-4
    states = ["NOT_INITIALIZED"] * 3 + ["OK"] * 37
    truth = gt_p[np.round((stamps - 100.0) * 200.0).astype(int)]
    run = _Run(stamps, states, 2.0 * truth + 5.0)
    per_frame = cli.gt_per_frame(run, (gt_t, gt_p))
    np.testing.assert_array_equal(per_frame, truth)
    far = _Run([50.0, stamps[5]], ["OK", "OK"], np.zeros((2, 3)))
    assert np.isnan(cli.gt_per_frame(far, (gt_t, gt_p))[0]).all()   # no row within 20 ms
    cli._finish(run, [0.01] * 40, None, "tum", (gt_t, gt_p))
    printed = capsys.readouterr().out
    assert "ATE RMSE (scale-aligned): 0.00 cm over 37 OK frames with ground truth" in printed
    from dialog_tpu_torch.eval.ate import ate_rmse

    assert ate_rmse(run.positions[3:], gt_p[:37]) > 0.1   # the reference's pairing


def test_r2_a_non_finite_ate_prints_as_undefined():
    assert cli._ate_text(float("nan"), 100, "cm") == "undefined"
    assert cli._ate_text(float("inf"), 1, "m") == "undefined"
    assert cli._ate_text(0.01234, 100, "cm") == "1.23 cm"


def test_the_device_is_the_card_unless_asked():
    for argv in (["run-synth"], ["run-tum", "x"], ["run-kitti", "x"], ["run-euroc", "x"], ["bench"]):
        assert cli.parser().parse_args(argv).device == "cuda"


@pytest.mark.parametrize("argv, want", [
    (["bench"], ["--device", "cuda"]),
    (["bench", "--only", "kf10"], ["--only", "kf10", "--device", "cuda"]),
    (["bench", "--only", "stereo", "--device", "cpu"], ["--only", "stereo", "--device", "cpu"]),
])
def test_r9_bench_parses_its_own_flags(monkeypatch, argv, want):
    """R9: the subcommand hands bench.main its own flags, not the process's arguments."""
    from dialog_tpu_torch import bench

    calls = []
    monkeypatch.setattr(bench, "main", lambda a=None: calls.append(a))
    cli.main(argv)
    assert calls == [want]
    with pytest.raises(SystemExit):
        cli.main(["bench", "--only", "kf20"])


@pytest.mark.parametrize("argv, error", [
    (["bench", "--only", "kf10"], "dialog-tpu: error: unrecognized arguments: --only kf10"),
    (["bench"], "error: unrecognized arguments: bench"),
])
def test_r9_the_reference_bench_subcommand_exits_with_a_usage_error(argv, error):
    """R9, the reference's side: its subparser declares no --only, and its bench.main parses sys.argv, which still
    holds the subcommand. Run in a child: importing bench.py turns on JAX's persistent compilation cache."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "dialog_tpu.cli", *argv], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and error in out.stderr, out.stderr
