"""The port's sequence loaders and prefetcher against the reference's.

Tolerance: exact. On the same ``tmp_path`` sequences, written with cv2 in
each dataset's layout (TUM ``rgb.txt``/``depth.txt``/``groundtruth.txt`` with
colour frames and 16-bit depth stamped 12 ms late and one depth file
missing; KITTI ``times.txt`` with ``image_0``/``image_1`` and a devkit poses
file; EuRoC ``mav0`` CSVs with a frame only cam0 has), the port's iterators
yield the reference's timestamps and float32 arrays bit for bit (the port
decodes PNG itself, the reference with cv2), and ``associate``,
``load_groundtruth``, ``load_poses`` and ``load_poses_full`` return the
reference's values. The reference's prefetcher tests
(``tests/test_cli_tum_kitti.py::TestPrefetcher``) are cases of one test on
the port's ``Prefetcher``.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from dialog_tpu.datasets import euroc as jeuroc
from dialog_tpu.datasets import kitti as jkitti
from dialog_tpu.datasets import tum as jtum
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.datasets import euroc, kitti, synth, tum
from dialog_tpu_torch.datasets.prefetch import Prefetcher, prefetch

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

CFG = EngineConfig(width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0)
N = 5


def _img(scene, i):
    return synth.render_image(scene, i).clip(0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum")
    scene = synth.make_scene(seed=11, n_points=300, n_frames=N, cfg=CFG)
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    rgb, depth, gt = [], [], []
    for i in range(N):
        ts = 1305031102.175304 + i * 0.05
        g = _img(scene, i)
        cv2.imwrite(str(root / "rgb" / f"{ts:.6f}.png"), np.stack([g, np.roll(g, 2, 0), 255 - g], -1))
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        dts = ts + 0.012
        if i != 3:   # a depth file that is listed but missing: the pair is skipped
            d16 = np.clip(synth.render_depth(scene, i) * 5000, 0, 65535).astype(np.uint16)
            cv2.imwrite(str(root / "depth" / f"{dts:.6f}.png"), d16)
        depth.append(f"{dts:.6f} depth/{dts:.6f}.png")
        C = -scene.R[i].T @ scene.t[i]
        gt.append(f"{ts:.6f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} 0 0 0 1")
    (root / "rgb.txt").write_text("# color images\n# timestamp filename\n" + "\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("# depth\n" + "\n".join(depth) + "\n")
    (root / "groundtruth.txt").write_text("# ground truth\n" + "\n".join(gt) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti") / "00"
    scene = synth.make_scene(seed=12, n_points=300, n_frames=N, cfg=CFG)
    scene_r = scene._replace(t=scene.t - np.array([0.3, 0, 0], np.float32))
    os.makedirs(root / "image_0")
    os.makedirs(root / "image_1")
    rows = []
    for i in range(N):
        for cam, sc in (("image_0", scene), ("image_1", scene_r)):
            cv2.imwrite(str(root / cam / f"{i:06d}.png"), _img(sc, i))
        P = np.hstack([scene.R[i].T, (-scene.R[i].T @ scene.t[i])[:, None]])
        rows.append(" ".join(f"{x:.6e}" for x in P.reshape(-1)))
    (root / "times.txt").write_text("\n".join(f"{i * 0.1:.6e}" for i in range(N)) + "\n")
    (root.parent / "00_gt.txt").write_text("\n".join(rows) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("euroc")
    scene = synth.make_scene(seed=9, n_points=300, n_frames=N, cfg=CFG)
    scene_r = scene._replace(t=scene.t - np.array([0.11, 0, 0], np.float32))
    for cam, sc in (("cam0", scene), ("cam1", scene_r)):
        d = root / "mav0" / cam / "data"
        os.makedirs(d)
        with open(root / "mav0" / cam / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i in range(N if cam == "cam0" else N - 1):   # the last frame only in cam0
                ts_ns = int((1403636579 + i * 0.05) * 1e9)
                cv2.imwrite(str(d / f"{ts_ns}.png"), _img(sc, i))
                f.write(f"{ts_ns},{ts_ns}.png\n")
    gd = root / "mav0" / "state_groundtruth_estimate0"
    os.makedirs(gd)
    with open(gd / "data.csv", "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m]\n")
        for i in range(N):
            C = -scene.R[i].T @ scene.t[i]
            f.write(",".join(str(x) for x in (int((1403636579 + i * 0.05) * 1e9), *C)) + "\n")
    return str(root)


def _same_stream(got, want, n):
    got, want = list(got), list(want)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert len(g) == len(w) and g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stream", ["tum-mono", "tum-rgbd", "kitti-stereo", "kitti-mono", "euroc-stereo",
                                    "euroc-mono", "euroc-mono-cam1"])
def test_iterators_equal_the_reference(tum_dir, kitti_dir, euroc_dir, stream):
    got, want, n = {
        "tum-mono": lambda: (tum.iter_mono(tum_dir), jtum.iter_mono(tum_dir), N),
        "tum-rgbd": lambda: (tum.iter_rgbd(tum_dir), jtum.iter_rgbd(tum_dir), N - 1),
        "kitti-stereo": lambda: (kitti.iter_stereo(kitti_dir), jkitti.iter_stereo(kitti_dir), N),
        "kitti-mono": lambda: (kitti.iter_mono(kitti_dir), jkitti.iter_mono(kitti_dir), N),
        "euroc-stereo": lambda: (euroc.iter_stereo(euroc_dir), jeuroc.iter_stereo(euroc_dir), N - 1),
        "euroc-mono": lambda: (euroc.iter_mono(euroc_dir), jeuroc.iter_mono(euroc_dir), N),
        "euroc-mono-cam1": lambda: (euroc.iter_mono(euroc_dir, "cam1"), jeuroc.iter_mono(euroc_dir, "cam1"), N - 1),
    }[stream]()
    _same_stream(got, want, n)


def test_ground_truth_and_poses_equal_the_reference(tum_dir, kitti_dir, euroc_dir):
    for got, want in [(tum.load_groundtruth(tum_dir), jtum.load_groundtruth(tum_dir)),
                      (euroc.load_groundtruth(euroc_dir), jeuroc.load_groundtruth(euroc_dir))]:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    gt = os.path.join(os.path.dirname(kitti_dir), "00_gt.txt")
    np.testing.assert_array_equal(kitti.load_poses(gt), jkitti.load_poses(gt))
    for g, w in zip(kitti.load_poses_full(gt), jkitti.load_poses_full(gt)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert kitti.read_times(kitti_dir) == jkitti.read_times(kitti_dir)


@pytest.mark.parametrize("max_dt", [0.005, 0.02, 0.1])
def test_associate_equals_the_reference(max_dt):
    rng = np.random.default_rng(int(max_dt * 1000))
    a = [(float(t), f"a{i}") for i, t in enumerate(np.sort(rng.uniform(0, 2, 40)))]
    b = [(float(t), f"b{i}") for i, t in enumerate(np.sort(rng.uniform(0, 2, 35)))]
    assert tum.associate(a, b, max_dt) == jtum.associate(a, b, max_dt)
    assert tum.associate(a, [], max_dt) == []


def _gen_raises():
    yield 1
    yield 2
    raise ValueError("decode failed")


@pytest.mark.parametrize("case", ["order_and_completion", "producer_exception_reraises",
                                  "exhausted_iterator_stays_stopped", "small_queue_still_terminates",
                                  "close_unblocks_producer"])
def test_prefetcher(case):
    if case == "order_and_completion":
        assert list(prefetch(iter(range(100)), depth=3)) == list(range(100))
    elif case == "producer_exception_reraises":
        got = []
        with pytest.raises(ValueError, match="decode failed"):
            for x in prefetch(_gen_raises(), depth=2):
                got.append(x)
        assert got == [1, 2]
    elif case == "exhausted_iterator_stays_stopped":
        it = prefetch(iter(range(5)), depth=2)
        assert list(it) == [0, 1, 2, 3, 4]
        assert list(it) == []
    elif case == "small_queue_still_terminates":
        # a producer finishing against a FULL queue must still deliver its end
        it = prefetch(iter(range(10)), depth=1)
        time.sleep(0.3)
        assert list(it) == list(range(10))
    elif case == "close_unblocks_producer":
        state = {"released": False}

        def gen():
            try:
                for i in range(10_000):
                    yield i
            finally:
                state["released"] = True

        with Prefetcher(gen(), depth=2) as it:
            assert next(it) == 0
        assert state["released"]
        assert threading.active_count() < 20

