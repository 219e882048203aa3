"""Offline map + trajectory renderer (the viewer, demoted off the hot path).

The reference runs a live Pangolin thread (canonical ``src/Viewer.cc`` +
``src/MapDrawer.cc`` — SURVEY.md §2.1); per the build plan (§7.2) the
engine ships offline visualization instead: the landmark cloud (at most
``max_points``, sampled with ``default_rng(0)``) in grey, the trajectory in
red, the keyframes in blue with a 0.4-unit optical-axis tick each, and the
ground truth, aligned by ``eval.ate.align_umeyama`` over the frames tracked
OK that have a ground-truth row (ROADMAP R8), dashed. The view is the
reference's (elevation -75 degrees, azimuth -90), an orthographic projection
of the cube around the content (equal aspect), on the reference's canvas
(matplotlib's 9 x 7 inches at 130 dpi).

The machine with the card has no matplotlib, so this draws with a small
numpy rasterizer (one-pixel points, lines sampled at half a pixel) or
writes SVG text: the content and the view are the reference's, the pixels
are not matplotlib's, and there are no axes, labels or legend (ROADMAP D19).
Pure host-side post-processing — never on the perf path.

CLI: every ``run-*`` subcommand accepts ``--render out.png`` (or ``.svg``).
"""

from __future__ import annotations

import math

import numpy as np

SIZE = (1170, 910)       # width, height: matplotlib's figsize (9, 7) at dpi 130
GREY, RED, BLUE, DARK = (140, 140, 140), (214, 39, 40), (31, 119, 180), (51, 51, 51)
DASH = 6.0               # pixels on, pixels off of the ground truth's line
TICK = 0.4               # optical-axis tick per keyframe, map units


def _layers(engine, gt_positions=None, max_points: int = 20000) -> dict:
    """What the render draws, in map coordinates: ``landmarks`` [N, 3],
    ``trajectory`` [T, 3], ``keyframes`` [K, 3] (camera centres),
    ``ticks`` [K, 2, 3] and ``ground_truth`` [G, 3] (aligned; empty without)."""
    from ..interop import tensor_to_numpy as host

    lv = host(engine.m.lms.valid)
    pts = host(engine.m.lms.xyz)[lv]
    if len(pts) > max_points:
        pts = pts[np.random.default_rng(0).choice(len(pts), max_points, False)]
    kv = host(engine.m.kfs.valid)
    kR, kt = host(engine.m.kfs.R)[kv], host(engine.m.kfs.t)[kv]
    kf_C = np.stack([-R.T @ t for R, t in zip(kR, kt)]) if kv.any() else np.zeros((0, 3))
    ticks = np.stack([np.stack([C, C + TICK * R.T @ np.array([0.0, 0.0, 1.0])]) for R, C in zip(kR, kf_C)]) \
        if len(kf_C) else np.zeros((0, 2, 3))
    traj = engine.positions
    gt = np.zeros((0, 3))
    if gt_positions is not None:
        # a monocular map lives at an arbitrary scale and gauge: align the
        # ground truth into the estimate's frame, as the ATE evaluator does,
        # over the frames tracked OK that have a ground-truth row (R8)
        from .ate import align_umeyama

        g = np.asarray(gt_positions, np.float64)
        if g.shape != traj.shape:
            raise ValueError(f"render_map: ground truth {g.shape} for a trajectory of {traj.shape}")
        ok = np.isfinite(g).all(1) & np.array([r.state == "OK" for r in engine.trajectory], bool)
        if ok.sum() >= 3:
            s, Ra, ta = align_umeyama(g[ok], np.asarray(traj[ok], np.float64))
            gt = (s * (Ra @ g[ok].T)).T + ta
    return {"landmarks": pts, "trajectory": np.asarray(traj), "keyframes": kf_C, "ticks": ticks,
            "ground_truth": gt}


def _view(layers: dict, elev: float = -75.0, azim: float = -90.0, size=SIZE):
    """The projection of the render: a function from points [N, 3] to pixel
    coordinates [N, 2] (x right, y down), orthographic along the direction
    of ``elev`` and ``azim``, scaled so that the cube around the content
    (its centre the mean of the landmarks, trajectory and keyframes, its
    half-side their largest deviation) fits the canvas."""
    content = [p for p in (layers["landmarks"], layers["trajectory"], layers["keyframes"]) if len(p)]
    allp = np.concatenate(content) if content else np.zeros((1, 3))
    c = allp.mean(0)
    r = max(float(np.abs(allp - c).max()), 1e-3)
    e, a = math.radians(elev), math.radians(azim)
    toward = np.array([math.cos(e) * math.cos(a), math.cos(e) * math.sin(a), math.sin(e)])
    right = np.array([-math.sin(a), math.cos(a), 0.0])
    up = np.cross(toward, right)
    W, H = size
    s = 0.48 * min(W, H) / (r * math.sqrt(3.0))

    def project(p):
        d = np.asarray(p, np.float64).reshape(-1, 3) - c
        return np.stack([W / 2 + s * (d @ right), H / 2 - s * (d @ up)], -1)

    return project


def _segments(q: np.ndarray, dash: float = 0.0) -> np.ndarray:
    """Pixels [M, 2] of the polyline through q [N, 2], sampled every half
    pixel; with ``dash`` only the samples in its 'on' stretches."""
    if len(q) < 2:
        return np.round(q).astype(np.int64)
    out, run = [], 0.0
    for a, b in zip(q[:-1], q[1:]):
        n = int(math.ceil(2 * float(np.linalg.norm(b - a)))) + 1
        w = np.linspace(0.0, 1.0, n)[:, None]
        p = a + w * (b - a)
        if dash:
            arc = run + w[:, 0] * float(np.linalg.norm(b - a))
            p = p[(arc % (2 * dash)) < dash]
        run += float(np.linalg.norm(b - a))
        out.append(p)
    return np.round(np.concatenate(out)).astype(np.int64)


def _put(img: np.ndarray, px: np.ndarray, color, r: int = 0) -> None:
    H, W = img.shape[:2]
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            x, y = px[:, 0] + dx, px[:, 1] + dy
            ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            img[y[ok], x[ok]] = color


def _raster(layers, project, size) -> np.ndarray:
    W, H = size
    img = np.full((H, W, 3), 255, np.uint8)
    _put(img, np.round(project(layers["landmarks"])).astype(np.int64), GREY)
    if len(layers["ground_truth"]):
        _put(img, _segments(project(layers["ground_truth"]), DASH), DARK)
    for tick in layers["ticks"]:
        _put(img, _segments(project(tick)), BLUE)
    if len(layers["keyframes"]):
        _put(img, np.round(project(layers["keyframes"])).astype(np.int64), BLUE, r=2)
    _put(img, _segments(project(layers["trajectory"])), RED)
    return img


def _svg(layers, project, size) -> str:
    W, H = size
    rgb = lambda c: f"rgb({c[0]},{c[1]},{c[2]})"  # noqa: E731
    pts = lambda q: " ".join(f"{x:.2f},{y:.2f}" for x, y in q)  # noqa: E731
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" viewBox="0 0 {W} {H}">',
           f'<rect width="{W}" height="{H}" fill="white"/>', f'<g id="landmarks" fill="{rgb(GREY)}">']
    out += [f'<circle cx="{x:.2f}" cy="{y:.2f}" r="0.7"/>' for x, y in project(layers["landmarks"])]
    out.append("</g>")
    if len(layers["ground_truth"]):
        out.append(f'<polyline id="ground_truth" fill="none" stroke="{rgb(DARK)}" stroke-width="0.8" '
                   f'stroke-dasharray="{DASH:g} {DASH:g}" points="{pts(project(layers["ground_truth"]))}"/>')
    out.append(f'<g id="keyframes" stroke="{rgb(BLUE)}" fill="{rgb(BLUE)}" stroke-width="0.5">')
    out += [f'<polyline fill="none" points="{pts(project(t))}"/>' for t in layers["ticks"]]
    out += [f'<rect x="{x - 2:.2f}" y="{y - 2:.2f}" width="4" height="4"/>' for x, y in project(layers["keyframes"])]
    out.append("</g>")
    out.append(f'<polyline id="trajectory" fill="none" stroke="{rgb(RED)}" stroke-width="1.2" '
               f'points="{pts(project(layers["trajectory"]))}"/>')
    out.append("</svg>\n")
    return "\n".join(out)


def render_map(
    engine,
    path: str,
    gt_positions: np.ndarray | None = None,
    max_points: int = 20000,
    elev: float = -75.0,
    azim: float = -90.0,
) -> np.ndarray:
    """Render the engine's map + trajectory to ``path``: a PNG (through
    ``datasets.png.write_png``) unless the suffix is ``.svg``.
    ``gt_positions``: [T, 3], the ground truth of each trajectory frame
    (NaN rows where there is none; ``cli.gt_per_frame``). Returns the
    trajectory's pixel coordinates [T, 2]."""
    layers = _layers(engine, gt_positions, max_points)
    project = _view(layers, elev, azim, SIZE)
    if path.lower().endswith(".svg"):
        with open(path, "w") as f:
            f.write(_svg(layers, project, SIZE))
    else:
        from ..datasets.png import write_png

        write_png(path, _raster(layers, project, SIZE))
    return project(layers["trajectory"])
