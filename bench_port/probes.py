"""The harness's wrappers around the port's layer entry points.

Installed from here during set-up, removed at the end: each wrapper opens a
``torch.profiler.record_function`` range named ``bench::<layer>`` (only in a
traced run) and, for the entries whose answers the reference checks, offers
the call's inputs and outputs to a seeded reservoir sample. No wrapper reads
a device value or synchronises: the window's work is the program's own.
"""

from __future__ import annotations

import contextlib
import random


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered, drawn from ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def wants(self) -> int | None:
        """The slot the next item goes to, or None: decide before building the item."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        self.items[slot] = item


class Probes:
    """Wrappers over the port's modules, the samples they take, and the shapes they record."""

    def __init__(self, seed: int, samples: dict, traced: bool):
        rng = random.Random(seed)
        self.samples = {k: Reservoir(n, random.Random(rng.random())) for k, n in samples.items()}
        self.traced = traced
        self.shapes = {"fast": [], "hamming": [], "schur": []}
        self.recording = False   # shapes are recorded while the profiler is on
        self._saved = []
        self.last = {}

    def _range(self, layer: str):
        if not self.traced:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function("bench::" + layer)

    def _wrap(self, owner, attr: str, layer: str, after=None, before=None):
        fn = getattr(owner, attr)
        probes = self

        def wrapper(*args, **kwargs):
            if before is not None:
                before(args, kwargs)
            with probes._range(layer):
                out = fn(*args, **kwargs)
            if after is not None:
                after(args, kwargs, out)
            return out

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, wrapper)

    def install(self) -> None:
        from dialog_tpu_torch import frontend, matching, stereo, system, tracking
        from dialog_tpu_torch.kernels import schur as schur_kernel

        self._wrap(frontend, "extract_features_batch", "frontend")
        self._wrap(system, "extract_features", "frontend", after=self._keep_last("frontend"))
        self._wrap(stereo, "stereo_match_frames", "stereo")
        self._wrap(system, "stereo_match_frames", "stereo", after=self._keep_last("stereo"))
        self._wrap(tracking, "fused_track_multi", "track_multi")
        self._wrap(tracking, "fused_track_step", "track_step")
        self._wrap(system.Engine, "_insert_keyframe", "keyframe")
        self._wrap(tracking, "pose_optimization", "pose", after=self._take("pose"))
        self._wrap(matching, "mutual_match_fused", "match", after=self._take("match", "hamming"))
        self._wrap(schur_kernel, "schur_reduce", "schur", after=self._take("schur", "schur"))
        for name in ("fast_nms_rank_levels", "fast_nms_rank_levels_batch"):
            self._wrap(frontend, name, "fast", before=self._fast_shapes)

    def remove(self) -> None:
        while self._saved:
            owner, attr, fn = self._saved.pop()
            setattr(owner, attr, fn)

    def _keep_last(self, key):
        def after(args, kwargs, out):
            self.last[key] = out
        return after

    def _take(self, sample: str, shapes: str | None = None):
        def after(args, kwargs, out):
            if shapes is not None and self.recording:
                self.shapes[shapes].append(_work_shape(shapes, args, kwargs))
            res = self.samples.get(sample)
            if res is None:
                return
            slot = res.wants()
            if slot is not None:
                res.put(slot, (args, kwargs, out))
        return after

    def _fast_shapes(self, args, kwargs):
        if self.recording:
            self.shapes["fast"].append([tuple(x.shape) for x in args[0]])


def _work_shape(kernel: str, args, kwargs):
    """What a roofline needs of one call: kernel B's row and column counts;
    kernel C's cameras and the observation tensors (their live slots are
    counted after the window, so nothing is read back inside it)."""
    if kernel == "hamming":
        return args[0].shape[0], args[1].shape[0]
    return {"C": args[0].shape[0], "obs_cam": args[4], "obs_w": args[6],
            "stereo": kwargs.get("obs_ur") is not None and kwargs.get("bf", 0.0) > 0}
