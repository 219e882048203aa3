"""State carried across from the reference package, through numpy.

The reference's ``FrameArrays`` and ``MapState`` reach this module as what
``jax.device_get`` returns: NamedTuples (or plain dicts) of numpy arrays.
``frame_from_numpy`` / ``map_from_numpy`` / ``problem_from_numpy`` turn them
(and a local-BA ``BAProblem``) into the port's tensors on a given device, so
both engines can compute from the same map; stereo fields (the keyframe
store's ``u_right``/``depth``, a problem's ``obs_ur``) travel like any other;
``vocab_from_numpy`` does the same for a ``Vocabulary`` (words, idf and the
two-level tables), so both packages quantize with one codebook;
``map_to_numpy`` goes the other way, as nested dicts of numpy arrays keyed by
the reference's field names. Descriptor words travel as the reference's
``uint32`` and live in the port as ``int32`` bit-casts.

This module imports no JAX; callers do the JAX <-> numpy step.
"""

from __future__ import annotations

import numpy as np
import torch

from .containers import FrameArrays, KeyframeStore, LandmarkStore, MapState
from .optim.local_ba import BAProblem
from .vocab import Vocabulary


def numpy_to_tensor(a, dtype=None, device="cuda") -> torch.Tensor:
    """numpy array -> tensor; uint32 words become their int32 bit-cast."""
    a = np.array(a, order="C")       # a fresh C-ordered copy; keeps 0-d shapes
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def tensor_to_numpy(x: torch.Tensor, name: str = "") -> np.ndarray:
    """tensor -> numpy; a descriptor field (name ending in 'desc') becomes uint32."""
    a = x.detach().cpu().numpy()
    if name.endswith("desc"):
        a = a.astype(np.int32).view(np.uint32)
    return a


def _get(src, key):
    return src[key] if isinstance(src, dict) else getattr(src, key)


def _tuple_from_numpy(cls, src, device):
    return cls(**{f: numpy_to_tensor(_get(src, f), device=device) for f in cls._fields})


def frame_from_numpy(frame, device="cuda") -> FrameArrays:
    """Reference FrameArrays (numpy leaves) -> port FrameArrays on ``device``."""
    return _tuple_from_numpy(FrameArrays, frame, device)


def map_from_numpy(m, device="cuda") -> MapState:
    """Reference MapState (numpy leaves) -> port MapState on ``device``."""
    return MapState(
        kfs=_tuple_from_numpy(KeyframeStore, _get(m, "kfs"), device),
        lms=_tuple_from_numpy(LandmarkStore, _get(m, "lms"), device),
        covis=numpy_to_tensor(_get(m, "covis"), device=device),
        num_kfs=numpy_to_tensor(_get(m, "num_kfs"), device=device),
        num_lms=numpy_to_tensor(_get(m, "num_lms"), device=device),
        lm_dropped=numpy_to_tensor(_get(m, "lm_dropped"), device=device),
    )


def problem_from_numpy(prob, device="cuda") -> BAProblem:
    """Reference BAProblem (numpy leaves) -> port BAProblem on ``device``;
    an absent ``obs_ur`` (mono problem) or ``lm_opt`` stays None."""
    return BAProblem(**{f: None if _get(prob, f) is None else numpy_to_tensor(_get(prob, f), device=device)
                        for f in BAProblem._fields})


def vocab_from_numpy(vocab, device="cuda") -> Vocabulary:
    """Reference Vocabulary (numpy leaves) -> port Vocabulary on ``device``;
    the two-level tables stay None on a flat codebook."""
    return Vocabulary(**{f: None if _get(vocab, f) is None else numpy_to_tensor(_get(vocab, f), device=device)
                         for f in Vocabulary._fields})


def _tuple_to_numpy(t) -> dict:
    return {f: tensor_to_numpy(getattr(t, f), f) for f in t._fields}


def map_to_numpy(m: MapState) -> dict:
    """Port MapState -> nested dict of numpy arrays (reference field names)."""
    return {
        "kfs": _tuple_to_numpy(m.kfs),
        "lms": _tuple_to_numpy(m.lms),
        "covis": tensor_to_numpy(m.covis),
        "num_kfs": tensor_to_numpy(m.num_kfs),
        "num_lms": tensor_to_numpy(m.num_lms),
        "lm_dropped": tensor_to_numpy(m.lm_dropped),
    }
