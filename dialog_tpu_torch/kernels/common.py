"""Device dispatch, launch counters and ctypes plumbing shared by the kernels.

The dispatch rule is the tensor's device and nothing else: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the hand-written kernel, and
any other device raises. No environment variable switches the path and no
``try`` falls back.
"""

from __future__ import annotations

import ctypes

import torch

# kernel name -> number of launches since the last reset; a wrapper adds one
# exactly where it launches its kernel and nowhere else
# (kernel C's stereo variant counts apart from its mono variant; one mutual
# match of kernel B counts once as hamming_mutual, whatever it launches;
# kernel A over a batch of images counts apart from kernel A over one image;
# kernel C with frozen landmarks counts as schur_reduce_frozen, in either variant;
# the pose LM's stereo form counts apart from its mono form; a projection search's
# glue counts once as project_gate and once as invert_matches, in any form)
launches: dict[str, int] = {"fast_nms_rank": 0, "fast_nms_rank_batch": 0, "hamming_best2": 0, "hamming_mutual": 0,
                            "schur_reduce": 0, "schur_reduce_stereo": 0, "schur_reduce_frozen": 0,
                            "pose_lm": 0, "pose_lm_stereo": 0, "project_gate": 0, "invert_matches": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def route(x: torch.Tensor) -> str:
    """'cpu' or 'cuda' for the tensor's device; raises on anything else."""
    if x.device.type == "cpu":
        return "cpu"
    if x.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel path for tensors on {x.device}")


def require(x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless ``x`` has the dtype, shape and device a kernel takes."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
