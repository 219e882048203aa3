"""dialog_tpu_torch: the PyTorch + CUDA port of the dialog_tpu SLAM engine.

The JAX package ``dialog_tpu`` is the reference; this package mirrors its
module layout and public function names, keeps its tensor layouts and dtypes
at public functions (descriptors are ``int32`` bit-casts of the reference's
``uint32`` words), and replaces each Pallas kernel with a hand-written CUDA
kernel for Hopper (``kernels/`` + ``csrc/``). Nothing here imports JAX.
"""

__version__ = "0.1.0"

import torch as _torch

# Pose math needs exact f32 products: reduced-precision (TF32) matmuls drift
# rotation chains off SO(3) and starve BA of curvature, the same reason the
# reference pins "highest" matmul precision on the TPU.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import EngineConfig, Sensor  # noqa: E402,F401
from .containers import FrameArrays, KeyframeStore, LandmarkStore, MapState  # noqa: E402,F401
