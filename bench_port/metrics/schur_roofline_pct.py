"""Kernel C's share of its roofline: the least time of the traced window's reductions
(``bench_port.roofline.schur_work`` of each call's live observations, landmarks and camera
pairs) over the device time of its launches, by the kernels' names in ``csrc/schur.cu``. A
change that renames or fuses them points ``KERNELS`` at what took their place. Absent where
no local BA ran in the traced window."""

from bench_port.roofline import least_seconds, schur_work
from bench_port.trace import kernel_ns

KERNELS = ("schur_obs", "schur_cams")


def read(t):
    n, ns = kernel_ns(t, KERNELS)
    if n == 0 or not t.shapes.get("schur"):
        return None
    least = sum(least_seconds(*schur_work(**w))[0] for w in t.shapes["schur"])
    return 100.0 * least / (ns * 1e-9)
