"""Kernel A's share of its roofline: the least time of the traced window's kernel A work
(``bench_port.roofline.fast_work`` over the pyramids it was given) over the device time of
its launches, by the kernel's name in ``csrc/fast.cu``. A change that renames or fuses the
kernel points ``KERNELS`` at what took its place."""

from bench_port.roofline import fast_work, least_seconds
from bench_port.trace import kernel_ns

KERNELS = ("fast_levels_kernel",)


def read(t):
    n, ns = kernel_ns(t, KERNELS)
    if n == 0 or not t.shapes.get("fast"):
        return None
    least = sum(least_seconds(*fast_work(levels))[0] for levels in t.shapes["fast"])
    return 100.0 * least / (ns * 1e-9)
