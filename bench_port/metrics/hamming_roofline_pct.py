"""Kernel B's share of its roofline: the least time of the traced window's gated mutual
matches (``bench_port.roofline.hamming_work`` of each call's rows and columns) over the
device time of its launches, by the kernels' names in ``csrc/hamming.cu``. A change that
renames or fuses them points ``KERNELS`` at what took their place."""

from bench_port.roofline import hamming_work, least_seconds
from bench_port.trace import kernel_ns

KERNELS = ("hamming_scan_kernel", "hamming_mutual_kernel")


def read(t):
    n, ns = kernel_ns(t, KERNELS)
    if n == 0 or not t.shapes.get("hamming"):
        return None
    least = sum(least_seconds(*hamming_work(*nm))[0] for nm in t.shapes["hamming"])
    return 100.0 * least / (ns * 1e-9)
