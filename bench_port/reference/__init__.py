"""The plain reference that decides a run's ``correct``.

Plain PyTorch, run after the window has closed. It imports nothing of the
program: each stage works out again, from the benchmark's own inputs (the
rendered images) or from the program's state at the call (poses, points,
observations), what the program's timed path produced there.

Every stage takes a precision: ``"f64"`` is the reference; ``"f32"`` the same
arithmetic in float32; ``"tf32"`` the control, float32 with the operands of
every matrix product rounded to TF32's 10-bit mantissa, as cuBLAS computes
with ``allow_tf32`` on.
"""
