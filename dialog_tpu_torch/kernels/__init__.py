"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``fast`` (FAST-9 + NMS + rank), ``hamming`` (gated best/second-best Hamming
matching) and ``schur`` (fused BA Jacobian + Schur reduction) replace the
reference's three Pallas kernels; ``pose`` (the pose LM in one launch) and
``project`` (a projection search's glue around kernel B: ``project_gate``
before it, ``invert_matches`` after it, one launch each) replace none. A
wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.
"""
