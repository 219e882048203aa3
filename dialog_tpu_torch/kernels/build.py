"""Build the CUDA sources on first use and load them with ctypes.

Each ``dialog_tpu_torch/csrc/<name>.cu`` compiles with nvcc into a shared
library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/dialog_tpu_torch/lib<name>_<hash>.so

under ``build/`` at the checkout's root (listed in .gitignore). The file name
carries a hash of the sources and flags, so an edited kernel rebuilds; a file
lock keeps concurrent processes from building the same library twice. Every
pointer and the stream cross the boundary as ``c_void_p``; ``SIGNATURES``
holds the entry points' types, set once when a library is loaded.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "dialog_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library -> entry point -> (result type, argument types)
SIGNATURES: dict[str, dict[str, tuple]] = {
    "fast": {
        "fast_levels_launch": (_I, [_P, _P, _P, _I, _F, _F, _I, _P]),
        "fast_levels_batch_launch": (_I, [_P, _P, _P, _I, _I, _F, _F, _I, _P]),
    },
    "hamming": {
        "hamming_best2_launch": (_I, [_P] * 10 + [_I] * 3 + [_P] * 4),
        "hamming_mutual_launch": (_I, [_P] * 9 + [_I] * 4 + [_F] + [_P] * 6),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}   # name -> nvcc wall time (0.0 = cached)
build_log: dict[str, str] = {}         # name -> nvcc/ptxas output


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, compiling it if needed."""
    if name in _libs:
        return _libs[name]
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}_{_digest(src)}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            build_seconds.setdefault(name, 0.0)
        else:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds[name] = time.perf_counter() - t0
            build_log[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src.name}:\n{build_log[name]}")
            os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in SIGNATURES.get(name, {}).items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _libs[name] = lib
    return lib


def load_all() -> dict[str, ctypes.CDLL]:
    """Build and load every kernel source under csrc/, one nvcc per source,
    all started together."""
    names = [p.stem for p in sorted(CSRC.glob("*.cu"))]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load, names)))
