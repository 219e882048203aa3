"""Host-side C++ helpers, built with g++ at first use and loaded with ctypes.

* ``voc_parser.cpp``: the DBoW2 text-vocabulary parser behind
  ``vocab.load_dbow2_text`` (the port's copy of the reference's parser);
* ``png.cpp``: the PNG row unfilter behind ``datasets.png`` (Average and
  Paeth depend on the byte just decoded, so numpy cannot take a row at once).

Each builds with ``g++ -O3 -shared -fPIC`` into ``build/dialog_tpu_torch/``
through ``kernels.build.build_library`` (a hash of the source in the file
name, a file lock against concurrent builds). A failed build raises with the
compiler's output: there is no fallback. The plain Python versions stay
beside them as the tests' references (``vocab.parse_dbow2_text_plain``,
``datasets.png.unfilter_plain``).
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

_DIR = Path(__file__).resolve().parent
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


class VocHeader(ctypes.Structure):
    _fields_ = [
        ("k", ctypes.c_int32),
        ("levels", ctypes.c_int32),
        ("scoring", ctypes.c_int32),
        ("weighting", ctypes.c_int32),
        ("n_nodes", ctypes.c_int64),
    ]


# library -> entry point -> (result type, argument types)
SIGNATURES: dict[str, dict[str, tuple]] = {
    "voc_parser": {
        "voc_scan": (_I, [ctypes.c_char_p, _I64, ctypes.POINTER(VocHeader)]),
        "voc_parse": (_I, [ctypes.c_char_p, _I64, _I64, _P, _P, _P, _P]),
    },
    "png": {"png_unfilter": (_I, [_P, _I64, _I64, ctypes.c_int32, _P])},
}

_libs: dict[str, ctypes.CDLL] = {}


def gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the port's native helpers build with the host's C++ compiler")
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, compiling it if needed."""
    if name in _libs:
        return _libs[name]
    from ..kernels.build import build_library

    out = build_library(f"native_{name}", _DIR / f"{name}.cpp", [gxx(), *GXX_FLAGS])
    lib = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _libs[name] = lib
    return lib
