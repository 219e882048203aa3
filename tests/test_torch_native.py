"""The port's native DBoW2 text parser against the reference's loader and the
port's numpy parse.

Tolerance: exact. On a small vocabulary file the test writes (inner nodes and
leaves, weights in fixed and exponent notation, LF or CRLF line ends and tabs),
``load_dbow2_text`` through the native parser (built with g++ at first use)
gives the reference's words (compared as u32 views) and idf, bit for bit,
and the native parse equals ``parse_dbow2_text_plain`` in every node. A
failed build raises with the compiler's output.
"""

import numpy as np
import pytest
import torch

from dialog_tpu import vocab as jv
from dialog_tpu_torch import native
from dialog_tpu_torch import vocab as tv
from dialog_tpu_torch.kernels import build

torch.set_num_threads(2)


def _write_voc(path, k=4, seed=0, sep=" ", eol="\n"):
    """k inner nodes under the root, k*k leaves under them."""
    rng = np.random.default_rng(seed)
    lines = [f"{k} 2 0 0"]
    for _ in range(k):
        lines.append(sep.join(["0", "0", *map(str, rng.integers(0, 256, 32)), "0"]))
    for i in range(k * k):
        w = rng.uniform(0.01, 3.0)
        ws = f"{w:.6f}" if i % 2 else f"{w:.9e}"
        lines.append(sep.join([str(1 + i // k), "1", *map(str, rng.integers(0, 256, 32)), ws]))
    path.write_bytes((eol.join(lines) + eol).encode())


CASES = {"lf": (0, " ", "\n", None), "crlf-tabs": (1, "\t", "\r\n", None), "max-words": (2, " ", "\n", 7)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_load_equals_the_reference_and_the_numpy_parse(tmp_path, case):
    seed, sep, eol, max_words = CASES[case]
    p = tmp_path / "voc.txt"
    _write_voc(p, seed=seed, sep=sep, eol=eol)
    ref = jv.load_dbow2_text(str(p), max_words=max_words)
    port = tv.load_dbow2_text(str(p), max_words=max_words, device="cpu")
    np.testing.assert_array_equal(port.words.numpy().view(np.uint32), np.asarray(ref.words))
    assert port.idf.dtype == torch.float32
    np.testing.assert_array_equal(port.idf.numpy(), np.asarray(ref.idf))
    buf = p.read_bytes()
    for got, want in zip(tv.parse_dbow2_text(buf), tv.parse_dbow2_text_plain(buf)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_native_parser_rejects_garbage(tmp_path):
    with pytest.raises(ValueError):
        tv.parse_dbow2_text(b"this is not a vocabulary\n")
    with pytest.raises(ValueError):   # a node cut short: fields not a multiple of 35
        tv.parse_dbow2_text(b"2 1 0 0\n0 1 " + b"5 " * 20 + b"\n")


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(native.SIGNATURES, "broken", {})
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.load("broken")


@pytest.mark.parametrize("folder", ["csrc", "native"])
def test_package_data_holds_every_source_the_build_compiles(folder):
    """An installed wheel builds the kernels and the native helpers from its own package data: every non-Python
    file under csrc/ and native/ (what nvcc and g++ compile, and the headers they include) matches a glob."""
    import fnmatch
    import pathlib
    import tomllib

    root = pathlib.Path(__file__).resolve().parent.parent
    globs = tomllib.loads((root / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"]
    pkg = root / "dialog_tpu_torch"
    sources = [p.relative_to(pkg).as_posix() for p in sorted((pkg / folder).iterdir())
               if p.is_file() and p.suffix != ".py"]
    assert sources
    missing = [f for f in sources if not any(fnmatch.fnmatch(f, g) for g in globs["dialog_tpu_torch"])]
    assert not missing, missing
