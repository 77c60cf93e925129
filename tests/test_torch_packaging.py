"""The port's CUDA sources ship whole: every file that a source in
``kaldi_lstm_tpu_torch/csrc/`` includes with ``#include "..."`` exists
beside it and matches a glob of the package's data in
``pyproject.toml``, so a built wheel can compile every kernel (nvcc runs
at first use, from the installed package)."""

import fnmatch
import os
import re
import tomllib

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "kaldi_lstm_tpu_torch", "csrc")


def _package_data() -> list[str]:
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        cfg = tomllib.load(f)
    return cfg["tool"]["setuptools"]["package-data"]["kaldi_lstm_tpu_torch"]


def _sources() -> list[str]:
    return sorted(f for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh", ".h")))


def _includes(name: str) -> list[str]:
    with open(os.path.join(CSRC, name)) as f:
        return re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), re.M)


@pytest.mark.parametrize("name", _sources())
def test_every_csrc_file_is_package_data(name):
    assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in _package_data())


@pytest.mark.parametrize("name", _sources())
def test_every_local_include_ships(name):
    globs = _package_data()
    for inc in _includes(name):
        assert os.path.isfile(os.path.join(CSRC, inc)), (name, inc)
        assert any(fnmatch.fnmatch(f"csrc/{inc}", g) for g in globs), \
            (name, inc, globs)


def test_the_tensor_core_header_is_included_and_shipped():
    """tc_gemm.cuh is the header that a wheel once left out."""
    users = [n for n in _sources() if "tc_gemm.cuh" in _includes(n)]
    assert {"lstmp_train.cu", "xent_affine.cu"} <= set(users)
    assert "csrc/*.cuh" in _package_data()
