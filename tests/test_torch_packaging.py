"""The port's native sources ship whole: every CUDA source and header
and the host decoder core (``kltdecode.cc``) in
``kaldi_lstm_tpu_torch/csrc/``, and every file that one of them includes
with ``#include "..."``, exists there and matches a glob of the
package's data in ``pyproject.toml``, so a built wheel can compile every
kernel and the decoder core (nvcc and g++ run at first use, from the
installed package)."""

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
                  if f.endswith((".cu", ".cuh", ".h", ".cc")))


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


def _reaches(name: str) -> set[str]:
    """Every local header that csrc/<name> includes, directly or through
    another header."""
    seen, todo = set(), list(_includes(name))
    while todo:
        inc = todo.pop()
        if inc not in seen:
            seen.add(inc)
            todo.extend(_includes(inc))
    return seen


def test_the_tensor_core_header_is_included_and_shipped():
    """tc_gemm.cuh is the header that a wheel once left out. K1/K2 and K6
    reach it through lstmp_tc.cuh (K1's tiles), K3/K4 directly."""
    users = [n for n in _sources() if "tc_gemm.cuh" in _reaches(n)]
    assert {"lstmp_train.cu", "xent_affine.cu", "lstmp_stack.cu"} <= \
        set(users)
    assert "tc_gemm.cuh" in _includes("lstmp_tc.cuh")
    assert "csrc/*.cuh" in _package_data()


def test_the_decoder_core_is_shipped_and_built_from_it():
    """io/native.py builds csrc/kltdecode.cc, which ships as package
    data."""
    from kaldi_lstm_tpu_torch.io import native
    assert native.SOURCE == os.path.join(CSRC, "kltdecode.cc")
    assert "kltdecode.cc" in _sources()
    assert "csrc/*.cc" in _package_data()


def _port_scripts() -> dict[str, str]:
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: v for k, v in scripts.items()
            if v.startswith("kaldi_lstm_tpu_torch.")}


def test_the_streaming_tools_have_console_scripts():
    scripts = _port_scripts()
    for tool in ("online_decode", "online_serve_batch",
                 "online_serve_sticky"):
        name = "klt-torch-" + tool.replace("_", "-")
        assert scripts[name] == f"kaldi_lstm_tpu_torch.tools.{tool}:main"


_ALIGN_LATTICE_TOOLS = (
    "align_mapped", "ali_to_pdf", "decode_viterbi", "lattice_best_path",
    "lattice_copy", "lattice_determinize", "lattice_oracle", "lattice_prune",
    "lattice_lmrescore", "lattice_to_post", "lattice_mbr_decode",
    "lattice_to_ctm")


@pytest.mark.parametrize("tool", _ALIGN_LATTICE_TOOLS)
def test_the_alignment_and_lattice_tools_have_console_scripts(tool):
    """Each alignment, Viterbi and lattice tool that the JAX package
    ships as `klt-<tool>` has its `klt-torch-<tool>` twin."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    name = tool.replace("_", "-")
    assert scripts[f"klt-{name}"] == f"kaldi_lstm_tpu.tools.{tool}:main"
    assert scripts[f"klt-torch-{name}"] == \
        f"kaldi_lstm_tpu_torch.tools.{tool}:main"


_MODEL_TOOLS = ("nnet_train_perutt", "nnet_initialize", "nnet_copy",
                "nnet_concat", "nnet_edit", "nnet_info", "cmvn_to_nnet",
                "run_recipe")


@pytest.mark.parametrize("tool", _MODEL_TOOLS)
def test_the_model_and_trainer_tools_have_console_scripts(tool):
    """Each per-utterance trainer and model tool that the JAX package
    ships as `klt-<tool>` has its `klt-torch-<tool>` twin, naming a
    `main`; the frame-shuffled trainer has no JAX script, so no twin."""
    import importlib
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    name = tool.replace("_", "-")
    assert scripts[f"klt-{name}"] == f"kaldi_lstm_tpu.tools.{tool}:main"
    target = f"kaldi_lstm_tpu_torch.tools.{tool}:main"
    assert scripts[f"klt-torch-{name}"] == target
    assert callable(importlib.import_module(target.split(":")[0]).main)
    assert "klt-torch-nnet-train-frmshuff" not in scripts


_SEQUENCE_TOOLS = ("nnet_train_mmi", "nnet_train_smbr", "ali_to_post",
                   "compute_class_counts", "analyze_counts", "scale_post",
                   "sum_post", "copy_int_vector")


@pytest.mark.parametrize("tool", _SEQUENCE_TOOLS)
def test_the_sequence_and_posterior_tools_have_console_scripts(tool):
    """Each sequence trainer and posterior/count tool that the JAX
    package ships as `klt-<tool>` has its `klt-torch-<tool>` twin; the
    lattice-based trainers, post_to_weights and weight_silence_post have
    no JAX script, so no twin."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    name = tool.replace("_", "-")
    assert scripts[f"klt-{name}"] == f"kaldi_lstm_tpu.tools.{tool}:main"
    assert scripts[f"klt-torch-{name}"] == \
        f"kaldi_lstm_tpu_torch.tools.{tool}:main"
    for other in ("nnet-train-mmi-sequential", "nnet-train-mpe-sequential",
                  "post-to-weights", "weight-silence-post"):
        assert f"klt-{other}" not in scripts
        assert f"klt-torch-{other}" not in scripts


@pytest.mark.parametrize("name", sorted(_port_scripts()))
def test_every_port_console_script_names_a_main(name):
    import importlib
    module, func = _port_scripts()[name].split(":")
    assert callable(getattr(importlib.import_module(module), func))
