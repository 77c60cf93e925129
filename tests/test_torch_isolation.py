"""The port stands alone and never moves to the CPU on its own:

* importing every module of `kaldi_lstm_tpu_torch` (the training slice
  among them) loads neither `jax` nor the JAX package (checked in a
  fresh interpreter; the debug-dump modules also each alone), and no
  `import` statement anywhere in the port's sources or `chip_smoke.py`
  names either, not even one inside a function body;
* `lstm_infer` on a CPU tensor takes the plain version and counts no
  kernel launch;
* `--device cuda` without CUDA exits 1 and writes nothing;
* on a card, the CUDA kernel matches the plain version (marked `gpu`;
  skips where there is no card, with the reason).
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import kaldi_lstm_tpu_torch.ops.lstm_infer as li
from kaldi_lstm_tpu_torch.ops.lstm_cell import (
    LstmState,
    init_lstm_params,
    lstm_scan,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import pkgutil, sys
import kaldi_lstm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    __import__(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "kaldi_lstm_tpu" or m.startswith("kaldi_lstm_tpu."))
print(len(names), bad)
assert not bad, bad
print(" ".join(names))
"""

_TRAIN_MODULES = {
    "kaldi_lstm_tpu_torch.ops.lstm_train",
    "kaldi_lstm_tpu_torch.ops.xent_affine",
    "kaldi_lstm_tpu_torch.train.loss",
    "kaldi_lstm_tpu_torch.train.optim",
    "kaldi_lstm_tpu_torch.train.streams",
    "kaldi_lstm_tpu_torch.train.trainer",
    "kaldi_lstm_tpu_torch.train.checkpoint",
    "kaldi_lstm_tpu_torch.tools.train_lstm_streams",
    "kaldi_lstm_tpu_torch.utils.tree",
}

_STACK_MODULES = {
    "kaldi_lstm_tpu_torch.ops.lstm_stack",
    "kaldi_lstm_tpu_torch.tools.bench_wavefront",
    "kaldi_lstm_tpu_torch.tools.nnet_concat",
    "kaldi_lstm_tpu_torch.tools.nnet_edit",
    "kaldi_lstm_tpu_torch.tools.nnet_info",
    "kaldi_lstm_tpu_torch.tools.run_recipe",
}


_MONITOR_MODULES = {
    "kaldi_lstm_tpu_torch.ops.lstm_grad_variants",
    "kaldi_lstm_tpu_torch.tools.nnet_debug_dump",
}

_DECODE_MODULES = {
    "kaldi_lstm_tpu_torch.io.arpa",
    "kaldi_lstm_tpu_torch.io.lang",
    "kaldi_lstm_tpu_torch.io.lattice",
    "kaldi_lstm_tpu_torch.io.native",
    "kaldi_lstm_tpu_torch.io.transition_model",
    "kaldi_lstm_tpu_torch.decode.determinize",
    "kaldi_lstm_tpu_torch.decode.faster",
    "kaldi_lstm_tpu_torch.decode.graph",
    "kaldi_lstm_tpu_torch.decode.lattice_faster",
    "kaldi_lstm_tpu_torch.decode.wer",
    "kaldi_lstm_tpu_torch.tools.compute_wer",
    "kaldi_lstm_tpu_torch.tools.decode_faster",
    "kaldi_lstm_tpu_torch.tools.latgen_faster",
    "kaldi_lstm_tpu_torch.tools.make_word_synth_data",
    "kaldi_lstm_tpu_torch.tools.nnet_decode",
}

_STREAM_MODULES = {
    "kaldi_lstm_tpu_torch.decode.online",
    "kaldi_lstm_tpu_torch.decode.serve",
    "kaldi_lstm_tpu_torch.tools.online_decode",
    "kaldi_lstm_tpu_torch.tools.online_serve_batch",
    "kaldi_lstm_tpu_torch.tools.online_serve_sticky",
}

_ALIGN_MODULES = {
    "kaldi_lstm_tpu_torch.decode.align",
    "kaldi_lstm_tpu_torch.decode.mbr",
    "kaldi_lstm_tpu_torch.decode.viterbi",
    "kaldi_lstm_tpu_torch.tools.ali_to_pdf",
    "kaldi_lstm_tpu_torch.tools.ali_to_phones",
    "kaldi_lstm_tpu_torch.tools.align_mapped",
    "kaldi_lstm_tpu_torch.tools.decode_viterbi",
    "kaldi_lstm_tpu_torch.tools.lattice_best_path",
    "kaldi_lstm_tpu_torch.tools.lattice_copy",
    "kaldi_lstm_tpu_torch.tools.lattice_determinize",
    "kaldi_lstm_tpu_torch.tools.lattice_lmrescore",
    "kaldi_lstm_tpu_torch.tools.lattice_mbr_decode",
    "kaldi_lstm_tpu_torch.tools.lattice_oracle",
    "kaldi_lstm_tpu_torch.tools.lattice_prune",
    "kaldi_lstm_tpu_torch.tools.lattice_to_ctm",
    "kaldi_lstm_tpu_torch.tools.lattice_to_post",
    "kaldi_lstm_tpu_torch.tools.nnet_align",
}

_PERUTT_MODULES = {
    "kaldi_lstm_tpu_torch.train.randomizer",
    "kaldi_lstm_tpu_torch.utils.timer",
    "kaldi_lstm_tpu_torch.tools.cmvn_to_nnet",
    "kaldi_lstm_tpu_torch.tools.nnet_train_frmshuff",
    "kaldi_lstm_tpu_torch.tools.nnet_train_perutt",
}

_SEQUENCE_MODULES = {
    "kaldi_lstm_tpu_torch.train.sequence",
    "kaldi_lstm_tpu_torch.train.sequence_lattice",
    "kaldi_lstm_tpu_torch.tools.nnet_train_mmi",
    "kaldi_lstm_tpu_torch.tools.nnet_train_mmi_sequential",
    "kaldi_lstm_tpu_torch.tools.nnet_train_mpe_sequential",
    "kaldi_lstm_tpu_torch.tools.nnet_train_smbr",
    "kaldi_lstm_tpu_torch.tools.ali_to_post",
    "kaldi_lstm_tpu_torch.tools.analyze_counts",
    "kaldi_lstm_tpu_torch.tools.compute_class_counts",
    "kaldi_lstm_tpu_torch.tools.copy_int_vector",
    "kaldi_lstm_tpu_torch.tools.post_to_weights",
    "kaldi_lstm_tpu_torch.tools.scale_post",
    "kaldi_lstm_tpu_torch.tools.sum_post",
    "kaldi_lstm_tpu_torch.tools.weight_silence_post",
}

_FEATS_MODULES = {
    "kaldi_lstm_tpu_torch.feats",
    "kaldi_lstm_tpu_torch.feats.fbank",
    "kaldi_lstm_tpu_torch.io.wav",
    "kaldi_lstm_tpu_torch.tools.add_deltas",
    "kaldi_lstm_tpu_torch.tools.apply_cmvn",
    "kaldi_lstm_tpu_torch.tools.compute_cmvn_stats",
    "kaldi_lstm_tpu_torch.tools.compute_cmvn_transform",
    "kaldi_lstm_tpu_torch.tools.compute_fbank_feats",
    "kaldi_lstm_tpu_torch.tools.compute_mfcc_feats",
    "kaldi_lstm_tpu_torch.tools.copy_feats",
    "kaldi_lstm_tpu_torch.tools.extract_segments",
    "kaldi_lstm_tpu_torch.tools.feat_to_dim",
    "kaldi_lstm_tpu_torch.tools.feat_to_len",
    "kaldi_lstm_tpu_torch.tools.make_hmm_synth_data",
    "kaldi_lstm_tpu_torch.tools.make_synth_data",
    "kaldi_lstm_tpu_torch.tools.paste_feats",
    "kaldi_lstm_tpu_torch.tools.select_feats",
    "kaldi_lstm_tpu_torch.tools.splice_feats",
    "kaldi_lstm_tpu_torch.tools.subset_feats",
    "kaldi_lstm_tpu_torch.tools.synth_wavs",
    "kaldi_lstm_tpu_torch.tools.wav_to_duration",
}

_PARALLEL_MODULES = {
    "kaldi_lstm_tpu_torch.io.native",
    "kaldi_lstm_tpu_torch.parallel",
    "kaldi_lstm_tpu_torch.parallel.mesh",
    "kaldi_lstm_tpu_torch.parallel.multihost",
    "kaldi_lstm_tpu_torch.parallel.sharded_trainer",
    "kaldi_lstm_tpu_torch.parallel.xent_tp",
}


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 30
    names = set(res.stdout.splitlines()[1].split())
    assert _TRAIN_MODULES <= names and _STACK_MODULES <= names
    assert _MONITOR_MODULES <= names and _DECODE_MODULES <= names
    assert _STREAM_MODULES <= names and _ALIGN_MODULES <= names
    assert _PERUTT_MODULES <= names and _SEQUENCE_MODULES <= names
    assert _FEATS_MODULES <= names and _PARALLEL_MODULES <= names


@pytest.mark.parametrize("module", sorted(_MONITOR_MODULES
                                          | _DECODE_MODULES
                                          | _STREAM_MODULES
                                          | _ALIGN_MODULES
                                          | _PERUTT_MODULES
                                          | _SEQUENCE_MODULES
                                          | _FEATS_MODULES
                                          | _PARALLEL_MODULES))
def test_monitor_modules_import_no_jax(module):
    """Each of the debug-dump, decode, streaming, alignment, lattice,
    per-utterance/frame-shuffled training, sequence training,
    posterior/count and front-end modules alone, in a fresh interpreter,
    loads neither jax nor the JAX package."""
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'kaldi_lstm_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def imported_names(path: str) -> set:
    """Every module an `import` or `from ... import` statement of the file
    names, at any depth (function bodies included)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def jax_names(names: set) -> list:
    return sorted(n for n in names if n.split(".")[0] in
                  ("jax", "kaldi_lstm_tpu"))


def test_chip_smoke_imports_no_jax():
    names = imported_names(os.path.join(REPO, "chip_smoke.py"))
    assert not jax_names(names), jax_names(names)
    assert "kaldi_lstm_tpu_torch.train.trainer" in names


def _port_sources() -> list:
    root = os.path.join(REPO, "kaldi_lstm_tpu_torch")
    return sorted(os.path.relpath(os.path.join(d, n), REPO)
                  for d, _, files in os.walk(root)
                  for n in files if n.endswith(".py"))


@pytest.mark.parametrize("path", _port_sources())
def test_port_source_imports_no_jax(path):
    """No import statement of a port module names jax or the JAX package,
    not even a lazy one inside a function (the fresh-interpreter checks
    see only what importing the module runs)."""
    bad = jax_names(imported_names(os.path.join(REPO, path)))
    assert not bad, bad


def test_port_source_scan_sees_lazy_imports(tmp_path):
    """The scan above reports an import inside a function body."""
    src = tmp_path / "lazy.py"
    src.write_text("def f():\n    from kaldi_lstm_tpu.io.kaldi_io import "
                   "_read_key\n    import jax.numpy as jnp\n")
    assert jax_names(imported_names(str(src))) == [
        "jax.numpy", "kaldi_lstm_tpu.io.kaldi_io"]
    assert len(_port_sources()) > 100


_DECODE_MAPS = r"""
import numpy as np, sys
from kaldi_lstm_tpu_torch.decode.faster import decode_faster
from kaldi_lstm_tpu_torch.decode.graph import build_decoding_graph
from kaldi_lstm_tpu_torch.io.arpa import uniform_unigram
from kaldi_lstm_tpu_torch.io.transition_model import (
    make_monophone_transition_model)
tm = make_monophone_transition_model(4, 2)
lex = {"a": [[2, 3]], "b": [[4]]}
g = build_decoding_graph(tm, lex, uniform_unigram(sorted(lex)))
decode_faster(g, np.zeros((5, tm.num_pdfs)), 1.0, 10.0)
maps = open("/proc/self/maps").read()
print([l.split()[-1] for l in maps.splitlines() if ".so" in l
       and ("kltdecode" in l or "kltio" in l)])
"""


def test_decoder_core_is_the_ports_own_build():
    """A native decode loads the library built from the port's own
    csrc/kltdecode.cc into kaldi_lstm_tpu_torch/_build/, never the JAX
    package's native/libkltio.so."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("KLT_DECODE_IMPL", None)
    res = subprocess.run([sys.executable, "-c", _DECODE_MAPS], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    libs = set(ast.literal_eval(res.stdout.strip().splitlines()[-1]))
    assert libs and all(
        p.startswith(os.path.join(REPO, "kaldi_lstm_tpu_torch", "_build",
                                  "libkltdecode.")) for p in libs), libs


_SCAN_MAPS = r"""
import sys, tempfile, numpy as np
from kaldi_lstm_tpu_torch.io import kaldi_io as kio
d = tempfile.mkdtemp()
with kio.MatrixWriter(f"ark:{d}/m.ark") as w:
    w.write("u", np.ones((3, 2), np.float32))
assert list(kio.SequentialMatrixReader(f"ark:{d}/m.ark"))[0][0] == "u"
maps = open("/proc/self/maps").read()
print([l.split()[-1] for l in maps.splitlines() if ".so" in l
       and ("kltdecode" in l or "kltio" in l)])
"""


def test_io_library_is_the_ports_own_build():
    """A native ark scan loads the library built from the port's own
    csrc/kltio.cc into kaldi_lstm_tpu_torch/_build/, never the JAX
    package's native/libkltio.so."""
    res = subprocess.run([sys.executable, "-c", _SCAN_MAPS], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    libs = set(ast.literal_eval(res.stdout.strip().splitlines()[-1]))
    assert libs and all(
        p.startswith(os.path.join(REPO, "kaldi_lstm_tpu_torch", "_build",
                                  "libkltio.")) for p in libs), libs


def _case(S=3, T=5, I=7, C=9, R=6, device="cpu", scale=0.3):
    p = init_lstm_params(torch.Generator().manual_seed(0), I, C, R, scale,
                         device=device)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(S, T, I).astype(np.float32), device=device)
    st = LstmState(
        c=torch.tensor(rng.randn(S, C).astype(np.float32), device=device),
        r=torch.tensor(rng.randn(S, R).astype(np.float32), device=device))
    return p, x, st


@pytest.mark.parametrize("time_major", [False, True])
def test_lstm_infer_on_cpu_takes_plain_version(time_major):
    p, x, st = _case()
    if time_major:
        x = x.transpose(0, 1).contiguous()
    li.reset_counts()
    out, fin = li.lstm_infer(p, x, st, 50.0, time_major=time_major)
    ref, ref_fin = lstm_scan(p, x, st, 50.0, time_major=time_major)
    assert (li.LAUNCHES, li.PLAIN_CALLS) == (0, 1)
    assert torch.equal(out, ref) and torch.equal(fin.c, ref_fin.c)


def test_component_dispatch_on_cpu_counts_plain_calls():
    from kaldi_lstm_tpu_torch.models import Nnet
    proto = """<NnetProto>
<TimeShift> <InputDim> 4 <OutputDim> 4 <Shift> 1
<LstmProjected> <InputDim> 4 <OutputDim> 3 <CellDim> 5
<LstmProjected> <InputDim> 3 <OutputDim> 3 <CellDim> 5
</NnetProto>"""
    nnet, params = Nnet.init_from_proto(
        proto, torch.Generator().manual_seed(1), "cpu")
    li.reset_counts()
    y = nnet.feedforward(params, torch.zeros(2, 6, 4))
    assert y.shape == (2, 6, 3)
    assert (li.LAUNCHES, li.PLAIN_CALLS) == (0, 2)


def test_cli_device_cuda_without_cuda_exits_1(tmp_path, monkeypatch):
    from kaldi_lstm_tpu_torch.tools import (
        bench_wavefront,
        nnet_copy,
        nnet_debug_dump,
        nnet_forward,
        nnet_initialize,
        run_recipe,
        train_lstm_streams,
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.ark"
    assert nnet_forward.main(["m.nnet", "ark:f.ark", f"ark:{out}",
                              "--device", "cuda"]) == 1
    assert nnet_initialize.main(["p.proto", str(tmp_path / "n")]) == 1
    assert nnet_copy.main(["m.nnet", str(tmp_path / "c")]) == 1
    assert train_lstm_streams.main(["ark:f.ark", "ark:p.ark", "m.nnet",
                                    str(tmp_path / "t.nnet")]) == 1
    assert bench_wavefront.main(["8", "1", "1", "ab"]) == 1
    assert nnet_debug_dump.main(["m.nnet", "ark:f.ark",
                                 str(tmp_path / "dump")]) == 1
    assert train_lstm_streams.main(["ark:f.ark", "ark:p.ark", "m.nnet",
                                    str(tmp_path / "t.nnet"),
                                    "--step-group", "4"]) == 1
    exp = tmp_path / "exp"
    assert run_recipe.main(["--tr-feats", "ark:f.ark", "--tr-targets",
                            "ark:p.ark", "--cv-feats", "ark:f.ark",
                            "--cv-targets", "ark:p.ark", "--dir", str(exp),
                            "--proto", "p.proto"]) == 1
    assert not out.exists() and not (tmp_path / "t.nnet").exists()
    assert not (tmp_path / "dump").exists()
    assert not exp.exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); "
                    "run on the card with: python -m pytest -m gpu "
                    "tests/test_torch_isolation.py")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,I,C,R,clip,scale", [
    (8, 64, 40, 800, 512, 50.0, 0.04),
    (3, 17, 37, 200, 130, 1.0, 0.1),
    (1, 1, 1, 1, 1, 50.0, 0.3),
    (256, 20, 40, 800, 512, 50.0, 0.04),
    (8, 64, 512, 800, 512, 50.0, 0.04),
])
def test_cuda_kernel_matches_plain_version(cuda_device, S, T, I, C, R, clip,
                                           scale):
    """Tolerance 1e-4 abs + 1e-4 rel: both float32, different summation
    orders (see chip_smoke.py). Weight scales keep the recurrence
    contractive, as trained nets are, so rounding does not compound."""
    p, x, st = _case(S, T, I, C, R, device=cuda_device, scale=scale)
    li.reset_counts()
    with torch.inference_mode():
        out, fin = li.lstm_infer(p, x * 5, st, clip)
        ref, ref_fin = lstm_scan(p, x * 5, st, clip)
        torch.cuda.synchronize()
    assert (li.LAUNCHES, li.PLAIN_CALLS) == (1, 0)
    for a, b in ((out, ref), (fin.c, ref_fin.c), (fin.r, ref_fin.r)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    empty, same = li.lstm_infer(p, x[:, :0], st, clip)
    assert empty.shape == (S, 0, R) and same.c is st.c
    with pytest.raises(TypeError):
        li.lstm_infer(p, x.double(), st, clip)
