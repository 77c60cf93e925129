"""The port's model tools and training recipe against the JAX package's:

* `nnet_info`: the same printed summary;
* `nnet_concat`: byte-identical output, the same errors;
* `nnet_edit`: every byte identical except the freshly inserted
  components' weights (drawn from a torch.Generator here, from a JAX key
  there), the same error messages and exit codes;
* `run_recipe`: both packages driven with the trainer replaced by the
  same scripted stub (as tests/test_newbob.py does): the same trainer
  calls, accept / reject / halve / stop decisions, files, final model
  and newbob resume JSON; a state file written by one package resumes in
  the other; flags the port's trainer does not take exit 1 up front, and
  `--step-group`/`--verbose` reach every trainer call;
* the layer-stacking recipe end to end on the port's CPU path at a tiny
  size: one-layer pretrain, stack with a frozen trunk (bit-identical
  after training), unfreeze and fine-tune.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.tools import nnet_concat as j_concat
from kaldi_lstm_tpu.tools import nnet_edit as j_edit
from kaldi_lstm_tpu.tools import nnet_info as j_info
from kaldi_lstm_tpu.tools import nnet_initialize as j_init
from kaldi_lstm_tpu.tools import run_recipe as j_recipe
from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.tools import nnet_concat as t_concat
from kaldi_lstm_tpu_torch.tools import nnet_edit as t_edit
from kaldi_lstm_tpu_torch.tools import nnet_info as t_info
from kaldi_lstm_tpu_torch.tools import run_recipe as t_recipe
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

ONE_LAYER = """<NnetProto>
<Transmit> <InputDim> 5 <OutputDim> 5
<LstmProjectedStreams> <InputDim> 5 <OutputDim> 6 <CellDim> 7 <ParamScale> 0.1 <NumStream> 4
<AffineTransform> <InputDim> 6 <OutputDim> 9 <ParamStddev> 0.1
<Softmax> <InputDim> 9 <OutputDim> 9
</NnetProto>
"""
STACK_LINES = (
    "<LstmProjectedStreams> <InputDim> 6 <OutputDim> 6 <CellDim> 7 "
    "<ParamScale> 0.1 <NumStream> 4\n"
    "<AffineTransform> <InputDim> 6 <OutputDim> 9 <ParamStddev> 0.1")
CMVN = """<NnetProto>
<AddShift> <InputDim> 5 <OutputDim> 5
<Rescale> <InputDim> 5 <OutputDim> 5
</NnetProto>
"""


def _model(tmp_path, name, proto, binary="true"):
    pf = tmp_path / f"{name}.proto"
    pf.write_text(proto)
    out = tmp_path / name
    assert j_init.main([str(pf), str(out), f"--binary={binary}"]) == 0
    return str(out)


def _errors(text: str) -> list:
    """The error and warning lines (LOG lines carry a clock time)."""
    return [ln for ln in text.splitlines()
            if ln.startswith(("error:", "warning:"))]


# ---------------------------------------------------------------------------
# nnet_info / nnet_concat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("binary", ["true", "false"])
def test_nnet_info_prints_what_jax_prints(tmp_path, capsys, binary):
    model = _model(tmp_path, "m", ONE_LAYER, binary)
    assert j_info.main([model]) == 0
    want = capsys.readouterr().out
    assert t_info.main([model]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "num-components 4" in got and "LstmProjectedStreams" in got


@pytest.mark.parametrize("binary", ["true", "false"])
def test_nnet_concat_bytes_match_jax(tmp_path, binary):
    a = _model(tmp_path, "cmvn", CMVN)
    b = _model(tmp_path, "m", ONE_LAYER)
    out_j, out_t = tmp_path / "j.nnet", tmp_path / "t.nnet"
    assert j_concat.main([a, b, str(out_j), f"--binary={binary}"]) == 0
    assert t_concat.main([a, b, str(out_t), f"--binary={binary}"]) == 0
    assert out_t.read_bytes() == out_j.read_bytes()


@pytest.mark.parametrize("which", ["too few", "dim mismatch"])
def test_nnet_concat_errors_match_jax(tmp_path, capsys, which):
    a = _model(tmp_path, "m", ONE_LAYER)
    argv = [a, str(tmp_path / "o")] if which == "too few" else \
        [a, a, str(tmp_path / "o")]
    res = []
    for tool in (j_concat, t_concat):
        rc = tool.main(argv)
        res.append((rc, _errors(capsys.readouterr().err)))
    assert res[0] == res[1] and res[0][0] == 1 and res[0][1]
    assert not (tmp_path / "o").exists()


# ---------------------------------------------------------------------------
# nnet_edit
# ---------------------------------------------------------------------------

def _inserted(argv) -> list:
    """Indices of the components --insert-at puts in (after the edit)."""
    if "--insert-at" not in argv:
        return []
    n = argv[argv.index("--proto-line") + 1].count("\n") + 1
    at = int(argv[argv.index("--insert-at") + 1])
    return list(range(at, at + n))


@pytest.mark.parametrize("argv", [
    # the recipe's stack step: fresh LSTMP-2 + affine, frozen trunk
    ["--remove-at", "2", "--insert-at", "2", "--proto-line", STACK_LINES,
     "--set-learn-rate-coef", "1=0"],
    ["--set-learn-rate-coef", "1=1"],                 # unfreeze
    ["--set-learn-rate-coef=-2=0.5", "--set-dropout", "1=0.2"],
    ["--remove-at", "0"],
    ["--insert-at", "-1", "--proto-line", "<Sigmoid> <InputDim> 9 "
     "<OutputDim> 9", "--binary", "false"],
    ["--insert-at", "1", "--proto-line", "<Tanh> <InputDim> 6 <OutputDim> "
     "6"],                                            # dims mismatch: warns
])
def test_nnet_edit_matches_jax_outside_inserted_weights(tmp_path, capsys,
                                                        argv):
    model = _model(tmp_path, "m", ONE_LAYER)
    out_j, out_t = str(tmp_path / "j.nnet"), str(tmp_path / "t.nnet")
    assert j_edit.main([model, out_j] + argv) == 0
    err_j = _errors(capsys.readouterr().err)
    assert t_edit.main([model, out_t] + argv) == 0
    err_t = _errors(capsys.readouterr().err)
    assert err_t == err_j
    nj, pj = Nnet.read(out_j)
    nt, pt = Nnet.read(out_t)
    ins = [i % len(nt.components) for i in _inserted(argv)]
    if ins:
        # the inserted weights are the port's own seeded draw
        line = argv[argv.index("--proto-line") + 1]
        _, fresh = Nnet.init_from_proto(line, torch.Generator().manual_seed(
            777))
        for k, i in enumerate(ins):
            for a, b in zip(tree_leaves(pt[i]), tree_leaves(fresh[k])):
                assert torch.equal(a, b)
    # with the inserted weights swapped in, the bytes are the JAX tool's
    mixed = tuple(pj[i] if i in ins else p for i, p in enumerate(pt))
    mix_path = tmp_path / "mix.nnet"
    binary = "false" not in argv
    nt.write(str(mix_path), mixed, binary=binary)
    with open(out_j, "rb") as f:
        assert mix_path.read_bytes() == f.read()


@pytest.mark.parametrize("argv", [
    ["--insert-at", "1"],
    ["--set-learn-rate-coef", "9=0"],
    ["--set-learn-rate-coef=-5=0"],
    ["--set-learn-rate-coef", "0=0"],      # Transmit is not updatable
    ["--set-learn-rate-coef", "x=0"],
    ["--set-dropout", "0=0.1"],            # Transmit has no dropout
    ["--set-dropout", "1=1.5"],
    ["--set-dropout=-9=0.1"],
    ["--set-dropout", "1"],
])
def test_nnet_edit_errors_match_jax(tmp_path, capsys, argv):
    model = _model(tmp_path, "m", ONE_LAYER)
    res = []
    for tool, out in ((j_edit, "j"), (t_edit, "t")):
        rc = tool.main([model, str(tmp_path / out)] + argv)
        res.append((rc, _errors(capsys.readouterr().err)))
        assert not (tmp_path / out).exists()
    assert res[0] == res[1] and res[0][0] == 1 and len(res[0][1]) == 1


# ---------------------------------------------------------------------------
# run_recipe with a scripted trainer
# ---------------------------------------------------------------------------

class StubTrainer:
    """Replaces tools.train_lstm_streams inside run_recipe: training
    copies the model file and appends '+'; cross-validation returns
    scripted AvgLoss values (IndexError once they run out, a crash)."""

    def __init__(self, cv_losses):
        self.cv_losses = list(cv_losses)
        self.calls = []

    def main(self, argv):
        self.calls.append(list(argv))
        if "--cross-validate=true" in argv:
            if self.cv_losses:
                self.cv_losses.pop(0)
            return 0
        cur, nxt = argv[2], argv[3]
        with open(cur) as f, open(nxt, "w") as g:
            g.write(f.read() + "+")
        return 0

    def run_main(self, argv):
        self.calls.append(list(argv))

        class Stats:
            def __init__(self, v):
                self.v = v

            def avg_loss(self):
                return self.v

        return 0, Stats(self.cv_losses.pop(0))


def _exp(tmp_path, name):
    d = tmp_path / name
    os.makedirs(d / "nnet")
    (d / "nnet.init").write_text("M0")
    return d


def _drive(recipe, d, losses, monkeypatch, extra):
    stub = StubTrainer(losses)
    monkeypatch.setattr(recipe, "train_lstm_streams", stub)
    argv = ["--tr-feats", "scp:x", "--tr-targets", "ark:x",
            "--cv-feats", "scp:x", "--cv-targets", "ark:x",
            "--dir", str(d), "--learn-rate", "1.0"] + list(extra)
    if recipe is t_recipe:
        argv += ["--device", "cpu"]
    try:
        rc = recipe.main(argv)
    except IndexError:
        rc = "crashed"
    return rc, stub


def _snapshot(d) -> dict:
    """Every file under d with its text, the directory name blanked."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, d)] = open(p).read().replace(str(d), "D")
    return out


def _calls(stub, d) -> list:
    return [[a.replace(str(d), "D") for a in argv if a != "--device=cpu"]
            for argv in stub.calls]


SCENARIOS = {
    # base 10; it1 9.0 accepted; it2 8.95 accepted, halving on; it3 8.97
    # rejected and below end-halving: stop
    "accept-reject-halve-stop": ([10.0, 9.0, 8.95, 8.97], []),
    "min-iters-forces-continue": ([10.0, 9.999, 9.998, 9.997, 9.9969],
                                  ["--min-iters", "3"]),
    "rejected-restarts-from-previous": ([10.0, 5.0, 6.0, 4.9, 4.895, 4.894],
                                        []),
    "blowup-rejected-within-min-iters": ([10.0, 9.0, 463.0, 8.0, 7.995],
                                         ["--min-iters", "3"]),
    "blowup-guard-off": ([10.0, 9.0, 463.0, 8.0, 7.995],
                         ["--min-iters", "3", "--reject-blowup", "0"]),
    "keep-lr-iters": ([10.0, 9.99, 9.985, 9.98, 9.9799, 9.9798],
                      ["--keep-lr-iters", "2"]),
    "crash-mid-run": ([10.0, 9.0, 8.0], []),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_newbob_decisions_files_and_state_match_jax(tmp_path, monkeypatch,
                                                    name):
    losses, extra = SCENARIOS[name]
    extra = ["--scheduler", "newbob", "--max-iters", "6"] + extra
    res = {}
    for key, recipe in (("jax", j_recipe), ("port", t_recipe)):
        d = _exp(tmp_path, key)
        rc, stub = _drive(recipe, d, losses, monkeypatch, extra)
        res[key] = (rc, _calls(stub, d), _snapshot(d))
    assert res["port"] == res["jax"]
    assert "nnet/newbob.state" in res["port"][2]


def test_newbob_state_resumes_across_packages(tmp_path, monkeypatch):
    """A run killed in one package resumes in the other, with the
    outcome of resuming in the same package."""
    extra = ["--scheduler", "newbob", "--max-iters", "4"]
    outcomes = {}
    pkg = {"jax": j_recipe, "port": t_recipe}
    for key in (("jax", "port"), ("port", "jax"), ("jax", "jax")):
        first, then = pkg[key[0]], pkg[key[1]]
        d = _exp(tmp_path, "_".join(key))
        rc, _ = _drive(first, d, [10.0, 9.0, 8.0], monkeypatch, extra)
        assert rc == "crashed" and (d / "nnet" / "newbob.state").exists()
        rc, stub = _drive(then, d, [7.5, 7.49], monkeypatch, extra)
        assert rc == 0
        outcomes[key] = (_calls(stub, d), _snapshot(d))
    want = outcomes[("jax", "jax")]
    for key, got in outcomes.items():
        assert got == want, key
    assert want[1]["final.nnet"] == "M0++++"


@pytest.mark.parametrize("name,losses,pre", [
    ("fresh", [5.0, 4.0, 3.0], {}),
    # a zero-byte nnet.iter2 left by a killed run is trained again
    ("resume", [5.0, 4.0, 3.0], {"nnet.iter1": "M1", "nnet.iter2": ""}),
])
def test_fixed_scheduler_matches_jax(tmp_path, monkeypatch, name, losses,
                                     pre):
    extra = ["--scheduler", "fixed", "--max-iters", "3",
             "--start-halving", "1"]
    res = {}
    for key, recipe in (("jax", j_recipe), ("port", t_recipe)):
        d = _exp(tmp_path, key)
        for f, text in pre.items():
            (d / "nnet" / f).write_text(text)
        rc, stub = _drive(recipe, d, losses, monkeypatch, extra)
        res[key] = (rc, _calls(stub, d), _snapshot(d))
    assert res["port"] == res["jax"]
    assert res["port"][0] == 0


@pytest.mark.parametrize("flag,item", [
    (["--mesh", "data=4"], "mesh 4x1 needs 4 devices, have 1"),
    (["--num-processes", "2", "--coordinator-address", "h:1"],
     "needs --mesh"),
])
def test_unported_trainer_flags_exit_1_up_front(tmp_path, monkeypatch,
                                                capsys, flag, item):
    """The mesh flags are ported (parallel/); a mesh that the process
    count cannot hold exits 1 before any file is written."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    d = tmp_path / "exp"
    rc, stub = _drive(t_recipe, d, [], monkeypatch,
                      ["--scheduler", "newbob", "--proto", "p"] + flag)
    assert rc == 1 and not stub.calls and not d.exists()
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flags,passed", [
    (["--step-group", "2"], ["--step-group=2", "--verbose=1"]),
    (["--step-group", "16", "--verbose", "2"],
     ["--step-group=16", "--verbose=2"]),
    (["--bf16", "true", "--step-group", "16"],
     ["--bf16=true", "--step-group=16"]),
])
def test_trainer_flags_reach_the_trainer(tmp_path, monkeypatch, flags,
                                         passed):
    """--step-group, --bf16 and --verbose pass through to every trainer
    call, as the JAX recipe passes them."""
    res = {}
    for key, recipe in (("jax", j_recipe), ("port", t_recipe)):
        d = _exp(tmp_path, key)
        rc, stub = _drive(recipe, d, [5.0, 4.0], monkeypatch,
                          ["--scheduler", "newbob", "--max-iters", "1"]
                          + flags)
        assert rc == 0
        res[key] = _calls(stub, d)
    assert res["port"] == res["jax"]
    assert len(res["port"]) == 3     # CV of the start model, train, CV
    for argv in res["port"]:
        for f in passed:
            assert f in argv


def test_no_init_and_no_proto_exits_1(tmp_path, monkeypatch, capsys):
    d = tmp_path / "exp"
    os.makedirs(d)
    rc, stub = _drive(t_recipe, d, [], monkeypatch, [])
    assert rc == 1 and not stub.calls
    assert "no nnet.init and no --proto" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the layer-stacking recipe on the port's CPU path
# ---------------------------------------------------------------------------

def _corpus(tmp_path):
    rng = np.random.RandomState(5)
    feats, post = f"ark:{tmp_path}/feats.ark", f"ark:{tmp_path}/post.ark"
    with kio.MatrixWriter(feats) as fw, kio.PosteriorWriter(post) as pw:
        for i in range(10):
            x = rng.randn(int(rng.randint(15, 40)), 5).astype(np.float32)
            fw.write(f"u{i}", x)
            pw.write(f"u{i}", [[(int(k), 1.0)] for k in x.argmax(1)])
    return feats, post


def test_layer_stacking_recipe_on_cpu(tmp_path, capsys):
    feats, post = _corpus(tmp_path)
    proto = tmp_path / "one.proto"
    proto.write_text(ONE_LAYER)
    common = ["--tr-feats", feats, "--tr-targets", post, "--cv-feats", feats,
              "--cv-targets", post, "--scheduler", "newbob",
              "--learn-rate", "0.02", "--max-iters", "1", "--num-stream", "4",
              "--batch-size", "5", "--targets-delay", "0", "--verbose", "0",
              "--device", "cpu"]
    pre, stack, exp = (str(tmp_path / n) for n in ("pre", "stack", "exp"))
    assert t_recipe.main(common + ["--dir", pre, "--proto", str(proto),
                                   "--min-iters", "1"]) == 0
    os.makedirs(stack)
    assert t_edit.main([f"{pre}/final.nnet", f"{stack}/nnet.init",
                        "--remove-at", "2", "--insert-at", "2",
                        "--proto-line", STACK_LINES,
                        "--set-learn-rate-coef", "1=0"]) == 0
    assert t_recipe.main(common + ["--dir", stack, "--min-iters", "1"]) == 0
    n0, p0 = Nnet.read(f"{stack}/nnet.init")
    n1, p1 = Nnet.read(f"{stack}/nnet/nnet.iter1")
    assert n1.components[1].learn_rate_coef == 0.0
    for a, b in zip(p0[1], p1[1]):          # the frozen trunk
        assert torch.equal(a, b)
    for a, b in zip(p0[2], p1[2]):          # the new layer trained
        assert not torch.equal(a, b)
    os.makedirs(exp)
    assert t_edit.main([f"{stack}/final.nnet", f"{exp}/nnet.init",
                        "--set-learn-rate-coef", "1=1"]) == 0
    assert t_recipe.main(common + ["--dir", exp]) == 0
    with open(f"{exp}/nnet/newbob.state") as f:
        st = json.load(f)
    assert st["iter"] == 1 and np.isfinite(st["loss"])
    capsys.readouterr()
    assert t_info.main([f"{exp}/final.nnet"]) == 0
    info = capsys.readouterr().out
    assert info.count("LstmProjectedStreams") == 2
    shutil.rmtree(pre)
