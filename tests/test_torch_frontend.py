"""The flagship recipe's front end as one chain, the port against the JAX
package on the CPU: `synth_wavs` -> `compute_fbank_feats --num-mel-bins
40` -> `compute_cmvn_transform` (train part) -> `ali_to_pdf` ->
`ali_to_post` -> `train_lstm_streams --feature-transform` (one epoch,
Transmit -> LSTMP 40 -> 16c/8r -> 15 pdfs) -> `nnet_forward
--feature-transform` on the CV part, each package through its own
tools from the same transition model and alignments.

The wavs, features, transforms and targets are held byte-equal; the
trained parameters, the training and CV reports and the scores to
rtol = atol = 1e-5 (the tolerance of tests/test_torch_train.py: both
sides float32, sums in other orders). A `gpu` case runs the port's
chain with `--device cuda` against `--device cpu`.
"""

import importlib
import os

import jax
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.tools import make_hmm_synth_data
from kaldi_lstm_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)
PROTO = """<NnetProto>
<Transmit> <InputDim> 40 <OutputDim> 40
<LstmProjectedStreams> <InputDim> 40 <OutputDim> 8 <CellDim> 16 <ParamScale> 0.05 <NumStream> 4
<AffineTransform> <InputDim> 8 <OutputDim> 15 <ParamStddev> 0.1
<Softmax> <InputDim> 15 <OutputDim> 15
</NnetProto>
"""
TRAIN_FLAGS = ["--learn-rate=0.02", "--momentum=0.5", "--num-stream=4",
               "--batch-size=5", "--targets-delay=1"]
NUM_CV = 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 utterances of a 5-phone, 3-state HMM (15 pdfs) and a random
    initial net from a seed."""
    d = str(tmp_path_factory.mktemp("frontend"))
    assert make_hmm_synth_data.main(["--dir", f"{d}/lang", "--num-phones",
                                     "5", "--num-utts", "12", "--feat-dim",
                                     "4", "--min-phones", "6"]) == 0
    nnet, params = Nnet.init_from_proto(
        PROTO, torch.Generator().manual_seed(0), "cpu")
    nnet.write(f"{d}/nnet.init", params)
    return d


def run_chain(pkg: str, d: str, work: str, device=None) -> dict:
    """The recipe's stages through `pkg`'s tools in `work`; returns the
    training and CV statistics."""
    def tool(name):
        return importlib.import_module(f"{pkg}.tools.{name}")
    dev = [] if device is None else ["--device", device]
    os.makedirs(work)
    mdl, ali = f"{d}/lang/final.mdl", f"ark:{d}/lang/ali.ark"
    assert tool("synth_wavs").main([mdl, ali, f"{work}/wav"]) == 0
    assert tool("compute_fbank_feats").main(
        [f"scp:{work}/wav/wav.scp",
         f"ark,scp:{work}/fbank.ark,{work}/fbank.scp",
         "--num-mel-bins", "40"]) == 0
    with open(f"{work}/fbank.scp") as f:
        lines = f.readlines()
    with open(f"{work}/tr.scp", "w") as f:
        f.writelines(lines[:-NUM_CV])
    with open(f"{work}/cv.scp", "w") as f:
        f.writelines(lines[-NUM_CV:])
    transf = f"{work}/transf.nnet"
    assert tool("compute_cmvn_transform").main(
        [f"scp:{work}/tr.scp", transf]) == 0
    assert tool("ali_to_pdf").main([mdl, ali, f"ark:{work}/pdf.ark"]) == 0
    assert tool("ali_to_post").main([f"ark:{work}/pdf.ark",
                                     f"ark:{work}/post.ark"]) == 0
    trainer = tool("train_lstm_streams")
    common = [f"ark:{work}/post.ark"]
    rc, train = trainer.run_main([f"scp:{work}/tr.scp"] + common + [
        f"{d}/nnet.init", f"{work}/nnet.iter1",
        f"--feature-transform={transf}"] + TRAIN_FLAGS + dev)
    assert rc == 0
    rc, cv = trainer.run_main([f"scp:{work}/cv.scp"] + common + [
        f"{work}/nnet.iter1", "--cross-validate=true",
        f"--feature-transform={transf}"] + TRAIN_FLAGS[2:] + dev)
    assert rc == 0
    assert tool("nnet_forward").main(
        [f"--feature-transform={transf}", f"{work}/nnet.iter1",
         f"scp:{work}/cv.scp", f"ark:{work}/scores.ark"] + dev) == 0
    return {"train": train, "cv": cv}


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_chain_from_wav_matches_jax(corpus, tmp_path):
    jw, tw = str(tmp_path / "jax"), str(tmp_path / "port")
    jres = run_chain("kaldi_lstm_tpu", corpus, jw)
    tres = run_chain("kaldi_lstm_tpu_torch", corpus, tw, "cpu")
    wavs = sorted(n for n in os.listdir(f"{tw}/wav") if n.endswith(".wav"))
    assert len(wavs) == 12
    for name in wavs + ["wav.scp"]:
        a = read_bytes(f"{jw}/wav/{name}").replace(jw.encode(), b"")
        assert read_bytes(f"{tw}/wav/{name}").replace(tw.encode(), b"") == a
    for name in ("fbank.ark", "transf.nnet", "pdf.ark", "post.ark"):
        assert read_bytes(f"{tw}/{name}") == read_bytes(f"{jw}/{name}"), name
    # one fbank frame per alignment frame, 40 bins
    lens = dict((k, len(v)) for k, v in kio.SequentialIntVectorReader(
        f"ark:{corpus}/lang/ali.ark"))
    feats = dict(kio.SequentialMatrixReader(f"ark:{tw}/fbank.ark"))
    assert {k: m.shape for k, m in feats.items()} == \
        {k: (n, 40) for k, n in lens.items()}
    for phase in ("train", "cv"):
        j, t = jres[phase], tres[phase]
        np.testing.assert_allclose(
            [t.avg_loss(), t.frames, t.correct],
            [j.avg_loss(), j.frames, j.correct], **TOL)
    assert tres["train"].frames > 0
    from kaldi_lstm_tpu.models import Nnet as JNnet
    tp = tree_leaves(Nnet.read(f"{tw}/nnet.iter1", "cpu")[1])
    jp = jax.tree_util.tree_leaves(JNnet.read(f"{jw}/nnet.iter1")[1])
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    init = tree_leaves(Nnet.read(f"{corpus}/nnet.init", "cpu")[1])
    assert any(not torch.equal(a, b) for a, b in zip(tp, init))
    js = dict(kio.SequentialMatrixReader(f"ark:{jw}/scores.ark"))
    ts = dict(kio.SequentialMatrixReader(f"ark:{tw}/scores.ark"))
    assert list(ts) == list(js) and len(ts) == NUM_CV
    for k in js:
        assert ts[k].shape == (lens[k], 15)
        np.testing.assert_allclose(ts[k], js[k], **TOL)


@pytest.mark.gpu
def test_chain_from_wav_on_the_card(corpus, tmp_path):
    """The port's chain with --device cuda against --device cpu: the host
    stages byte-equal, the card's run through K1-K5 only (no plain
    call), its parameters and scores within the step tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1-K5 have no CPU mode); run on "
                    "the card with: python -m pytest -m gpu "
                    "tests/test_torch_frontend.py")
    from kaldi_lstm_tpu_torch.ops.counts import reset_counts, snapshot_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    cw, gw = str(tmp_path / "cpu"), str(tmp_path / "cuda")
    run_chain("kaldi_lstm_tpu_torch", corpus, cw, "cpu")
    reset_counts()
    run_chain("kaldi_lstm_tpu_torch", corpus, gw, "cuda")
    counts = snapshot_counts()
    for k in ("lstmp_train_fwd", "lstmp_train_bwd", "xent_affine_fwd",
              "xent_affine_bwd", "lstmp_infer"):
        assert counts[k] > 0, k
    assert not any(v for k, v in counts.items() if k.startswith("plain."))
    for name in ("fbank.ark", "transf.nnet", "post.ark"):
        assert read_bytes(f"{gw}/{name}") == read_bytes(f"{cw}/{name}")
    for a, b in zip(tree_leaves(Nnet.read(f"{gw}/nnet.iter1", "cpu")[1]),
                    tree_leaves(Nnet.read(f"{cw}/nnet.iter1", "cpu")[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    cs = dict(kio.SequentialMatrixReader(f"ark:{cw}/scores.ark"))
    for k, m in kio.SequentialMatrixReader(f"ark:{gw}/scores.ark"):
        np.testing.assert_allclose(m, cs[k], rtol=1e-4, atol=1e-5)
