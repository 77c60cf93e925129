"""The port's `nnet_forward` CLI and `AmScorer` against the JAX
package's on the same model file and the same synthetic feature ark
(made with numpy from a seed). Keys must be identical and in order; the
score matrices agree within rtol 1e-5 / atol 1e-5 (float32 on both
sides, values up to ~10 in the log domain; only the summation order
differs). The bf16 fetch is held to 1e-2 relative: one bf16 rounding of
values that agree to ~1e-6 can land one ulp (2^-8) apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.decode.scoring import AmScorer as JAmScorer
from kaldi_lstm_tpu.io import kaldi_io as jkio
from kaldi_lstm_tpu.models import Nnet as JNnet
from kaldi_lstm_tpu.tools import nnet_forward as jforward
from kaldi_lstm_tpu_torch.decode.scoring import AmScorer, dense_from_topk
from kaldi_lstm_tpu_torch.io import kaldi_io as kio
from kaldi_lstm_tpu_torch.models import Nnet
from kaldi_lstm_tpu_torch.tools import nnet_forward

PROTO = """<NnetProto>
<TimeShift> <InputDim> 6 <OutputDim> 6 <Shift> 3
<LstmProjected> <InputDim> 6 <OutputDim> 5 <CellDim> 11 <ParamScale> 0.2
<AffineTransform> <InputDim> 5 <OutputDim> 17 <ParamStddev> 0.5 <BiasRange> 1.0
<Softmax> <InputDim> 17 <OutputDim> 17
</NnetProto>
"""
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("scoring")
    jn, jp = JNnet.init_from_proto(PROTO, jax.random.PRNGKey(0))
    model = str(d / "final.nnet")
    jn.write(model, jp)
    rng = np.random.RandomState(0)
    utts = {f"utt{i}": rng.randn(int(rng.randint(1, 40)), 6)
            .astype(np.float32) for i in range(7)}
    ark = str(d / "feats.ark")
    with jkio.MatrixWriter(f"ark:{ark}") as w:
        for k, m in utts.items():
            w.write(k, m)
    counts = str(d / "counts.vec")
    with open(counts, "wb") as f:
        jkio.write_vector(jkio.KaldiOutput(f),
                          rng.randint(0, 50, 17).astype(np.float32))
    return d, model, ark, counts, utts


def _read(path):
    return list(kio.SequentialMatrixReader(f"ark:{path}"))


@pytest.mark.parametrize("flags", [
    [],
    ["--apply-log=true", "--class-frame-counts", "{counts}"],
    ["--apply-log=true", "--class-frame-counts", "{counts}",
     "--batch-utts", "3", "--length-bucket", "16"],
    ["--no-softmax=true", "--class-frame-counts", "{counts}",
     "--prior-scale", "0.5"],
    ["--class-frame-counts", "{counts}", "--batch-utts", "3"],
], ids=["posteriors", "apply_log_priors", "batched_bucketed", "no_softmax",
        "host_log_priors"])
def test_cli_matches_jax_cli(data, flags):
    d, model, ark, counts, utts = data
    flags = [f.format(counts=counts) for f in flags]
    tag = str(abs(hash(tuple(flags))))
    out_j, out_t = str(d / f"j{tag}.ark"), str(d / f"t{tag}.ark")
    assert jforward.main([model, f"ark:{ark}", f"ark:{out_j}"] + flags) == 0
    assert nnet_forward.main([model, f"ark:{ark}", f"ark:{out_t}",
                              "--device", "cpu"] + flags) == 0
    got, exp = _read(out_t), _read(out_j)
    assert [k for k, _ in got] == [k for k, _ in exp] == list(utts)
    for (k, a), (_, b) in zip(got, exp):
        assert a.shape == (utts[k].shape[0], 17)
        np.testing.assert_allclose(a, b, **TOL)


def test_cli_flag_conflict_exits_1(data):
    _, model, ark, _, _ = data
    assert nnet_forward.main([model, f"ark:{ark}", "ark:/dev/null",
                              "--apply-log=true", "--no-softmax=true",
                              "--device", "cpu"]) == 1


def _scorers(model, log_prior, **kw):
    """The two packages' scorers with the same options; a "bf16"
    fetch_dtype becomes each package's own bfloat16."""
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("fetch_dtype") == "bf16":
        jkw["fetch_dtype"], tkw["fetch_dtype"] = jnp.bfloat16, torch.bfloat16
    jn, jp = JNnet.read(model)
    tn, tp = Nnet.read(model, "cpu")
    common = dict(log_prior=log_prior, apply_log=True, batch_utts=3,
                  length_bucket=16)
    return (JAmScorer(jn, jp, **common, **jkw),
            AmScorer(tn, tp, device="cpu", **common, **tkw))


@pytest.mark.parametrize("kw,tol", [
    (dict(pipeline=True), TOL),
    (dict(top_p=4), TOL),
    (dict(top_p=4, pipeline=True, floor_margin=3.0), TOL),
    (dict(fetch_dtype="bf16"), dict(rtol=1e-2, atol=1e-2)),
], ids=["pipeline", "top_p", "top_p_pipeline", "bf16_fetch"])
def test_scorer_options_match_jax(data, kw, tol):
    from kaldi_lstm_tpu_torch.decode.scoring import (
        log_priors_from_counts,
        read_class_frame_counts,
    )
    _, model, _, counts, utts = data
    lp = log_priors_from_counts(read_class_frame_counts(counts))
    j, t = _scorers(model, lp, **kw)
    exp = list(j.score_stream(utts.items()))
    got = list(t.score_stream(utts.items()))
    assert [k for k, _ in got] == [k for k, _ in exp] == list(utts)
    for (_, a), (_, b) in zip(got, exp):
        np.testing.assert_allclose(a, b, **tol)


def test_top_p_requires_log_domain_and_dense_floor(data):
    _, model, _, _, _ = data
    tn, tp = Nnet.read(model, "cpu")
    with pytest.raises(ValueError):
        AmScorer(tn, tp, top_p=3, device="cpu")
    vals = np.array([[[-1.0, -2.0]]], np.float32)
    idx = np.array([[[3, 0]]], np.int32)
    np.testing.assert_array_equal(
        dense_from_topk(vals, idx, 5, 10.0),
        [[[-2.0, -12.0, -12.0, -1.0, -12.0]]])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(top_p=4, floor_margin=3.0),
    dict(fetch_dtype=torch.bfloat16),
], ids=["dense", "top_p", "bf16_fetch"])
def test_pipeline_gives_the_rows_of_no_pipeline(data, kw):
    """`pipeline=True` changes only when batch k is fetched, never what
    is fetched: identical keys and bytes on the CPU path."""
    from kaldi_lstm_tpu_torch.decode.scoring import (
        log_priors_from_counts,
        read_class_frame_counts,
    )
    _, model, _, counts, utts = data
    lp = log_priors_from_counts(read_class_frame_counts(counts))
    tn, tp = Nnet.read(model, "cpu")
    rows = [list(AmScorer(tn, tp, log_prior=lp, apply_log=True,
                          batch_utts=3, length_bucket=16, device="cpu",
                          pipeline=pipe, **kw).score_stream(utts.items()))
            for pipe in (False, True)]
    assert [k for k, _ in rows[0]] == [k for k, _ in rows[1]] == list(utts)
    for (_, a), (_, b) in zip(*rows):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()


FULL_PROTO = """<NnetProto>
<TimeShift> <InputDim> 40 <OutputDim> 40 <Shift> 5
<LstmProjected> <InputDim> 40 <OutputDim> 512 <CellDim> 800 <ParamScale> 0.01
<AffineTransform> <InputDim> 512 <OutputDim> 8000 <ParamStddev> 0.04
<Softmax> <InputDim> 8000 <OutputDim> 8000
</NnetProto>
"""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the side-stream score copy runs "
                    "only there); run on the card with: python -m pytest "
                    "-m gpu tests/test_torch_scoring.py")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("top_p", [0, 16])
def test_cuda_score_copy_overlaps_next_batch(cuda_device, top_p):
    """At the full-width decode net, with the pipeline, batch k's
    side-stream copy runs while batch k+1's input copy and forward do
    (the intervals between CUDA events on the two streams intersect);
    without it no copy does. A spin kernel of about 0.5 s before every
    forward keeps the device behind the host, so that the order of the
    work on the two streams decides, not the host's speed: the host's
    work on batch k (copying its rows out, and with top_p rebuilding
    them dense) outlasts a forward, and with one batch in flight batch
    k+2 is queued only after it. The rows equal `pipeline=False`'s byte
    for byte."""
    from kaldi_lstm_tpu_torch.decode.scoring import copy_overlaps
    nnet, params = Nnet.init_from_proto(
        FULL_PROTO, torch.Generator().manual_seed(0), cuda_device)
    rng = np.random.RandomState(1)
    utts = [(f"utt{i:03d}", rng.randn(int(rng.randint(200, 1001)), 40)
             .astype(np.float32)) for i in range(24)]
    spin = 1_000_000_000   # cycles: about 0.5 s at 1.98 GHz, more if slower
    out, overlap = {}, {}
    for pipe in (False, True):
        scorer = AmScorer(nnet, params, apply_log=True, pipeline=pipe,
                          top_p=top_p)
        pend = []
        dispatch, forward = scorer._dispatch, scorer._forward
        scorer._dispatch = lambda g: pend.append(dispatch(g)) or pend[-1]

        def slow_forward(x, forward=forward):
            torch.cuda._sleep(spin)
            return forward(x)
        scorer._forward = slow_forward
        # copies, not the rows: a kept row holds its pinned block, and
        # each batch would then pin fresh host memory
        out[pipe] = [(k, y.copy()) for k, y in scorer.score_stream(utts)]
        torch.cuda.synchronize()
        assert len(pend) == 3
        overlap[pipe] = [copy_overlaps(pend[k], pend[k + 1])
                         for k in range(len(pend) - 1)]
    assert overlap == {False: [False, False], True: [True, True]}
    assert [k for k, _ in out[True]] == [k for k, _ in utts]
    for (ka, a), (kb, b) in zip(out[False], out[True]):
        assert ka == kb and a.dtype == b.dtype and a.tobytes() == b.tobytes()
