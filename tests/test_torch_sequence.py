"""The port's lattice-free sequence objectives (`train/sequence.py`)
against the JAX package's on the CPU.

For each denominator graph type — the structured `PhoneLoopDenGraph`
(3-state Bakis monophones), the dense `DenGraph` (the same model with a
skip arc) and the per-arc `SplitDenGraph` (a chain-style `<Tuples>`
model with split pdfs) — and for a 1-emitting-state phone set, on a
batch of ragged utterances made with numpy from a seed:
* `den_graph_for` picks the same type, with the same tensors;
* `den_logprob`, `num_logprob` (with and without transitions),
  `mmi_objective` and `expected_accuracy` (sMBR and MPE, with and
  without silence phones), and their gradients w.r.t. loglik, equal the
  JAX values;
* a padded (masked) utterance equals the same utterance alone, and
  `alignment_to_states` equals the JAX function.

Tolerance: rtol 1e-5, and an atol of 1e-5 times the largest entry of the
tensor compared (a gradient has entries near 0). Both sides are
float32; the recursions run the same ops in the same order, but
`torch.logsumexp` and `jax.nn.logsumexp` round their sums differently
(~1e-7 relative).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.decode.viterbi import PhoneLoopGraph as JPhoneLoopGraph
from kaldi_lstm_tpu.io import transition_model as jtm
from kaldi_lstm_tpu.train import sequence as js
from kaldi_lstm_tpu_torch.decode.viterbi import PhoneLoopGraph
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.train import sequence as ts

ATOL_REL = 1e-5


def close(got, want, rtol=1e-5):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=ATOL_REL * max(float(np.abs(want).max()),
                                                   1e-30))


def _models():
    dense = jtm.make_monophone_transition_model(3, 3)
    # a skip arc 0 -> 2 makes the structured graph refuse the topology
    dense.topo.entries[0][0].transitions.append((2, 0.1))
    return {"structured": jtm.make_monophone_transition_model(4, 3),
            "dense": dense,
            "split": jtm.make_chain_transition_model(3),
            "one_state": jtm.make_monophone_transition_model(4, 1)}


GRAPH_TYPE = {"structured": "PhoneLoopDenGraph", "dense": "DenGraph",
              "split": "SplitDenGraph", "one_state": "PhoneLoopDenGraph"}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """kind -> (JAX tm, port tm, JAX graph, port graph); both packages
    read the model file the JAX package wrote (so the derived tables see
    the added skip arc)."""
    d = tmp_path_factory.mktemp("tm")
    out = {}
    for kind, made in _models().items():
        path = os.path.join(d, f"{kind}.mdl")
        made.dump(path)
        j = jtm.TransitionModel.load(path)
        t = TransitionModel.load(path)
        out[kind] = (j, t, js.den_graph_for(j), ts.den_graph_for(t))
    return out


def valid_paths(jtm_, B, T, rng):
    """[B, T] graph-state paths the topology allows: a random walk over
    the phone loop's arcs that ends in a state with a final arc."""
    g = JPhoneLoopGraph.from_transition_model(jtm_)
    ok = g.logA > -1e29
    out = np.zeros((B, T), np.int32)
    for b in range(B):
        while True:
            s = rng.choice(np.flatnonzero(g.start_logp > -1e29))
            path = [s]
            for _ in range(T - 1):
                s = rng.choice(np.flatnonzero(ok[s]))
                path.append(s)
            if g.final_logp[path[-1]] > -1e29:
                break
        out[b] = path
    return out


def batch(jtm_, seed, B=3, T=13):
    """Log-likelihoods [B, T, K], a ragged mask (lengths T, 9, 5), valid
    state paths and reference pdfs/phones on them."""
    rng = np.random.RandomState(seed)
    K = jtm_.num_pdfs
    ll = rng.randn(B, T, K).astype(np.float32) * 2
    lengths = [T, 9, 5][:B]
    mask = np.zeros((B, T), np.float32)
    states = np.zeros((B, T), np.int32)
    for b, L in enumerate(lengths):
        mask[b, :L] = 1.0
        states[b, :L] = valid_paths(jtm_, 1, L, rng)[0]
    tuples = np.asarray(jtm_.tuples)
    pdfs = tuples[states, 2].astype(np.int32)
    phones = tuples[states, 0].astype(np.int32)
    # references that disagree with the path on about half the frames
    flip = rng.rand(B, T) < 0.5
    pdfs = np.where(flip, rng.randint(0, K, (B, T)), pdfs).astype(np.int32)
    return ll, mask, states, pdfs, phones


def jax_and_torch(fn_j, fn_t, ll):
    """(value, d sum(value) / d loglik) of both packages."""
    jv, vjp = jax.vjp(fn_j, jnp.asarray(ll))
    jg = vjp(jnp.ones_like(jv))[0]
    x = torch.tensor(ll, requires_grad=True)
    tv = fn_t(x)
    tg = torch.autograd.grad(tv.sum(), x)[0]
    return np.asarray(jv), np.asarray(jg), tv.detach(), tg


KINDS = sorted(GRAPH_TYPE)


@pytest.mark.parametrize("kind", KINDS)
def test_den_graph_for_picks_the_same_graph(graphs, kind):
    _, _, jg, tg = graphs[kind]
    assert type(jg).__name__ == type(tg).__name__ == GRAPH_TYPE[kind]
    for name in jg._fields:
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)
    np.testing.assert_array_equal(tg.start_logp.numpy(),
                                  np.asarray(jg.start_logp))


@pytest.mark.parametrize("kind", KINDS)
def test_den_logprob_and_gradient_match_jax(graphs, kind):
    _, _, jg, tg = graphs[kind]
    ll, mask, *_ = batch(graphs[kind][0], 0)
    jv, jgr, tv, tgr = jax_and_torch(
        lambda x: js.den_logprob(jg, x, jnp.asarray(mask), 0.7),
        lambda x: ts.den_logprob(tg, x, torch.tensor(mask), 0.7), ll)
    close(tv, jv)
    close(tgr, jgr)


@pytest.mark.parametrize("with_transitions", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_num_logprob_and_gradient_match_jax(graphs, kind, with_transitions):
    _, _, jg, tg = graphs[kind]
    ll, mask, states, *_ = batch(graphs[kind][0], 1)
    jv, jgr, tv, tgr = jax_and_torch(
        lambda x: js.num_logprob(jg, x, jnp.asarray(states),
                                 jnp.asarray(mask), 0.7, with_transitions),
        lambda x: ts.num_logprob(tg, x, torch.tensor(states),
                                 torch.tensor(mask), 0.7, with_transitions),
        ll)
    assert np.all(np.abs(jv) < 1e6)      # valid paths: no NEG arc taken
    close(tv, jv)
    close(tgr, jgr)


@pytest.mark.parametrize("kind", KINDS)
def test_mmi_objective_and_gradient_match_jax(graphs, kind):
    _, _, jg, tg = graphs[kind]
    ll, mask, states, *_ = batch(graphs[kind][0], 2)
    j_obj, j_stat = js.mmi_objective(jg, jnp.asarray(ll),
                                     jnp.asarray(states), jnp.asarray(mask))
    j_grad = jax.grad(lambda x: js.mmi_objective(
        jg, x, jnp.asarray(states), jnp.asarray(mask))[0])(jnp.asarray(ll))
    x = torch.tensor(ll, requires_grad=True)
    t_obj, t_stat = ts.mmi_objective(tg, x, torch.tensor(states),
                                     torch.tensor(mask))
    assert not t_stat.requires_grad
    close(t_obj, j_obj)
    close(t_stat, j_stat)
    close(torch.autograd.grad(t_obj, x)[0], j_grad)


@pytest.mark.parametrize("criterion,silence", [
    ("smbr", None), ("smbr", [1]), ("mpe", None), ("mpe", [1, 3])])
@pytest.mark.parametrize("kind", KINDS)
def test_expected_accuracy_and_gradient_match_jax(graphs, kind, criterion,
                                                  silence):
    """E[A] (the jvp of logZ along the accuracy tensor in the JAX package,
    sum gamma * acc here) and its gradient (forward-over-reverse there,
    a second-order backward through the den graph here)."""
    _, _, jg, tg = graphs[kind]
    ll, mask, _, pdfs, phones = batch(graphs[kind][0], 3)
    refs = pdfs if criterion == "smbr" else phones
    j_sil = None if silence is None else jnp.asarray(silence, jnp.int32)
    t_sil = None if silence is None else torch.tensor(silence)
    jv, jgr, tv, tgr = jax_and_torch(
        lambda x: js.expected_accuracy(jg, x, jnp.asarray(refs),
                                       jnp.asarray(mask), 0.6, criterion,
                                       j_sil),
        lambda x: ts.expected_accuracy(tg, x, torch.tensor(refs),
                                       torch.tensor(mask), 0.6, criterion,
                                       t_sil), ll)
    assert np.all(jv >= 0) and np.all(jv <= mask.sum(1) + 1e-4)
    close(tv, jv)
    close(tgr, jgr)
    # smbr_objective: the negated sum to minimize, E[A] detached
    obj, ea = ts.smbr_objective(tg, torch.tensor(ll), torch.tensor(refs),
                                torch.tensor(mask), 0.6, criterion, t_sil)
    close(obj, -jv.sum())
    close(ea, jv)
    assert not ea.requires_grad


@pytest.mark.parametrize("kind", KINDS)
def test_masking_equals_the_short_utterance(graphs, kind):
    """A padded utterance (mask 0 after its last real frame, garbage
    emissions there) scores as the utterance alone: alpha is carried
    through masked frames, and the last real frame is sum(mask) - 1."""
    _, _, _, tg = graphs[kind]
    ll, mask, states, pdfs, _ = batch(graphs[kind][0], 4)
    L = int(mask[2].sum())
    short = (torch.tensor(ll[2:3, :L]), torch.ones(1, L))
    full = (torch.tensor(ll[2:3]), torch.tensor(mask[2:3]))
    for fn, extra in ((ts.den_logprob, ()),
                      (ts.num_logprob, (states[2:3],)),
                      (ts.expected_accuracy, (pdfs[2:3],))):
        def run(x, m, extra=extra, fn=fn):
            args = [torch.tensor(e[:, :x.shape[1]]) for e in extra]
            return fn(tg, x, *args, m)
        close(run(*full), run(*short).numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_alignment_to_states_matches_jax(graphs, kind):
    j, t, _, _ = graphs[kind]
    rng = np.random.RandomState(5)
    tids = rng.randint(1, len(j.id2tstate), size=40)
    got = ts.alignment_to_states(t, tids)
    want = js.alignment_to_states(j, tids)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_one_state_phone_same_state_pair_scores_max_of_self_and_reentry(
        graphs):
    """On a 1-emitting-state phone a same-state pair is a self-loop or a
    re-entry; the structured graph's numerator scores it with the max of
    both, the dense graph's Viterbi-merged diagonal, so both agree."""
    _, t, _, tg = graphs["one_state"]
    dense = ts.DenGraph.from_phone_loop(
        PhoneLoopGraph.from_transition_model(t))
    states = torch.tensor([[0, 0, 0, 2, 2, 1]])
    mask = torch.ones(1, 6)
    ll = torch.tensor(np.random.RandomState(6).randn(1, 6, t.num_pdfs)
                      .astype(np.float32))
    close(ts.num_logprob(tg, ll, states, mask),
          ts.num_logprob(dense, ll, states, mask).numpy())
    close(ts.num_logprob(tg, ll, states, mask),
          np.asarray(js.num_logprob(graphs["one_state"][2],
                                    jnp.asarray(ll.numpy()),
                                    jnp.asarray(states.numpy()),
                                    jnp.asarray(mask.numpy()))))


def test_unknown_criterion_raises(graphs):
    _, _, _, tg = graphs["structured"]
    with pytest.raises(ValueError, match="unknown criterion"):
        ts.expected_accuracy(tg, torch.zeros(1, 2, 12),
                             torch.zeros(1, 2, dtype=torch.int32),
                             torch.ones(1, 2), criterion="mce")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with: python -m "
                    "pytest -m gpu tests/test_torch_sequence.py")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_card_matches_cpu(graphs, cuda_device, kind):
    """The den-graph functions and their gradients on the card against
    the CPU: rtol 1e-4 (the card's logsumexp sums in another order)."""
    j, t, _, tg = graphs[kind]
    gg = ts.den_graph_for(t, device=cuda_device)
    ll, mask, states, pdfs, _ = batch(j, 7)
    for fn, extra in ((ts.den_logprob, ()), (ts.num_logprob, (states,)),
                      (ts.expected_accuracy, (pdfs,))):
        outs = []
        for g, dev in ((tg, "cpu"), (gg, cuda_device)):
            x = torch.tensor(ll, device=dev, requires_grad=True)
            v = fn(g, x, *[torch.tensor(e, device=dev) for e in extra],
                   torch.tensor(mask, device=dev))
            outs.append((v.detach().cpu(),
                         torch.autograd.grad(v.sum(), x)[0].cpu()))
        for a, b in zip(*outs):
            torch.testing.assert_close(b, a, rtol=1e-4,
                                       atol=1e-4 * float(a.abs().max()))
