"""The port's lattice-based sequence math (`train/sequence_lattice.py`)
against the JAX package's on the CPU.

On random time-synchronous lattices made with numpy from a seed (each
frame's states, emitting arcs to the next frame's, parallel arcs,
epsilon arcs inside a frame and final weights on the last frame, built
once as the JAX package's and once as the port's `Lattice`):
* `mmi_errors` (objective, diff, dropped frames, frame accuracy; with
  and without frame dropping, an old acoustic scale and an lm scale)
  and `mpe_errors` (E[A] and diff; sMBR and MPE, silence phones, one
  silence class) equal the JAX functions within 1e-6 (both are float64
  host loops over the same arcs in the same order);
* the same from a CompactLattice (`as_raw_lattice` converts it);
* a lattice that is not time-synchronous is refused with the JAX
  package's message, and neither function mutates its input lattice.
"""

import os

import numpy as np
import pytest

from kaldi_lstm_tpu.io import lattice as jlat
from kaldi_lstm_tpu.io import transition_model as jtm
from kaldi_lstm_tpu.train import sequence_lattice as jsl
from kaldi_lstm_tpu_torch.io import lattice as tlat
from kaldi_lstm_tpu_torch.io.transition_model import TransitionModel
from kaldi_lstm_tpu_torch.train import sequence_lattice as tsl

TOL = 1e-6


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("tm"), "final.mdl")
    jtm.make_monophone_transition_model(3, 2).dump(path)
    return jtm.TransitionModel.load(path), TransitionModel.load(path)


def random_lattice(seed, num_tids, T=6, width=3):
    """(start, arcs [(src, ilabel, olabel, graph, acoustic, dst)], final
    {state: (graph, acoustic)}) of a random time-synchronous lattice,
    and a numerator path of transition-ids through it."""
    rng = np.random.RandomState(seed)
    frames = [[0]]
    n = 1
    arcs = []
    for t in range(T):
        nxt = list(range(n, n + width))
        n += width
        for dst in nxt:            # every state of frame t+1 is reachable
            src = frames[-1][rng.randint(len(frames[-1]))]
            arcs.append((src, int(rng.randint(1, num_tids)), 0,
                         float(rng.rand()), float(rng.rand()), dst))
        for _ in range(width):     # more arcs, some parallel
            src = frames[-1][rng.randint(len(frames[-1]))]
            dst = nxt[rng.randint(width)]
            arcs.append((src, int(rng.randint(1, num_tids)),
                         int(rng.randint(0, 3)), float(rng.rand()),
                         float(rng.rand()), dst))
        # an epsilon arc inside frame t+1 (lower to higher state id)
        arcs.append((nxt[0], 0, 0, float(rng.rand()), 0.0, nxt[1]))
        frames.append(nxt)
    final = {s: (float(rng.rand()), 0.0) for s in frames[-1]}
    return 0, arcs, final, n


def build(mod, spec):
    start, arcs, final, n = spec
    lat = mod.Lattice()
    for _ in range(n):
        lat.add_state()
    lat.start = start
    for src, il, ol, g, a, dst in arcs:
        lat.arcs[src].append(mod.LatticeArc(il, ol, g, a, dst))
    lat.final = dict(final)
    return lat


def numerator(spec, seed, T=6):
    """A transition-id per frame: the labels of a random emitting path."""
    rng = np.random.RandomState(seed + 100)
    _, arcs, _, _ = spec
    out = []
    for t in range(T):
        emitting = [a for a in arcs if a[1] and
                    (a[5] - 1) // 3 == t]
        out.append(emitting[rng.randint(len(emitting))][1])
    return np.asarray(out, np.int32)


def snapshot(lat):
    return [(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost, a.dst)
            for arcs in lat.arcs for a in arcs], dict(lat.final)


def case(models, seed):
    j_tm, t_tm = models
    num_tids = len(j_tm.id2pdf)
    spec = random_lattice(seed, num_tids)
    loglik = np.random.RandomState(seed).randn(6, j_tm.num_pdfs) \
        .astype(np.float32)
    return (build(jlat, spec), build(tlat, spec), numerator(spec, seed),
            loglik)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    {},
    {"acoustic_scale": 1.0, "drop_frames": False},
    {"acoustic_scale": 0.5, "lm_scale": 0.7, "old_acoustic_scale": 0.3},
])
def test_mmi_errors_match_jax(models, seed, kw):
    j_lat, t_lat, tids, ll = case(models, seed)
    before = snapshot(t_lat)
    j = jsl.mmi_errors(j_lat, models[0], tids, ll, **kw)
    t = tsl.mmi_errors(t_lat, models[1], tids, ll, **kw)
    assert snapshot(t_lat) == before
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=TOL)
    assert t[1].dtype == np.float32 and t[1].shape == j[1].shape
    assert np.abs(j[1]).sum() > 0.1       # gamma spread over the arcs
    np.testing.assert_allclose(t[1], j[1], rtol=0, atol=TOL)
    assert t[2:] == j[2:]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    {"criterion": "smbr"},
    {"criterion": "mpe", "acoustic_scale": 1.0},
    {"criterion": "mpe", "silence_phones": frozenset({1})},
    {"criterion": "smbr", "silence_phones": frozenset({1, 2}),
     "one_silence_class": True, "lm_scale": 0.5},
])
def test_mpe_errors_match_jax(models, seed, kw):
    j_lat, t_lat, tids, ll = case(models, seed)
    before = snapshot(t_lat)
    j_ea, j_diff = jsl.mpe_errors(j_lat, models[0], tids, ll, **kw)
    t_ea, t_diff = tsl.mpe_errors(t_lat, models[1], tids, ll, **kw)
    assert snapshot(t_lat) == before
    np.testing.assert_allclose(t_ea, j_ea, rtol=0, atol=TOL)
    np.testing.assert_allclose(t_diff, j_diff, rtol=0, atol=TOL)
    assert np.abs(j_diff).sum() > 1e-3


def test_compact_lattice_input_matches_jax(models):
    """A CompactLattice (as the lattice readers return them) goes through
    as_raw_lattice / compact_to_lattice in both packages."""
    j_lat, t_lat, tids, ll = case(models, 3)
    j_c, t_c = jlat.lattice_to_compact(j_lat), tlat.lattice_to_compact(t_lat)
    j = jsl.mmi_errors(j_c, models[0], tids, ll)
    t = tsl.mmi_errors(t_c, models[1], tids, ll)
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(t[1], j[1], rtol=0, atol=TOL)
    j_ea, j_diff = jsl.mpe_errors(j_c, models[0], tids, ll)
    t_ea, t_diff = tsl.mpe_errors(t_c, models[1], tids, ll)
    np.testing.assert_allclose(t_ea, j_ea, rtol=0, atol=TOL)
    np.testing.assert_allclose(t_diff, j_diff, rtol=0, atol=TOL)


def test_non_synchronous_lattice_refused_like_jax(models):
    spec = (0, [(0, 1, 0, 0.0, 0.0, 2), (0, 1, 0, 0.0, 0.0, 1),
                (1, 2, 0, 0.0, 0.0, 2)], {2: (0.0, 0.0)}, 3)
    ll = np.zeros((2, models[0].num_pdfs), np.float32)
    for mod, sl, tm in ((jlat, jsl, models[0]), (tlat, tsl, models[1])):
        with pytest.raises(ValueError, match="not time-synchronous"):
            sl.mmi_errors(build(mod, spec), tm, np.asarray([1, 2]), ll)
        with pytest.raises(ValueError, match="not time-synchronous"):
            sl.mpe_errors(build(mod, spec), tm, np.asarray([1, 2]), ll)


def test_as_raw_lattice_copy_is_deep(models):
    _, t_lat, _, _ = case(models, 4)
    cp = tsl.as_raw_lattice(t_lat, copy=True)
    cp.arcs[0][0].acoustic_cost = 123.0
    cp.final[next(iter(cp.final))] = (9.0, 9.0)
    assert t_lat.arcs[0][0].acoustic_cost != 123.0
    assert (9.0, 9.0) not in t_lat.final.values()
