"""The port's tensor-parallel senone loss (parallel/xent_tp.py) on gloo
ranks, held to the JAX package's `make_tp_fused_xent` on the 8-device
virtual CPU mesh (tests/conftest.py) and to the port's single-rank
`fused_affine_xent`, plus the plain K3/K4 versions' handling of a target
id outside the classes (the TP loss hands a shard such ids).

Worlds of 2 and 4 ranks (meshes 1x2, 2x2 and 1x4) run in subprocesses
(tests/torch_dist_worker.py), started together once for the module.
Tolerances: loss and statistics 1e-5 relative, gradients 1e-5 absolute
and relative (float32); the argmax and the frame count exactly.
"""

import functools
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.parallel import make_mesh as j_make_mesh
from kaldi_lstm_tpu.parallel.xent_tp import make_tp_fused_xent as j_tp
from kaldi_lstm_tpu.train.loss import masked_xent_loss as j_xent
from kaldi_lstm_tpu_torch.ops import xent_affine as xa


def _worker():
    path = pathlib.Path(__file__).with_name("torch_dist_worker.py")
    spec = importlib.util.spec_from_file_location("_torch_dist_worker",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


N, R = 24, 10
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(K, seed=0, bias=0.0):
    rng = np.random.RandomState(seed)
    r = rng.randn(N, R).astype(np.float32)
    w = (rng.randn(K, R) * 0.3).astype(np.float32)
    b = (rng.randn(K) * 0.1 + bias).astype(np.float32)
    ids = rng.randint(0, K, (N, 2)).astype(np.int32)
    tw = rng.rand(N, 2).astype(np.float32)
    tw = (tw / tw.sum(-1, keepdims=True)).astype(np.float32)
    mask = (rng.rand(N) > 0.2).astype(np.float32)
    return r, w, b, ids, tw, mask


def _ties():
    """All logits equal: the first class is the argmax of every frame."""
    K = 36
    z = np.zeros
    return (z((N, R), np.float32), z((K, R), np.float32), z(K, np.float32),
            z((N, 1), np.int32), np.ones((N, 1), np.float32),
            np.ones(N, np.float32))


CASES = {
    "parity": _inputs(36),
    # 34 classes over 4 shards: 9, 9, 8, 8 (the unequal split)
    "uneven": _inputs(34, seed=1),
    "ties": _ties(),
    # exp(bias) overflows float32 (the lse guard's case)
    "bias": _inputs(36, seed=2, bias=200.0),
}
MESHES = [(1, 2), (2, 2), (1, 4)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = _worker()
    arrays = {f"{c}_{k}": v for c, vals in CASES.items()
              for k, v in zip(("r", "w", "b", "ids", "tw", "mask"), vals)}
    runs = {}
    for D, M in MESHES:
        work = tmp_path_factory.mktemp(f"tp{D}x{M}")
        np.savez(work / "tp_in.npz", **arrays)
        (work / "spec.json").write_text(json.dumps(
            {"mesh": [D, M], "cases": list(CASES)}))
        runs[(D, M)] = (work, w.start_world("tp", D * M, str(work)))
    out = {}
    for key, (work, procs) in runs.items():
        w.finish_world(procs)
        out[key] = [dict(np.load(work / f"out_{r}.npz"))
                    for r in range(key[0] * key[1])]
    return out


def _assemble(ranks, D, M, tag):
    """Global (aux, dr, dw, db) from the ranks' parts: statistics and
    dW/db summed over the data ranks, dr stacked over them, dW/db
    stacked over the model ranks; the model ranks of a data position
    must agree bitwise on aux and dr."""
    by = {(int(o["rank"][1]), int(o["rank"][2])): o for o in ranks}
    for d in range(D):
        for m in range(1, M):
            for k in ("aux", "dr"):
                np.testing.assert_array_equal(by[(d, m)][f"{tag}_{k}"],
                                              by[(d, 0)][f"{tag}_{k}"])
    aux = sum(by[(d, 0)][f"{tag}_aux"] for d in range(D))
    dr = np.concatenate([by[(d, 0)][f"{tag}_dr"] for d in range(D)])
    dw = np.concatenate([sum(by[(d, m)][f"{tag}_dw"] for d in range(D))
                         for m in range(M)])
    db = np.concatenate([sum(by[(d, m)][f"{tag}_db"] for d in range(D))
                         for m in range(M)])
    return aux, dr, dw, db


def _port_single(case):
    """The port's single-rank fused loss on the whole layer."""
    r, w, b, ids, tw, mask = (torch.tensor(a) for a in CASES[case])
    for t in (r, w, b):
        t.requires_grad_(True)
    loss, aux = xa.fused_affine_xent(r, w, b, ids, tw, mask)
    grads = torch.autograd.grad(loss, (r, w, b))
    return (np.array([float(v) for v in aux]),
            *(g.numpy() for g in grads))


@functools.lru_cache(maxsize=None)
def _jax(case, D, M):
    """The JAX package's TP loss on a DxM mesh of the virtual devices
    (interpret mode), or, for classes the model axis cannot split evenly
    (which the JAX TP loss refuses), its logits-based loss."""
    r, w, b, ids, tw, mask = (jnp.asarray(a) for a in CASES[case])
    if w.shape[0] % M == 0:
        fn = j_tp(j_make_mesh(data=D, model=M), interpret=True)
    else:
        def fn(r, w, b, ids, tw, mask):
            return j_xent(r @ w.T + b, ids, tw, mask)
    (_, aux), grads = jax.jit(jax.value_and_grad(
        fn, argnums=(0, 1, 2), has_aux=True))(r, w, b, ids, tw, mask)
    return (np.array([float(v) for v in aux]),
            *(np.asarray(g) for g in grads))


@pytest.mark.parametrize("fused", [1, 0])
@pytest.mark.parametrize("case", ["parity", "uneven"])
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_loss_matches_jax_and_single_rank(worlds, mesh, case, fused):
    D, M = mesh
    got = _assemble(worlds[mesh], D, M, f"{case}_{fused}")
    for ref in (_jax(case, D, M), _port_single(case)):
        np.testing.assert_allclose(got[0][[0, 1]], ref[0][[0, 1]],
                                   rtol=1e-5)
        assert got[0][2] == ref[0][2] and got[0][3] == ref[0][3]
        for a, e in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(a, e, **TOL)


@pytest.mark.parametrize("fused", [1, 0])
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_argmax_ties_take_the_first_class(worlds, mesh, fused):
    """Equal maxima in every shard: the FIRST (lowest-index) class wins,
    so every frame with target 0 counts as correct, as in the JAX
    package (tests/test_xent_tp.py)."""
    D, M = mesh
    aux = _assemble(worlds[mesh], D, M, f"ties_{fused}")[0]
    assert aux[2] == N and aux[3] == N
    if mesh == (1, 4):  # the JAX test's mesh
        assert int(_jax("ties", D, M)[0][2]) == N


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_large_bias_stays_finite(worlds, mesh):
    """A bias of 200 overflows exp(z) in float32. The port pads no frame
    rows, so its TP loss and gradients equal the single-rank loss; the
    JAX TP path pads its rows with lse 0, where exp(bias - 0) overflows
    and inf * 0 poisons dW/db (the caveat ROADMAP C names)."""
    D, M = mesh
    got = _assemble(worlds[mesh], D, M, "bias_1")
    ref = _port_single("bias")
    assert all(np.all(np.isfinite(g)) for g in got)
    np.testing.assert_allclose(got[0][[0, 1]], ref[0][[0, 1]], rtol=1e-5)
    for a, e in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a, e, **TOL)
    if mesh == (1, 2):
        j = _jax("bias", D, M)
        assert not (np.all(np.isfinite(j[2])) and np.all(np.isfinite(j[3])))


def test_plain_versions_skip_ids_outside_the_classes():
    """K3's and K4's plain versions give an id outside [0, K) no class,
    as the CUDA kernels skip it; before the TP port, torch.gather and
    scatter_add_ raised on id -1. The result equals dropping the entry
    (its weight still counts in wtot, as the TP backward passes it)."""
    r, w, b, ids, tw, _ = (torch.tensor(a) for a in _inputs(12, seed=3))
    bad = ids.clone()
    bad[::3, 1] = -1
    bad[1::5, 0] = 12   # one past the last class
    kept = torch.where((bad >= 0) & (bad < 12), tw, torch.zeros_like(tw))
    safe = bad.clamp(0, 11)
    lse, picked, amax, aidx = xa.xent_fwd_plain(r, w, b, bad, tw)
    ref = xa.xent_fwd_plain(r, w, b, safe, kept)
    for a, e in zip((lse, picked, amax, aidx), ref):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    chunked = xa.xent_fwd_chunked_plain(r, w, b, bad, tw, chunk=5)
    torch.testing.assert_close(picked, chunked[1], rtol=1e-6, atol=1e-6)
    scale = torch.ones(N)
    wtot = tw.sum(-1)
    got = xa.xent_bwd_plain(r, w, b, bad, tw, lse, scale, wtot)
    want = xa.xent_bwd_plain(r, w, b, safe, kept, lse, scale, wtot)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
