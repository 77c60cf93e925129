"""The port's sharded step (parallel/sharded_trainer.py) on gloo ranks at
meshes (D, M) = (2, 1), (1, 2) and (2, 2), held to the JAX package's
sharded step on the 8-device virtual CPU mesh over the same global
batches: plain and grouped steps, L2 with max-norm (JAX
tests/test_sharding.py:65,100), cross-validation statistics, a senone
count the model axis cannot split evenly (which the JAX package refuses
to place, so that case is held to its single-device step), and a global
stream count the data axis cannot split, which fails fast.

Each mesh's ranks run in subprocesses (tests/torch_dist_worker.py),
started together once for the module. Tolerance: parameters 1e-5
absolute and relative (float32) against the JAX package; the ranks'
gathered parameters bit-identical; the grouped step bit-identical to the
plain steps.
"""

import functools
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_lstm_tpu.models import Nnet as JNnet
from kaldi_lstm_tpu.parallel import MeshPlan as JPlan
from kaldi_lstm_tpu.parallel import make_mesh as j_make_mesh
from kaldi_lstm_tpu.parallel import make_sharded_train_step as j_sharded
from kaldi_lstm_tpu.train import TrainOptions as JOpts
from kaldi_lstm_tpu.train import init_momentum as j_init_momentum
from kaldi_lstm_tpu.train import make_train_step as j_make_step


def _worker():
    path = pathlib.Path(__file__).with_name("torch_dist_worker.py")
    spec = importlib.util.spec_from_file_location("_torch_dist_worker",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _proto(K, max_norm=""):
    return f"""<NnetProto>
<LstmProjectedStreams> <InputDim> 6 <OutputDim> 8 <CellDim> 16 <ParamScale> 0.1 <NumStream> 8
<AffineTransform> <InputDim> 8 <OutputDim> {K} <ParamStddev> 0.1 {max_norm}
<Softmax> <InputDim> {K} <OutputDim> {K}
</NnetProto>
"""


S, T, NB = 8, 5, 3
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = [(2, 1), (1, 2), (2, 2)]
MODELS = {"k32": _proto(32), "k32mn": _proto(32, "<MaxNorm> 0.5"),
          "k33": _proto(33)}
PLAIN = dict(learn_rate=0.05, momentum=0.9)
CASES = [
    dict(name="plain", model="k32", opts=dict(PLAIN, fused_xent=True)),
    dict(name="grouped", model="k32", opts=dict(PLAIN, fused_xent=True),
         group=True),
    dict(name="l2_maxnorm", model="k32mn",
         opts=dict(PLAIN, l2_penalty=0.01)),
    dict(name="uneven", model="k33", opts=PLAIN),
    dict(name="uneven_fused", model="k33",
         opts=dict(PLAIN, fused_xent=True)),
    dict(name="cv", model="k32", opts=PLAIN, cv=True),
]


def _batches(K, seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(NB, S, T, 6).astype(np.float32)
    ids = rng.randint(0, K, (NB, S, T, 1)).astype(np.int32)
    w = np.ones((NB, S, T, 1), np.float32)
    mask = np.ones((NB, S, T), np.float32)
    mask[:, 0, 3:] = 0
    mask[2, 5, :] = 0
    flags = np.zeros((NB, S), np.int32)
    flags[1, 1] = 1
    return {"feats": feats, "ids": ids, "w": w, "mask": mask,
            "flags": flags}


BATCHES = {"k32": _batches(32, 0), "k32mn": _batches(32, 0),
           "k33": _batches(33, 1)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    models = {}
    for name, proto in MODELS.items():
        nnet, params = JNnet.init_from_proto(proto, jax.random.PRNGKey(0))
        path = str(d / f"{name}.nnet")
        nnet.write(path, params)
        models[name] = path
    arrays = {f"{m}_{k}": v for m, b in BATCHES.items()
              for k, v in b.items()}
    cases = [dict(c, model=models[c["model"]], batches=c["model"])
             for c in CASES]
    w = _worker()
    runs = {}
    for D, M in MESHES:
        work = tmp_path_factory.mktemp(f"step{D}x{M}")
        np.savez(work / "step_in.npz", **arrays)
        (work / "spec.json").write_text(json.dumps(
            {"mesh": [D, M], "cases": cases}))
        runs[(D, M)] = (work, w.start_world("step", D * M, str(work)))
    out = {}
    for key, (work, procs) in runs.items():
        w.finish_world(procs)
        out[key] = [dict(np.load(work / f"out_{r}.npz"))
                    for r in range(key[0] * key[1])]
    return models, out


@functools.lru_cache(maxsize=None)
def _jax(model_path, case_name, D, M):
    """The JAX package's result for a case: its sharded step on a DxM
    mesh, or its single-device step where the mesh cannot place the
    senone layer (K % M != 0). Returns (flat params, last aux)."""
    case = next(c for c in CASES if c["name"] == case_name)
    nnet, params = JNnet.read(model_path)
    opts = JOpts(**{k: v for k, v in case["opts"].items()
                    if k != "fused_xent"})
    cv = case.get("cv", False)
    K = nnet.components[-2].output_dim
    b = BATCHES[case["model"]]
    if K % M == 0:
        plan = JPlan(j_make_mesh(data=D, model=M), nnet)
        states = nnet.init_states(S)
        step = j_sharded(nnet, opts, plan, crossvalidate=cv,
                         params_example=params, states_example=states)
        params = plan.place_params(params)
        opt = j_init_momentum(params)
        states = plan.place_states(states)

        def place(i):
            return plan.place_batch(*(b[k][i] for k in
                                      ("feats", "ids", "w", "mask",
                                       "flags")))
    else:
        step = j_make_step(nnet, opts, crossvalidate=cv)
        opt = j_init_momentum(params)
        states = nnet.init_states(S)

        def place(i):
            return tuple(jnp.asarray(b[k][i]) for k in
                         ("feats", "ids", "w", "mask", "flags"))
    for i in range(NB):
        params, opt, states, aux = step(params, opt, states, (), *place(i),
                                        jnp.float32(opts.learn_rate))
    flat = np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree_util.tree_leaves(params)])
    return flat, np.array([float(v) for v in aux])


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_step_matches_jax(setup, mesh, case):
    models, out = setup
    ranks = out[mesh]
    c = next(c for c in CASES if c["name"] == case)
    for o in ranks[1:]:  # every rank gathers the same parameters
        np.testing.assert_array_equal(o[f"{case}_params"],
                                      ranks[0][f"{case}_params"])
        np.testing.assert_array_equal(o[f"{case}_aux"],
                                      ranks[0][f"{case}_aux"])
    j_params, j_aux = _jax(models[c["model"]],
                           "plain" if case == "grouped" else case, *mesh)
    np.testing.assert_allclose(ranks[0][f"{case}_params"], j_params, **TOL)
    np.testing.assert_allclose(ranks[0][f"{case}_aux"][[0, 1]],
                               j_aux[[0, 1]], rtol=1e-5)
    assert ranks[0][f"{case}_aux"][2] == j_aux[2]
    assert ranks[0][f"{case}_aux"][3] == j_aux[3]


@pytest.mark.parametrize("mesh", MESHES)
def test_grouped_sharded_step_is_the_plain_steps(setup, mesh):
    """The grouped sharded step is a loop of the plain sharded steps:
    the same parameters, bit for bit."""
    for o in setup[1][mesh]:
        np.testing.assert_array_equal(o["grouped_params"], o["plain_params"])
        np.testing.assert_array_equal(o["grouped_aux"], o["plain_aux"])


@pytest.mark.parametrize("mesh", MESHES)
def test_senone_shards_split_the_layer(setup, mesh):
    """With a model axis each rank holds only its rows of the senone
    affine: its flat parameters are shorter than the whole tree's by the
    other shards' rows."""
    D, M = mesh
    for o in setup[1][mesh]:
        whole, shard = o["plain_params"].size, o["plain_shard"].size
        other_rows = 32 - 32 // M
        assert whole - shard == other_rows * (8 + 1)


@pytest.mark.parametrize("mesh", [m for m in MESHES if m[0] > 1])
def test_indivisible_streams_fail_fast(setup, mesh):
    for o in setup[1][mesh]:
        assert "divisible" in str(o["indivisible"])
