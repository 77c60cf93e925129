"""The port's two-layer wavefront ops in bf16 (`ops/lstm_stack.py` with
`compute_dtype=torch.bfloat16`: K6 training forward, K7 inference
forward) against the JAX package's `_fwd2_call` / `_infer2_call` run in
interpret mode under `set_matmul_dtype(jnp.bfloat16)`, where `_prep2`
casts both layers' weights and the kernels cast x, r and tanh(c) o
before each dot. The same numpy-made weights, inputs and nonzero initial
states go to both, at every time block.

Tolerance: tests/test_torch_bf16.py's rule (`assert_bf16_close`), tensor
by tensor: the RMS error against the JAX bf16 kernel at most a tenth of
the RMS distance between the JAX kernel in bf16 and in float32 on the
same inputs. The JAX dtype is a module global, restored to None in a
`finally` after every bf16 call. The `gpu`-marked tests hold the bf16
CUDA kernels to their bf16 plain versions on the card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.models.components import set_matmul_dtype
from kaldi_lstm_tpu.ops import lstm_stack_pallas as w2
from kaldi_lstm_tpu_torch.ops import counts
from kaldi_lstm_tpu_torch.ops import lstm_stack as ls

from test_torch_bf16 import SHARE, assert_bf16_close, rms
from test_torch_lstm_stack import (
    CLIP,
    C,
    R,
    S,
    T,
    _gates,
    _jax_prep,
    make,
)

BF16 = torch.bfloat16
NAMES = ("gifo1", "c1", "r1", "gifo2", "c2", "r2")


def _jax_fwd2(jx, tb, dtype):
    """The JAX K6 in interpret mode under set_matmul_dtype(dtype),
    unpadded as the port returns it (gifo in bf16 under bf16, as
    lstm_scan_pallas keeps it)."""
    set_matmul_dtype(dtype)
    try:
        d, ops = _jax_prep(jx, tb)
        out = w2._fwd2_call(*ops, st=d.st, tb=tb, cell_clip=CLIP,
                            gifo_dtype=dtype or jnp.float32, interpret=True)
    finally:
        set_matmul_dtype(None)
    g1, c1, r1, g2, c2, r2 = (np.asarray(a, np.float32) for a in out)
    return (_gates(g1, d, 0), c1[:T, :S, :C], r1[:T, :S, :R],
            _gates(g2, d, tb), c2[tb:tb + T, :S, :C], r2[tb:tb + T, :S, :R])


def _jax_infer2(jx, tb, dtype):
    set_matmul_dtype(dtype)
    try:
        d, ops = _jax_prep(jx, tb)
        r2, c1T, r1T, c2T = w2._infer2_call(*ops, st=d.st, tb=tb,
                                            cell_clip=CLIP, interpret=True)
    finally:
        set_matmul_dtype(None)
    r2 = np.asarray(r2)[tb:tb + T, :S, :R]
    return (r2, np.asarray(c1T)[:S, :C], np.asarray(r1T)[:S, :R],
            np.asarray(c2T)[:S, :C], r2[T - 1])


@pytest.mark.parametrize("tb", [5, 4, 2, 1])
def test_fwd2_bf16_plain_matches_jax_interpret(tb):
    jx, port = make(seed=60 + tb)
    ls.reset_counts()
    got = ls.lstm_stack_fwd2(*port, CLIP, tb=tb, compute_dtype=BF16)
    assert (ls.PLAIN_CALLS, ls.FWD2_LAUNCHES, ls.FWD2_BF16_LAUNCHES) == \
        (1, 0, 0)
    assert got[0].dtype == got[3].dtype == BF16
    want = _jax_fwd2(jx, tb, jnp.bfloat16)
    want32 = _jax_fwd2(jx, tb, None)
    for name, a, b, c in zip(NAMES, got, want, want32):
        assert_bf16_close(name, a.float().numpy(), b, c)
    assert bool((got[1].abs() == CLIP).any()), "the clip never engaged"


@pytest.mark.parametrize("tb", [5, 4, 2, 1])
def test_infer2_bf16_plain_matches_jax_interpret(tb):
    jx, port = make(seed=70 + tb)
    ls.reset_counts()
    r2, f1, f2 = ls.lstm_stack_infer2(*port, CLIP, tb=tb, compute_dtype=BF16)
    assert (ls.PLAIN_CALLS, ls.INFER2_LAUNCHES, ls.INFER2_BF16_LAUNCHES) \
        == (1, 0, 0)
    want = _jax_infer2(jx, tb, jnp.bfloat16)
    want32 = _jax_infer2(jx, tb, None)
    got = (r2, f1.c, f1.r, f2.c, f2.r)
    for name, a, b, c in zip(("r2", "c1T", "r1T", "c2T", "r2T"), got, want,
                             want32):
        assert_bf16_close(name, a.numpy(), b, c)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.float64, "bf16"])
def test_compute_dtype_other_than_bf16_is_refused(dtype):
    _, port = make(seed=80)
    ls.reset_counts()
    with pytest.raises(TypeError):
        ls.lstm_stack_fwd2(*port, CLIP, tb=5, compute_dtype=dtype)
    with pytest.raises(TypeError):
        ls.lstm_stack_infer2(*port, CLIP, tb=5, compute_dtype=dtype)
    assert ls.PLAIN_CALLS == 0


@pytest.mark.parametrize("phases", ["both", "l1", "l2"])
@pytest.mark.parametrize("dtype", [None, BF16])
def test_plain_calls_count_no_launch(phases, dtype):
    """On the CPU a call takes the plain version: PLAIN_CALLS counts it
    and no launch counter of either precision moves."""
    _, port = make(seed=81)
    counts.reset_counts()
    ls.lstm_stack_fwd2(*port, CLIP, tb=4, phases=phases, compute_dtype=dtype)
    if phases == "both":
        ls.lstm_stack_infer2(*port, CLIP, tb=4, compute_dtype=dtype)
    snap = counts.snapshot_counts()
    assert snap["plain.lstm_stack"] == (2 if phases == "both" else 1)
    assert not any(v for k, v in snap.items() if not k.startswith("plain."))


@pytest.mark.parametrize("phases", ["l1", "l2"])
def test_bf16_phases_live_layer_is_the_serial_layer(phases):
    """The ablation in bf16: the live layer's residuals are K1's bf16
    plain version over that layer (layer 2 over r1 = 0 with "l2")."""
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    _, (p1, p2, x, s1, s2) = make(seed=82)
    got = ls.lstm_stack_fwd2(p1, p2, x, s1, s2, CLIP, tb=5, phases=phases,
                             compute_dtype=BF16)
    if phases == "l1":
        want = lt.lstm_fwd_residuals_plain(p1, x, s1.c, s1.r,
                                           cell_clip=CLIP, compute_dtype=BF16)
        live, dead = got[:3], got[3:]
    else:
        want = lt.lstm_fwd_residuals_plain(p2, torch.zeros(T, S, R), s2.c,
                                           s2.r, cell_clip=CLIP,
                                           compute_dtype=BF16)
        live, dead = got[3:], got[:3]
    for a, b in zip(live, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(not t.any() for t in dead)


def test_bench_wavefront_cpu_rehearsal_runs_f32_and_bf16_rows(capsys):
    """`tools/bench_wavefront --device cpu` rehearses its A/B on the plain
    versions: the serial and wavefront rows in f32 and then in bf16, as
    the reference's bench, with every call a plain one."""
    from kaldi_lstm_tpu_torch.tools import bench_wavefront as bw
    counts.reset_counts()
    assert bw.main(["2", "1", "1", "ab", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for prec in ("f32", "bf16"):
        assert f"serial fwd {prec} (K1 x 2)" in out
        assert f"serial infer {prec} (K5 x 2)" in out
        for tb in bw.FWD_TBS:
            assert f"wave   fwd {prec} tb{tb}" in out
        for tb in bw.INFER_TBS:
            assert f"wave   infer {prec} tb{tb}" in out
    assert "not run" not in out
    assert out.count("wavefront speedup") == 2 * (len(bw.FWD_TBS)
                                                  + len(bw.INFER_TBS))
    calls = bw.calls_per_bench(1, 1)
    snap = counts.snapshot_counts()
    assert snap["plain.lstm_stack"] == 2 * calls * (len(bw.FWD_TBS)
                                                    + len(bw.INFER_TBS))
    assert not any(v for k, v in snap.items() if not k.startswith("plain."))


@pytest.mark.parametrize("variant", ["nobar", "nogates", "noproj",
                                     "nofma", "l1only", "buf32k",
                                     "unroll4"])
def test_bench_stack_parts_edits_apply_to_the_sources(variant):
    """Each timing probe of `tools/bench_stack_parts` is one textual edit
    of the committed K7 source; every edit still finds its text."""
    from kaldi_lstm_tpu_torch.tools import bench_stack_parts as bp
    edited = bp.variant_sources(variant)
    assert edited
    for fname, src in edited.items():
        with open(os.path.join(bp._build.CSRC_DIR, fname)) as fh:
            assert src != fh.read()


def test_bench_stack_parts_needs_a_card(monkeypatch):
    from kaldi_lstm_tpu_torch.tools import bench_stack_parts as bp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bp.main(["8,10"]) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); run "
                    "on the card with: python -m pytest -m gpu "
                    "tests/test_torch_lstm_stack_bf16.py")
    return torch.device("cuda")


def _f64(port):
    p1, p2, x, s1, s2 = port
    return (type(p1)(*(t.double() for t in p1)),
            type(p2)(*(t.double() for t in p2)), x.double(),
            type(s1)(*(t.double() for t in s1)),
            type(s2)(*(t.double() for t in s2)))


def _card_close(name, got, ref, ref32, ref64):
    """chip_smoke.py's bf16 rule on the card: RMS error within max(a
    tenth of the bf16-vs-f32 distance, twice the plain version's own
    f32-vs-f64 noise), the flips of bf16 roundings that two f32 sum
    orders take apart being carried by both recurrences."""
    got, ref, ref32, ref64 = (np.asarray(t.double().cpu()) for t in
                              (got, ref, ref32, ref64))
    err, dist, noise = rms(got - ref), rms(ref - ref32), rms(ref64 - ref)
    assert np.isfinite(got).all(), name
    assert dist > 1e-6 * rms(ref), name
    assert err <= max(SHARE * dist, 2.0 * noise), \
        f"{name}: error {err:.3e}, distance {dist:.3e}, noise {noise:.3e}"


# test_torch_bf16.py's K1/K2 card shape: T=8, where a flipped bf16
# rounding is not carried over a long recurrence (chip_smoke.py's phase 3d
# holds the full-width T=20 case)
CARD = dict(s=64, t=8, i=40, c=200, r=64)


@pytest.mark.gpu
@pytest.mark.parametrize("tb", [8, 4, 2, 1])
def test_cuda_bf16_fwd2_and_infer2_match_plain(cuda_device, tb):
    _, port = make(seed=90 + tb, **CARD, device=cuda_device)
    t = CARD["t"]
    ls.reset_counts()
    got = ls.lstm_stack_fwd2(*port, CLIP, tb=tb, compute_dtype=BF16)
    r2, f1, f2 = ls.lstm_stack_infer2(*port, CLIP, tb=tb, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert (ls.FWD2_BF16_LAUNCHES, ls.FWD2_LAUNCHES) == \
        (ls.wavefront_launches(t, tb), 0)
    assert (ls.INFER2_BF16_LAUNCHES, ls.INFER2_LAUNCHES) == \
        (ls.wavefront_launches(t, tb, kernel="infer2"), 0)
    assert ls.PLAIN_CALLS == 0
    assert got[0].dtype == got[3].dtype == BF16
    want = ls.lstm_stack_fwd2_plain(*port, CLIP, compute_dtype=BF16)
    want32 = ls.lstm_stack_fwd2_plain(*port, CLIP)
    want64 = ls.lstm_stack_fwd2_plain(*_f64(port), CLIP, compute_dtype=BF16)
    for name, a, b, c, d in zip(NAMES, got, want, want32, want64):
        _card_close(f"K6 {name}", a, b, c, d)
    ref = ls.lstm_stack_infer2_plain(*port, CLIP, compute_dtype=BF16)
    ref32 = ls.lstm_stack_infer2_plain(*port, CLIP)
    ref64 = ls.lstm_stack_infer2_plain(*_f64(port), CLIP, compute_dtype=BF16)
    for name, a, pick in (("r2", r2, lambda o: o[0]),
                          ("c1T", f1.c, lambda o: o[1].c),
                          ("r1T", f1.r, lambda o: o[1].r),
                          ("c2T", f2.c, lambda o: o[2].c),
                          ("r2T", f2.r, lambda o: o[2].r)):
        _card_close(f"K7 {name}", a, pick(ref), pick(ref32), pick(ref64))


@pytest.mark.gpu
@pytest.mark.parametrize("phases", ["l1", "l2"])
def test_cuda_bf16_phases_count_and_live_layer(cuda_device, phases):
    _, port = make(seed=95, **CARD, device=cuda_device)
    ls.reset_counts()
    got = ls.lstm_stack_fwd2(*port, CLIP, tb=4, phases=phases,
                             compute_dtype=BF16)
    torch.cuda.synchronize()
    assert ls.FWD2_BF16_LAUNCHES == ls.wavefront_launches(CARD["t"], 4,
                                                          phases)
    want = ls.lstm_stack_fwd2_plain(*port, CLIP, phases=phases,
                                    compute_dtype=BF16)
    want32 = ls.lstm_stack_fwd2_plain(*port, CLIP, phases=phases)
    want64 = ls.lstm_stack_fwd2_plain(*_f64(port), CLIP, phases=phases,
                                      compute_dtype=BF16)
    live = slice(0, 3) if phases == "l1" else slice(3, 6)
    for name, a, b, c, d in zip(NAMES[live], got[live], want[live],
                                want32[live], want64[live]):
        _card_close(f"K6 {phases} {name}", a, b, c, d)


@pytest.mark.gpu
def test_cuda_bf16_ragged_shape(cuda_device):
    """4-byte copies (I=37, R=130) and ragged tiles, T=2: nothing carries
    a flip, so the tenth alone holds."""
    _, port = make(seed=96, s=3, t=2, i=37, c=200, r=130, device=cuda_device)
    got = ls.lstm_stack_fwd2(*port, CLIP, tb=1, compute_dtype=BF16)
    r2 = ls.lstm_stack_infer2(*port, CLIP, tb=1, compute_dtype=BF16)[0]
    want = ls.lstm_stack_fwd2_plain(*port, CLIP, compute_dtype=BF16)
    want32 = ls.lstm_stack_fwd2_plain(*port, CLIP)
    for name, a, b, c in zip(NAMES, got, want, want32):
        assert_bf16_close(name, a.float().cpu().numpy(),
                          b.float().cpu().numpy(), c.float().cpu().numpy())
    ref = ls.lstm_stack_infer2_plain(*port, CLIP, compute_dtype=BF16)[0]
    ref32 = ls.lstm_stack_infer2_plain(*port, CLIP)[0]
    assert_bf16_close("K7 r2", r2.cpu().numpy(), ref.cpu().numpy(),
                      ref32.cpu().numpy())
