"""The model of the H100 tensor core's bf16 -> f32 sums
(`kaldi_lstm_tpu_torch/ops/tc_sum.py`) and the bf16 kernels' tc-exact
mirrors, on the CPU.

* `tc_dot` against sums worked out by hand: exact wherever every product
  and partial sum is representable, the card's cut and rounding on
  crafted vectors after Fasi, Higham, Mikaitis and Pranesh (PeerJ CS
  7:e330, 2021), and within the error bound that its parameters imply
  on random vectors (a hypothesis property);
* `tc_matmul` against `_mma_tile` (one slice a run) and against its own
  runs added in f32;
* `find_params` recovering the parameters of probes that run the model
  with other parameters; the probes' plain versions on CPU tensors;
* each `tc=True` mirror (K1, K2, K5, K6, K7 in bf16) equal to its IEEE
  mirror bit for bit on inputs whose every sum is exact, and against the
  JAX package's bf16 kernels in interpret mode by tests/test_torch_bf16.py's
  rule: RMS error at most a tenth of the JAX kernel's bf16-vs-f32
  distance.

The card's own runs of the probes and the kernels against these mirrors
are the `gpu` tests of tests/test_torch_bf16_tc.py and
tests/test_torch_lstm_stack_bf16.py, and chip_smoke.py's phases 3d and
3e.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kaldi_lstm_tpu.models.components import set_matmul_dtype
from kaldi_lstm_tpu_torch.ops import lstm_infer as li
from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.ops import tc_sum as ts
from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState

from test_torch_bf16 import (
    BF16,
    LSTM_NAMES,
    assert_bf16_close,
    jax_lstm,
    lstm_inputs,
    t,
)
from test_torch_lstm_stack import make
from test_torch_stack_bf16_tc import CLIP, _jax_fwd2, _jax_infer2

CARD = ts.MMA_M16N8K16_BF16
# the card's parameters and three others the model must handle alike
PARAMS = [CARD, {"block": 8, "align_bits": 27, "rounding": "rn"},
          {"block": 4, "align_bits": 24, "rounding": "rd"},
          {"block": 16, "align_bits": 30, "rounding": "ru"}]
PARAM_IDS = ["card", "b8_a27_rn", "b4_a24_rd", "b16_a30_ru"]
U = 2.0 ** -23      # one f32 ulp at 1


@pytest.fixture(autouse=True)
def reset_jax_dtype():
    yield
    set_matmul_dtype(None)


def _dot(a, b, c=None, **params):
    a = torch.tensor(a, dtype=torch.float64)
    b = torch.tensor(b, dtype=torch.float64)
    c = None if c is None else torch.tensor(c, dtype=torch.float32)
    return float(ts.tc_dot(a, b, c, **(params or CARD)))


# ---------------------------------------------------------------------------
# tc_dot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params", PARAMS, ids=PARAM_IDS)
@pytest.mark.parametrize("K", [1, 16, 37, 64])
def test_tc_dot_is_exact_where_every_sum_is(params, K):
    """Small integers: every product, cut and partial sum is an integer
    far inside every f32 and every alignment, so each model gives the
    exact sum."""
    rng = np.random.RandomState(K)
    a = rng.randint(-8, 9, (50, K)).astype(np.float64)
    b = rng.randint(-8, 9, (50, K)).astype(np.float64)
    c = rng.randint(-100, 101, 50).astype(np.float32)
    got = ts.tc_dot(torch.tensor(a), torch.tensor(b), torch.tensor(c),
                    **params)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), (a * b).sum(1) + c)
    zero = ts.tc_dot(torch.tensor(a), torch.tensor(b), **params)
    assert np.array_equal(zero.numpy(), (a * b).sum(1))


# (name, a, b, c, the card's answer, the exact sum rounded to f32)
CRAFTED = [
    ("three_quarters_ulp_toward_zero", [1.0, U / 2, U / 4], None, None,
     1.0, 1.0 + U),
    ("negative_toward_zero", [-1.0, -U / 2, -U / 4], None, None, -1.0,
     -1.0 - U),
    ("kept_at_align_bits", [1.0, -1.0, 2.0 ** -25], None, None,
     2.0 ** -25, 2.0 ** -25),
    ("cut_past_align_bits", [1.0, -1.0, 2.0 ** -26], None, None, 0.0,
     2.0 ** -26),
    ("fifteen_small_terms_all_cut", [1.0] + [2.0 ** -26] * 15, None, None,
     1.0, 1.0 + 2 * U),
    ("a_new_block_keeps_what_the_first_cuts",
     [1.0, -1.0] + [0.0] * 14 + [2.0 ** -40], None, None, 2.0 ** -40,
     2.0 ** -40),
    ("accumulator_aligns_by_its_own_exponent", [-1.0, 2.0 ** -25], None,
     1.0, 2.0 ** -25, 2.0 ** -25),
    ("product_aligns_by_its_exponent_sum", [1.5, -1.5, 2.0 ** -25],
     [1.5, 1.5, 1.0], None, 2.0 ** -25, 2.0 ** -25),
    ("cut_then_rounded_below_one", [1.0, -(2.0 ** -25 + 2.0 ** -26)], None,
     None, 1.0 - 2.0 ** -24, 1.0 - 2.0 ** -24),
]


@pytest.mark.parametrize("case", CRAFTED, ids=[c[0] for c in CRAFTED])
def test_tc_dot_on_crafted_vectors(case):
    """Fasi et al.'s crafted vectors, answered by hand for the card's
    constants (16 products a block with the accumulator, 25 bits kept
    below the block's largest exponent, the cut and the rounding toward
    zero); beside each, the exact sum rounded to f32 once."""
    _, a, b, c, want, _ = case
    b = b or [1.0] * len(a)
    assert CARD == {"block": 16, "align_bits": 25, "rounding": "rz"}
    assert _dot(a, b, c) == want


def test_crafted_answers_differ_from_a_sum_rounded_once():
    """The crafted vectors that tell the card from a sum rounded once
    (the f64 witness of chip_smoke.py's phase 3d): the last column of
    CRAFTED is that sum, and four of them differ from the card's."""
    differ = []
    for name, a, b, c, want, once in CRAFTED:
        exact = sum(x * y for x, y in zip(a, b or [1.0] * len(a)))
        assert float(np.float32(exact + (c or 0.0))) == once, name
        if once != want:
            differ.append(name)
    assert differ == ["three_quarters_ulp_toward_zero",
                      "negative_toward_zero", "cut_past_align_bits",
                      "fifteen_small_terms_all_cut"]


def _bound(a, b, c, block, align_bits):
    """|tc_dot - exact| <= blocks x 2M x ((block + 1) 2^-align_bits +
    2^-23), M = |c| + sum |a b|: every term and running sum is below 2M,
    so a block's largest exponent E has 2^E <= 2M, its (block + 1) cuts
    lose under 2^(E - align_bits) each and its rounding under an f32 ulp
    of a value below 2M."""
    M = abs(c) + float(np.abs(a * b).sum())
    blocks = max(1, -(-len(a) // block))
    return blocks * 2 * M * ((block + 1) * 2.0 ** -align_bits + 2.0 ** -23)


_bf16_value = st.floats(-1e3, 1e3, allow_nan=False, width=32).map(
    lambda v: float(torch.tensor(v).to(torch.bfloat16)))


@pytest.mark.parametrize("params", PARAMS, ids=PARAM_IDS)
@settings(max_examples=150, deadline=None)
@given(data=st.data())
def test_tc_dot_error_within_its_bound(params, data):
    K = data.draw(st.integers(1, 64))
    a = np.array(data.draw(st.lists(_bf16_value, min_size=K, max_size=K)))
    b = np.array(data.draw(st.lists(_bf16_value, min_size=K, max_size=K)))
    c = float(np.float32(data.draw(st.floats(-1e6, 1e6, width=32))))
    got = _dot(a.tolist(), b.tolist(), c, **params)
    exact = float((a * b).sum()) + c
    assert abs(got - exact) <= _bound(a, b, c, params["block"],
                                      params["align_bits"])


# ---------------------------------------------------------------------------
# tc_matmul, the probes' plain versions, find_params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ks", [1, 2, 4])
def test_tc_matmul_one_slice_a_run_is_mma_tile(ks):
    """On small integers (every sum exact) tc_matmul with one slice a run
    is _mma_tile's product, and _mma_tile with tc is too."""
    g = torch.Generator().manual_seed(ks)
    a = torch.randint(-8, 9, (24, 80), generator=g).float()
    w = torch.randint(-8, 9, (32, 80), generator=g).float()
    want = li._mma_tile(a, w, ks)
    assert torch.equal(ts.tc_matmul(a, w.T, 1), want)
    assert torch.equal(li._mma_tile(a, w, ks, tc=True), want)


@pytest.mark.parametrize("chain", [1, 2, 4, None])
def test_tc_matmul_adds_its_runs_in_f32(chain):
    """Random bf16 operands: the runs of `chain` slices, each one tc_dot
    chain from zero, added in f32 in order; a ragged K zero-padded."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(6, 100, generator=g).to(BF16).float()
    b = torch.randn(100, 5, generator=g).to(BF16).float()
    run = 16 * (chain or 7)
    want = torch.zeros(6, 5)
    for k0 in range(0, 100, run):
        want = want + ts.tc_dot(a[:, None, k0:k0 + run],
                                b.T[None, :, k0:k0 + run], **CARD)
    assert torch.equal(ts.tc_matmul(a, b, chain), want)
    exact = a.double() @ b.double()
    assert torch.allclose(want.double(), exact, rtol=1e-5, atol=1e-5)


def test_probes_on_cpu_are_the_model():
    g = torch.Generator().manual_seed(0)
    a, b, c = ts.operands(ts.MMA_SHAPE, 1, 4, 0.3, g, "cpu", True)
    assert torch.equal(ts.probe_mma(a, b, c),
                       ts.tc_dot(a[:, :, None], b[:, None], c, **CARD))
    a, b, _ = ts.operands(ts.WGMMA_SHAPE, 2, 1, 0.04, g, "cpu", False)
    assert torch.equal(ts.probe_wgmma(a, b, 2),
                       ts.tc_dot(a[:, :, None], b[:, None],
                                 **ts.WGMMA_M64NNK16_BF16))
    with pytest.raises(ValueError):
        ts.probe_wgmma(a, b, 1)


@pytest.mark.parametrize("params", PARAMS, ids=PARAM_IDS)
def test_find_params_recovers_a_model(params):
    """Probes that run the model with `params`: find_params reads the
    same block, align_bits and rounding back from its crafted vectors,
    and the model then matches them on the conventions' vectors and on
    random fragments."""
    def mma(a, b, c=None):
        return ts.tc_dot(a[:, :, None], b[:, None], c, **params)

    def wgmma(a, b, depth, c=None):
        return ts.tc_dot(a[:, :, None], b[:, None], c, **params)

    out = ts.find_params(mma, wgmma, device="cpu", random_dots=1 << 12)
    for name in ("mma", "wgmma"):
        got = out[name]
        assert {k: got[k] for k in params} == params
        assert got["conventions"] == 0 and got["random"] == (0, 0)


def test_check_sees_another_model():
    """check() counts the entries where a probe and the model part: a
    probe with blocks of 8 against the card's 16."""
    def mma(a, b, c=None):
        return ts.tc_dot(a[:, :, None], b[:, None], c, block=8,
                         align_bits=25, rounding="rz")

    bad, gap = ts.check(mma, ts.MMA_SHAPE, CARD, 1, 256, 0.3, True,
                        torch.Generator().manual_seed(1), "cpu")
    assert bad > 0 and gap >= 1


# ---------------------------------------------------------------------------
# the tc-exact mirrors
# ---------------------------------------------------------------------------

def _exact_params(I, C, R, seed, dense_x=True):
    """Weights whose every product sums exactly in f32 and in the
    model: Wx multiples of 1/8 (against integer x, dense where
    ``dense_x``), and Wr, Wrm (and a sparse Wx) with at most one
    nonzero, +-1/2, in each row and each column, so that every sum over
    an activation has one term."""
    rng = np.random.RandomState(seed)

    def sparse(n, m):
        w = np.zeros((n, m), np.float32)
        rows = rng.permutation(n)[:min(n, m)]
        w[rows, np.arange(min(n, m))] = rng.choice([-0.5, 0.5], len(rows))
        return w

    wx = (rng.randint(-8, 9, (4 * C, I)) / 8.0).astype(np.float32) \
        if dense_x else sparse(4 * C, I)
    u = lambda n: rng.uniform(-0.3, 0.3, n).astype(np.float32)  # noqa
    return LstmParams(t(wx), t(sparse(4 * C, R)), t(u(4 * C)), t(u(C)),
                      t(u(C)), t(u(C)), t(sparse(R, C)))


def _exact_inputs(S, T, I, C, R, seed):
    rng = np.random.RandomState(seed + 1)
    x = t(rng.randint(-3, 4, (T, S, I)))
    c0 = t((rng.randn(S, C) * 0.5))
    r0 = t((rng.randn(S, R) * 0.5)).to(BF16).float()
    return x, c0, r0


def _equal(a, b):
    return all(torch.equal(u.float(), v.float()) for u, v in zip(a, b))


@pytest.fixture
def unfused_cells(monkeypatch):
    """The mirrors' cell math (and K2's gate gradients) unfused with or
    without tc, so that a tc mirror differs from its IEEE mirror by its
    sums alone."""
    def unfused(*args):
        return ts.cell_math(*args[:9], fused=False)

    def unfused_grad(*args):
        return ts.cell_grad_math(*args[:11], fused=False)

    for mod in (lt, li, ls):
        monkeypatch.setattr(mod, "cell_math", unfused)
    monkeypatch.setattr(lt, "cell_grad_math", unfused_grad)


def test_k1_and_k5_tc_mirrors_sum_as_the_ieee_mirrors_on_exact_inputs(
        unfused_cells):
    """C=32, R=16: with every sum exact the tensor core's sums are the
    IEEE ones, so the tc mirrors of K1 bf16 (both xw routes) and K5 bf16
    give their IEEE mirrors' outputs bit for bit."""
    S, T, C, R = 3, 4, 32, 16
    for I in (8, 72):      # xw on the "mma" and the "wg" route
        p = _exact_params(I, C, R, I)
        x, c0, r0 = _exact_inputs(S, T, I, C, R, I)
        route = lt.fwd_plan(T, S, I, C, R, bf16=True)["xw_route"]
        assert route == ("mma" if I == 8 else "wg")
        assert _equal(lt.lstm_fwd_tc_plain(p, x, c0, r0, None, 1.0, 50.0,
                                           compute_dtype=BF16, tc=True),
                      lt.lstm_fwd_tc_plain(p, x, c0, r0, None, 1.0, 50.0,
                                           compute_dtype=BF16))
        assert _equal(li.lstm_infer_tc_plain(p, x, c0, r0, 50.0, tc=True),
                      li.lstm_infer_tc_plain(p, x, c0, r0, 50.0))


def test_k2_tc_mirror_sums_as_the_ieee_mirror_on_exact_inputs(
        unfused_cells):
    """K2 bf16's tc mirror at S=1, T=1 (each frame-axis sum one term),
    every weight with at most one nonzero a row and a column: its outputs
    are the IEEE mirror's bit for bit, dx too."""
    S, T, I, C, R = 1, 1, 8, 32, 16
    p = _exact_params(I, C, R, 5, dense_x=False)
    x, c0, r0 = _exact_inputs(S, T, I, C, R, 5)
    res = lt.lstm_fwd_tc_plain(p, x, c0, r0, None, 1.0, 50.0,
                               compute_dtype=BF16, tc=True)
    g = torch.Generator().manual_seed(5)
    g_r = torch.randn(T, S, R, generator=g)
    gcT = torch.randn(S, C, generator=g)
    args = (p, x, c0, r0, *res, None, 1.0, g_r, gcT, True)
    got = lt.lstm_bwd_split_plain(*args, compute_dtype=BF16, tc=True)
    want = lt.lstm_bwd_split_plain(*args, compute_dtype=BF16)
    assert _equal(got[0], want[0]) and _equal(got[1:], want[1:])


def test_k6_and_k7_tc_mirrors_sum_as_the_ieee_mirrors_on_exact_inputs(
        unfused_cells):
    S, T, I, C, R = 3, 4, 8, 32, 16
    p1 = _exact_params(I, C, R, 1)
    p2 = _exact_params(R, C, R, 2, dense_x=False)
    x, c0, r0 = _exact_inputs(S, T, I, C, R, 3)
    s1 = LstmState(c0, r0)
    s2 = LstmState(c0.flip(0), r0.flip(0))
    assert _equal(ls.lstm_stack_fwd2_tc_plain(p1, p2, x, s1, s2, CLIP,
                                              tc=True),
                  ls.lstm_stack_fwd2_tc_plain(p1, p2, x, s1, s2, CLIP))
    got = ls.lstm_stack_infer2_tc_plain(p1, p2, x, s1, s2, CLIP, tc=True)
    want = ls.lstm_stack_infer2_tc_plain(p1, p2, x, s1, s2, CLIP)
    assert torch.equal(got[0], want[0])
    assert _equal(got[1], want[1]) and _equal(got[2], want[2])


def _fma_exact(a: float, b: float, c: float) -> float:
    """a b + c (f32 values) rounded once to f32, to nearest even, in
    exact rational arithmetic."""
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.array(v).view(np.int32)) & 1))
    return float(best)


_f32 = st.floats(-4.0, 4.0, width=32)


@settings(max_examples=300, deadline=None)
@given(a=_f32, b=_f32, c=_f32)
def test_fma_f32_rounds_once(a, b, c):
    got = ts.fma_f32(torch.tensor([a]), torch.tensor([b]), torch.tensor([c]))
    assert float(got) == _fma_exact(a, b, c)


@pytest.mark.parametrize("c,side", [(2.0 ** -80, 1), (-(2.0 ** -80), 0),
                                    (0.0, 0)])
def test_fma_f32_breaks_the_f64_ties(c, side):
    """(1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 lies on the midpoint of two f32
    values; a c of +-2^-80 is lost when f64 adds it, so s sits on the
    midpoint, and the f64 sum's error must pick the side (up for +, down
    for -); with c = 0 the tie goes to even (down)."""
    a = 1.0 + 2.0 ** -12
    low = 1.0 + 2.0 ** -11
    assert (a * a) + c == low + 2.0 ** -24        # f64 lost c
    got = float(ts.fma_f32(torch.tensor([a]), torch.tensor([a]),
                           torch.tensor([c])))
    assert got == low + side * 2.0 ** -23 == _fma_exact(a, a, c)


def test_fused_cell_grad_math_takes_the_kernels_roundings():
    """cell_grad_math(fused=True) is K2 bf16's epilogue as nvcc contracts
    it (found on the card); unfused, the plain version's order, and the
    two differ."""
    g = torch.Generator().manual_seed(1)
    dm, dc = torch.randn(64, generator=g), torch.randn(64, generator=g)
    gg, h = (torch.tanh(torch.randn(64, generator=g)) for _ in range(2))
    i, f, o = (torch.sigmoid(torch.randn(64, generator=g)) for _ in range(3))
    cp = torch.randn(64, generator=g) * 0.5
    pi, pf, po = (torch.randn(64, generator=g) * 0.3 for _ in range(3))
    one = torch.ones(64)
    dg, di, df, d_o, dcn = ts.cell_grad_math(dm, gg, i, f, o, h, cp, dc,
                                             pi, pf, po, fused=True)
    dct = ts.fma_f32(d_o, po, ts.fma_f32(dm * o, ts.fma_f32(-h, h, one), dc))
    assert torch.equal(d_o, dm * h * o * (1.0 - o))
    assert torch.equal(df, dct * cp * f * (1.0 - f))
    assert torch.equal(di, dct * gg * i * (1.0 - i))
    assert torch.equal(dg, dct * i * ts.fma_f32(-gg, gg, one))
    assert torch.equal(dcn, ts.fma_f32(df, pf, ts.fma_f32(dct, f, di * pi)))
    plain = ts.cell_grad_math(dm, gg, i, f, o, h, cp, dc, pi, pf, po)
    assert torch.equal(plain[4], (dc + dm * o * (1.0 - h * h) + d_o * po)
                       * f + plain[1] * pi + plain[2] * pf)
    assert not torch.equal(plain[4], dcn)


@pytest.mark.parametrize("ranges", [1, 3, 7])
def test_col_sums_walk_rows_as_col_reduce(ranges):
    """K2's column sums in the kernel's order: 8 running sums a range
    over the rows n = r (mod 8), fused products, then the 8, then the
    ranges, all in f32 in order (a hand loop), and equal to the f64 sum
    to f32 accuracy."""
    g = torch.Generator().manual_seed(ranges)
    v = torch.randn(45, 6, generator=g)
    w = torch.randn(45, 6, generator=g)
    rows = -(-45 // ranges)
    want = torch.zeros(6)
    for y in range(ranges):
        block = range(y * rows, min(45, (y + 1) * rows))
        part = torch.zeros(6)
        for r in range(8):
            acc = torch.zeros(6)
            for n in [n for n in block if (n - y * rows) % 8 == r]:
                acc = ts.fma_f32(v[n], w[n], acc)
            part = part + acc
        want = want + part
    got = lt._col_sums(v, w, ranges)
    assert torch.equal(got, want)
    exact = (v.double() * w.double()).sum(0)
    assert torch.allclose(got.double(), exact, rtol=1e-5, atol=1e-5)
    assert torch.allclose(lt._col_sums(v, ranges=ranges).double(),
                          v.double().sum(0), rtol=1e-5, atol=1e-5)


def test_fused_cell_math_takes_the_kernels_roundings():
    """cell_math(fused=True) is the kernels' cell as nvcc contracts it:
    each peephole term fused into its add, the new c fmaf(g, i, c f);
    unfused, the plain version's order."""
    g = torch.Generator().manual_seed(0)
    pre = [torch.randn(64, generator=g) for _ in range(4)]
    c = torch.randn(64, generator=g) * 0.5
    pi, pf, po = (torch.randn(64, generator=g) * 0.3 for _ in range(3))
    gg, i, f, cn, o = ts.cell_math(*pre, c, pi, pf, po, 0.4, fused=True)
    assert torch.equal(i, torch.sigmoid(ts.fma_f32(c, pi, pre[1])))
    assert torch.equal(f, torch.sigmoid(ts.fma_f32(c, pf, pre[2])))
    assert torch.equal(cn, torch.clamp(ts.fma_f32(gg, i, c * f), -0.4, 0.4))
    assert torch.equal(o, torch.sigmoid(ts.fma_f32(cn, po, pre[3])))
    plain = ts.cell_math(*pre, c, pi, pf, po, 0.4)
    assert torch.equal(plain[3], torch.clamp(
        torch.tanh(pre[0]) * torch.sigmoid(pre[1] + c * pi)
        + c * torch.sigmoid(pre[2] + c * pf), -0.4, 0.4))
    assert not torch.equal(plain[3], cn)


def test_tc_mirrors_refuse_f32():
    p = _exact_params(8, 32, 16, 0)
    x, c0, r0 = _exact_inputs(2, 2, 8, 32, 16, 0)
    with pytest.raises(ValueError):
        lt.lstm_fwd_tc_plain(p, x, c0, r0, tc=True)


# the JAX package's bf16 kernels in interpret mode: (S, T, I, C, R, keep,
# need_dx); I=72 takes K1 bf16's xw on the wgmma route
TC_LSTM_CASES = {
    "narrow": (3, 6, 8, 32, 16, None, True),
    "keep_0.75": (3, 6, 8, 32, 16, 0.75, True),
    "wg_route_no_dx": (2, 6, 72, 32, 16, None, False),
}


@pytest.mark.parametrize("case", list(TC_LSTM_CASES))
def test_k1_k2_tc_mirrors_match_pallas(case):
    """lstm_fwd_tc_plain and lstm_bwd_split_plain with tc (the bf16 K1's
    and K2's sums as the tensor cores make them) against lstm_scan_pallas
    under set_matmul_dtype(bf16), interpret mode: outputs, final state
    and every gradient within a tenth of the bf16-vs-f32 distance."""
    S, T, I, C, R, keep, need_dx = TC_LSTM_CASES[case]
    args = lstm_inputs(S, T, I, C, R, keep, seed=31 + I)
    j16 = jax_lstm(*args, keep, need_dx, jnp.bfloat16)
    j32 = jax_lstm(*args, keep, need_dx, None)
    p, x, c0, r0, mask, cot = args
    tp = LstmParams(**{k: t(v) for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous()
    m8 = None if mask is None else \
        torch.from_numpy(mask).transpose(0, 1).to(torch.int8).contiguous()
    ik = 1.0 if keep is None else 1.0 / keep
    gifo, c_seq, r_seq = lt.lstm_fwd_tc_plain(
        tp, x_tm, t(c0), t(r0), m8, ik, 50.0, compute_dtype=BF16, tc=True)
    g_r = t(cot[0]).transpose(0, 1).contiguous()
    g_r[T - 1] += t(cot[2])
    dp, dx, dc0, dr0 = lt.lstm_bwd_split_plain(
        tp, x_tm, t(c0), t(r0), gifo, c_seq, r_seq, m8, ik, g_r, t(cot[1]),
        need_dx, compute_dtype=BF16, tc=True)
    port = [r_seq.transpose(0, 1).numpy(), c_seq[T - 1].numpy(),
            r_seq[T - 1].numpy()]
    for n, pv, av, bv in zip(LSTM_NAMES[0], port, j16[0], j32[0]):
        assert_bf16_close(n, pv, av, bv)
    grads = [g.numpy() for g in dp] + [
        dx.transpose(0, 1).numpy() if need_dx else None, dc0.numpy(),
        dr0.numpy()]
    for n, pv, av, bv in zip(LSTM_NAMES[1], grads, j16[1], j32[1]):
        if n == "dx" and not need_dx:
            continue
        assert_bf16_close(n, pv, av, bv)


@pytest.mark.parametrize("S,I", [(3, 8), (5, 37)])
def test_k5_tc_mirror_matches_pallas(S, I):
    """lstm_infer_tc_plain with tc against the Pallas inference kernel
    under set_matmul_dtype(bf16), interpret mode."""
    from kaldi_lstm_tpu.ops import LstmState as JLstmState
    from kaldi_lstm_tpu.ops.lstm_cell import LstmParams as JLstmParams
    from kaldi_lstm_tpu.ops.lstm_pallas import lstm_scan_pallas
    T, C, R = 6, 32, 16
    p, x, c0, r0, _, _ = lstm_inputs(S, T, I, C, R, None, seed=S + I)
    jp = JLstmParams(**{k: jnp.asarray(v) for k, v in p.items()})
    ref = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        set_matmul_dtype(dt)
        o, fin = lstm_scan_pallas(jp, jnp.asarray(x),
                                  JLstmState(c=jnp.asarray(c0),
                                             r=jnp.asarray(r0)),
                                  50.0, interpret=True)
        ref[name] = (np.asarray(o), np.asarray(fin.c))
        set_matmul_dtype(None)
    tp = LstmParams(**{k: t(v) for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous()
    r, c = li.lstm_infer_tc_plain(tp, x_tm, t(c0), t(r0), 50.0, sms=3,
                                  tc=True)
    assert_bf16_close("r", r.transpose(0, 1).numpy(), ref["bf16"][0],
                      ref["f32"][0])
    assert_bf16_close("c_T", c.numpy(), ref["bf16"][1], ref["f32"][1])


@pytest.mark.parametrize("tb", [4, 2])
def test_k6_k7_tc_mirrors_match_pallas(tb):
    """lstm_stack_fwd2_tc_plain and lstm_stack_infer2_tc_plain with tc
    against the JAX wavefront kernels under set_matmul_dtype(bf16),
    interpret mode (C=32, R=16)."""
    dims = (4, 8, 12, 32, 16)
    S, T, I, C, R = dims
    jx, port = make(seed=140 + tb, s=S, t=T, i=I, c=C, r=R)
    got = ls.lstm_stack_fwd2_tc_plain(*port, CLIP, tc=True)
    want = _jax_fwd2(jx, dims, tb, jnp.bfloat16)
    want32 = _jax_fwd2(jx, dims, tb, None)
    for name, a, b, c in zip(("gifo1", "c1", "r1", "gifo2", "c2", "r2"),
                             got, want, want32):
        assert_bf16_close(name, a.float().numpy(), b, c)
    r2, f1, f2 = ls.lstm_stack_infer2_tc_plain(*port, CLIP, sms=5, tc=True)
    want = _jax_infer2(jx, dims, tb, jnp.bfloat16)
    want32 = _jax_infer2(jx, dims, tb, None)
    for name, a, b, c in zip(("r2", "c1T", "r1T", "c2T"),
                             (r2, f1.c, f1.r, f2.c), want, want32):
        assert_bf16_close(name, a.numpy(), b, c)
