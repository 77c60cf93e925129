"""The redesigned bf16 kernels of K5 (``lstmp_infer_bf16``, the bf16
tensor-core recurrence), K2 (``lstmp_train_bwd_bf16``, on the bf16
tiles of csrc/tc_gemm.cuh) and K1 (``lstmp_train_fwd_bf16``, on the same
tiles in 64-deep stages) on the CPU:

* their plans at every shape chip_smoke.py runs them: shared memory
  within an H100 block's 232,448 bytes, every cell, projection column
  and output tile owned by exactly one CTA, the residency cut-over of
  K5's bf16 weight slices;
* the plain mirrors of their summation order (K5: 16-deep slices, each
  slice's product from a zero fragment added in f32, the warps' splits
  added in warp order, ``lstm_infer_tc_plain``; K2: 32-deep stages in
  the same way, dm and dr unsplit, the frame-axis products split,
  ``lstm_bwd_split_plain`` in bf16; K1: the gate interleave at the gate
  tile's width, ``lstm_fwd_tc_plain`` in bf16)
  against the JAX package's bf16 kernels: K5 through ``_infer_call`` in
  interpret mode (the custom-VJP primal of ``lstm_scan_pallas``), K2
  through ``lstm_scan_pallas``'s gradients under ``set_matmul_dtype``,
  K1 through its primal (the outputs and the final state);
* that the bf16 weight copies are made anew on every call, so that an
  in-place update of the parameters (the optimizer's) is seen by the
  next call: of the mirrors here, of the kernels themselves on a card
  (``gpu``).

Tolerance: tests/test_torch_bf16.py's rule. The port's error (RMS) is
at most a tenth of the bf16-vs-f32 distance (the JAX reference in bf16
against itself in f32, RMS) on the same inputs, and that distance must
be real (above 1e-5 of the tensor's RMS). The mirrors sum in other
orders than XLA (~1e-7 relative) and may take a rare bf16 rounding the
other way; a missed or added rounding point would move the error to
about the distance itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.models.components import set_matmul_dtype
from kaldi_lstm_tpu.ops import LstmState as JLstmState
from kaldi_lstm_tpu.ops.lstm_cell import LstmParams as JLstmParams
from kaldi_lstm_tpu.ops.lstm_pallas import lstm_scan_pallas
from kaldi_lstm_tpu_torch.ops import lstm_infer as li
from kaldi_lstm_tpu_torch.ops import lstm_train as lt
from kaldi_lstm_tpu_torch.ops import tc_sum as ts
from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams, LstmState, lstm_scan

from test_torch_bf16 import (
    BF16,
    LSTM_CASES,
    LSTM_NAMES,
    assert_bf16_close,
    jax_lstm,
    lstm_inputs,
    t,
)

OPTIN = 232448   # an H100 block's shared memory (bytes)


@pytest.fixture(autouse=True)
def reset_jax_dtype():
    yield
    set_matmul_dtype(None)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

# K5 bf16 at every shape chip_smoke.py runs it (phase 3d, the bf16 CV pass
# of phase 5c, the masked case): (S, I, C, R)
K5_SHAPES = [(8, 40, 800, 512), (256, 40, 800, 512), (8, 512, 800, 512),
             (256, 512, 800, 512), (8, 1024, 800, 512), (8, 2400, 800, 512),
             (3, 37, 200, 130), (64, 40, 800, 512)]
# K2 bf16 at every shape phase 3d and 5c run it: (T, S, I, C, R)
K2_SHAPES = [(20, 256, 40, 800, 512), (20, 256, 512, 800, 512),
             (2, 256, 40, 800, 512), (2, 3, 37, 200, 130)]
# K1 bf16 at every shape phase 3d runs it (the flagship, I=512, T=2, the
# per-utterance S=1, ragged): (T, S, I, C, R)
K1_SHAPES = [(20, 256, 40, 800, 512), (20, 256, 512, 800, 512),
             (2, 256, 40, 800, 512), (64, 1, 40, 800, 512),
             (2, 3, 37, 200, 130)]


@pytest.mark.parametrize("S,I,C,R", K5_SHAPES)
def test_k5_bf16_plan_fits_and_deals_every_cell_and_column_once(S, I, C,
                                                                R):
    pl = li.k5_bf16_plan(S, I, C, R)
    assert pl["smem"] <= OPTIN
    assert pl["grid"] <= li.H100_SMS
    # gate CTAs: 4 ncell rows (whole m16 tiles), (cell group, stream
    # group), every (s, cell) once
    assert pl["mg"] == 4 * pl["ncell"] and pl["mg"] % 16 == 0
    assert pl["gate_ctas"] == pl["gcgroups"] * pl["gsgroups"]
    owner = np.full((S, C), -1)
    for b in range(pl["gate_ctas"]):
        j0, sg = (b % pl["gcgroups"]) * pl["ncell"], b // pl["gcgroups"]
        block = owner[sg * pl["gnsg"]:(sg + 1) * pl["gnsg"],
                      j0:j0 + pl["ncell"]]
        assert (block == -1).all()
        block[...] = b
    assert (owner >= 0).all()
    # projection CTAs: (column group, stream group), every (s, q) once
    assert pl["mq"] % 16 == 0 and pl["nsg"] % 8 == 0
    seen = np.zeros((S, R), int)
    for b in range(pl["qgroups"] * pl["sgroups"]):
        q0, sg = (b % pl["qgroups"]) * pl["mq"], b // pl["qgroups"]
        seen[sg * pl["nsg"]:(sg + 1) * pl["nsg"], q0:q0 + pl["mq"]] += 1
    assert (seen == 1).all()
    # the contractions padded to whole 16-deep slices, the staged and
    # resident rows an odd number of 16-byte units (no bank conflicts)
    assert pl["kg"] % 16 == 0 and pl["kg"] >= pl["ip"] + pl["rp"]
    assert pl["kq"] % 16 == 0 and pl["kq"] >= pl["cp"] >= C
    assert (pl["ksg"] // 8) % 2 == 1 and (pl["ksq"] // 8) % 2 == 1
    # staging tiles of whole n8 tiles, at most 64 streams
    assert 8 <= pl["ns_g"] <= min(64, pl["gnsg"]) and pl["ns_g"] % 8 == 0
    assert 8 <= pl["ns_q"] <= min(64, pl["nsg"]) and pl["ns_q"] % 8 == 0
    # the regions of shared memory follow each other, 16-byte aligned
    offs = [0, pl["off_cst"], pl["off_c"], pl["off_w"], pl["off_stage"],
            pl["smem"]]
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)


def test_k5_bf16_plan_splits_by_streams_at_large_s():
    """At S=256, R=512 the projection takes 32 column groups x 4 stream
    groups of 64 (a CTA stages 64 streams of m, not 256) and the gates
    50 cell groups of 16 x 2 stream groups of 128; at S=8 one stream
    group each; at S=256, I=512 one gate stream group (two would leave
    tiles of fewer than 32 streams)."""
    big = li.k5_bf16_plan(256, 40, 800, 512)
    assert (big["qgroups"], big["sgroups"], big["nsg"]) == (32, 4, 64)
    assert (big["ncell"], big["gcgroups"], big["gsgroups"], big["gnsg"]) \
        == (16, 50, 2, 128)
    assert (big["ns_g"], big["ns_q"]) == (32, 32)     # even tiles
    small = li.k5_bf16_plan(8, 40, 800, 512)
    assert (small["qgroups"], small["sgroups"], small["nsg"]) == (32, 1, 8)
    assert (small["ncell"], small["gcgroups"], small["gsgroups"]) == \
        (8, 100, 1)
    assert li.k5_bf16_plan(256, 512, 800, 512)["gsgroups"] == 1


def test_k5_bf16_residency_cut_over():
    """The bf16 weight slices stay in shared memory up to the widest I
    that leaves room for two 8-stream staging tiles, and are read from
    device memory past it: I=1024 resident, I=2400 not (phase 3d's
    cases), with the cut-over exactly where the budget runs out."""
    res = [li.k5_bf16_plan(8, i, 800, 512)["resident"]
           for i in range(1000, 2401, 8)]
    assert res[0] == 1 and res[-1] == 0
    cut = res.index(0)
    assert all(res[:cut]) and not any(res[cut:])
    last = 1000 + 8 * (cut - 1)
    pl = li.k5_bf16_plan(8, last, 800, 512)
    nxt = li.k5_bf16_plan(8, last + 8, 800, 512)
    w = lambda p: 2 * (p["mg"] * p["ksg"] + p["mq"] * p["ksq"])  # noqa: E731
    assert pl["smem"] <= OPTIN
    assert nxt["off_w"] + w(nxt) + 2 * 2 * 8 * nxt["ksg"] > OPTIN
    # the weights in device memory still leave room to stage
    assert nxt["smem"] <= OPTIN and nxt["off_stage"] == nxt["off_w"]


@pytest.mark.parametrize("units,ks", [(1, 8), (2, 4), (3, 2), (4, 2),
                                      (5, 1), (8, 1), (16, 1)])
def test_mma_ksplit(units, ks):
    """Warps splitting one output tile's contraction: at S=8 the two
    gate tiles (32 rows x 8 streams) by 4 warps each, the one projection
    tile by all 8."""
    assert li.mma_ksplit(units) == ks


@pytest.mark.parametrize("T,S,I,C,R", K2_SHAPES)
@pytest.mark.parametrize("need_dx", [False, True])
def test_k2_bf16_tiles_fit_and_cover_every_output_once(T, S, I, C, R,
                                                       need_dx):
    launches = lt.bwd_bf16_launches(T, S, I, C, R, need_dx)
    plan = lt.bwd_plan(T, S, I, C, R, bf16=True)
    assert plan["dr"] == 1                      # dr summed once a step
    outputs = {"dm": (S, C), "dr": (S, R), "dWx": (4 * C, I),
               "dWr": (4 * C, R), "dWrm": (R, C), "dx": (T * S, I)}
    for name, ((gx, gy, gz), smem, n) in launches.items():
        assert smem <= OPTIN, name
        tile = lt.BF16_TILES["frame" if name.startswith(("dW", "dx"))
                             else name]
        M, N = outputs[name]
        # the grid covers the output exactly: no tile past it
        assert (gx - 1) * tile[0] < M <= gx * tile[0], name
        assert (gy - 1) * tile[1] < N <= gy * tile[1], name
    # every split of a frame-axis product holds whole stages, none empty
    for key, K in (("wx", T * S), ("wr", T * S), ("wrm", T * S),
                   ("dx", 4 * C)):
        ksteps = -(-K // 32)
        per = -(-ksteps // plan[key])
        assert (plan[key] - 1) * per < ksteps
    # + the prologue, the column sums and the partials' sum
    assert sum(n for *_, n in launches.values()) + 3 == \
        lt.bwd_launches(T, need_dx, bf16=True)
    assert lt.bwd_launches(T, need_dx, bf16=True) == \
        lt.bwd_launches(T, need_dx) + 1


@pytest.mark.parametrize("T,S,I,C,R", K1_SHAPES)
def test_k1_bf16_tiles_fit_and_cover_every_output_once(T, S, I, C, R):
    """The bf16 plan at every shape phase 3d runs: each Gemm16 kernel's
    shared memory within a block's, the gate tile staged inside its
    ring, the epilogue's rounds of tile rows whole, every (stream, cell)
    of the gates and every xw and projection output owned by exactly one
    CTA, the xw on wgmma only where the contraction is deeper than one
    stage."""
    plan = lt.fwd_plan(T, S, I, C, R, bf16=True)
    bm, bn, cells = plan["gate_bm"], plan["gate_bn"], plan["gate_cells"]
    assert max(plan["gate_smem"], plan["xw_smem"],
               plan["proj_smem"]) <= OPTIN
    assert bm * (bn + 4) * 4 <= plan["gate_smem"]   # the staged tile
    assert bm % (plan["gate_threads"] // cells) == 0
    Cp = plan["padded_cells"]
    assert bn == 4 * cells and Cp % cells == 0 and C <= Cp < C + cells
    owner = np.full((S, C), -1)
    ny = 4 * Cp // bn
    assert plan["gate_ctas"] == -(-S // bm) * ny
    for b in range(plan["gate_ctas"]):
        bx, by = b // ny, b % ny
        block = owner[bx * bm:(bx + 1) * bm, by * cells:(by + 1) * cells]
        assert (block == -1).all()
        block[...] = b
    assert (owner >= 0).all()
    route = plan["xw_route"]
    assert route == ("wg" if I > lt.K1_BF16_STAGE else "mma")
    xt = 128 if route == "wg" else lt.K1_BF16_XW_TILE[0]
    tiles = -(-T * S // xt) * -(-4 * C // xt)
    assert plan["xw_ctas"] == (min(tiles, lt.H100_SMS) if route == "wg"
                               else tiles)
    pbm, pbn, _ = lt.K1_BF16_PROJ_TILE
    assert plan["proj_ctas"] == -(-S // pbm) * -(-R // pbn)
    assert lt.fwd_launches(T) == 2 * T + 2


@pytest.mark.parametrize("cells", [16, lt.K1_BF16_GATE_CELLS])
@pytest.mark.parametrize("C", [1, 9, 16, 31, 33, 200, 800])
def test_k1_gate_interleave_deals_each_cell_into_one_tile(cells, C):
    """The interleave at a gate tile of 4 x `cells` columns (f32's 16
    cells, the bf16 tile's 32): tile b holds
    g, i, f, o (in that order) of cells `cells` b .. `cells` (b + 1) - 1,
    each real row of w_gifo_r exactly once, zero rows for padding cells;
    the deinterleave is its inverse."""
    rows = lt.gate_interleave(C, cells)
    Cp = -(-C // cells) * cells
    assert rows.shape == (4 * Cp,)
    tiles = rows.reshape(Cp // cells, 4, cells)
    for b in range(Cp // cells):
        for lane in range(cells):
            j = b * cells + lane
            got = tiles[b, :, lane].tolist()
            assert got == ([q * C + j for q in range(4)] if j < C
                           else [-1] * 4)
    real = rows[rows >= 0]
    assert sorted(real.tolist()) == list(range(4 * C))
    cols = lt.gate_deinterleave(C, cells)
    assert torch.equal(rows[cols], torch.arange(4 * C))


# ---------------------------------------------------------------------------
# the sums against JAX
# ---------------------------------------------------------------------------

def _optin_for(S, I, C, R, ns, sms):
    """An opt-in budget whose plan stages tiles of `ns` streams in the
    gates phase, so a small test walks several tiles."""
    pl = li.k5_bf16_plan(S, I, C, R, sms)
    return pl["off_stage"] + 2 * 2 * ns * pl["ksg"]


K5_MIRROR_CASES = {
    # name: (S, T, I, C, R, sms, tile streams or None)
    "one_cta_per_sm": (3, 6, 9, 6, 6, 132, None),
    "ragged_few_sms": (5, 6, 37, 21, 13, 3, None),
    "wide_several_tiles": (20, 6, 40, 64, 40, 4, 8),
    "stream_groups": (24, 6, 16, 16, 16, 8, None),
    "gate_stream_groups": (128, 3, 8, 12, 8, 8, None),
}


@pytest.mark.parametrize("case", list(K5_MIRROR_CASES))
def test_k5_tc_mirror_matches_pallas_primal(case):
    """lstm_infer_tc_plain (the bf16 kernel's decomposition) against the
    Pallas inference kernel under set_matmul_dtype(bf16), interpret mode:
    r for every t and the final c."""
    S, T, I, C, R, sms, ns = K5_MIRROR_CASES[case]
    p, x, c0, r0, _, _ = lstm_inputs(S, T, I, C, R, None, seed=S + I)
    jp = JLstmParams(**{k: jnp.asarray(v) for k, v in p.items()})
    ref = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", None)):
        set_matmul_dtype(dt)
        o, st = lstm_scan_pallas(jp, jnp.asarray(x),
                                 JLstmState(c=jnp.asarray(c0),
                                            r=jnp.asarray(r0)),
                                 50.0, interpret=True)
        ref[name] = (np.asarray(o), np.asarray(st.c))
        set_matmul_dtype(None)
    optin = OPTIN if ns is None else _optin_for(S, I, C, R, ns, sms)
    pl = li.k5_bf16_plan(S, I, C, R, sms, optin)
    if ns is not None:
        assert pl["ns_g"] == ns < S          # several staged tiles
    if case == "stream_groups":
        assert pl["sgroups"] > 1
    if case == "gate_stream_groups":
        assert pl["gsgroups"] == 2
    tp = LstmParams(**{k: t(v) for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous()
    r, c = li.lstm_infer_tc_plain(tp, x_tm, t(c0), t(r0), 50.0, sms, optin)
    assert_bf16_close("r", r.transpose(0, 1).numpy(), ref["bf16"][0],
                      ref["f32"][0])
    assert_bf16_close("c_T", c.numpy(), ref["bf16"][1], ref["f32"][1])


def test_sliced_plain_in_bf16_is_the_tc_mirror():
    """lstm_infer_sliced_plain with compute_dtype bf16 is the bf16
    kernel's decomposition, bit for bit."""
    p, x, c0, r0, _, _ = lstm_inputs(5, 4, 37, 21, 13, None, seed=1)
    tp = LstmParams(**{k: t(v) for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous()
    a = li.lstm_infer_sliced_plain(tp, x_tm, t(c0), t(r0), sms=3,
                                   compute_dtype=BF16)
    b = li.lstm_infer_tc_plain(tp, x_tm, t(c0), t(r0), sms=3)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


K2_MIRROR_CASES = {
    # name: (S, T, I, C, R, keep, need_dx, sms)
    "ragged_splits": (3, 5, 37, 21, 13, 0.75, True, 4),
    "small_no_dx": (4, 6, 8, 12, 8, None, False, 132),
    "frame_products_split": (32, 16, 40, 40, 40, None, True, 132),
}


@pytest.mark.parametrize("case", list(K2_MIRROR_CASES))
def test_k2_bf16_mirror_matches_pallas_gradients(case):
    """lstm_fwd_tc_plain + lstm_bwd_split_plain in bf16 (dm and dr
    unsplit, every product stage by stage, the frame-axis products split
    as bwd_plan says for `sms` SMs) against lstm_scan_pallas's gradients
    under set_matmul_dtype(bf16), interpret mode."""
    S, T, I, C, R, keep, need_dx, sms = K2_MIRROR_CASES[case]
    args = lstm_inputs(S, T, I, C, R, keep, seed=7 + S)
    j16 = jax_lstm(*args, keep, need_dx, jnp.bfloat16)
    j32 = jax_lstm(*args, keep, need_dx, None)
    plan = lt.bwd_plan(T, S, I, C, R, sms, bf16=True)
    if case == "frame_products_split":
        assert min(plan[k] for k in ("wx", "wr", "wrm")) > 1
    p, x, c0, r0, mask, cot = args
    tp = LstmParams(**{k: t(v) for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous()
    m8 = None if mask is None else \
        torch.from_numpy(mask).transpose(0, 1).to(torch.int8).contiguous()
    ik = 1.0 if keep is None else 1.0 / keep
    gifo, c_seq, r_seq = lt.lstm_fwd_tc_plain(tp, x_tm, t(c0), t(r0), m8,
                                              ik, 50.0, compute_dtype=BF16)
    g_r = t(cot[0]).transpose(0, 1).contiguous()
    g_r[T - 1] += t(cot[2])
    dp, dx, dc0, dr0 = lt.lstm_bwd_split_plain(
        tp, x_tm, t(c0), t(r0), gifo, c_seq, r_seq, m8, ik, g_r, t(cot[1]),
        need_dx, sms=sms, compute_dtype=BF16)
    grads = [g.numpy() for g in dp] + [
        dx.transpose(0, 1).numpy() if need_dx else None, dc0.numpy(),
        dr0.numpy()]
    for n, pv, av, bv in zip(LSTM_NAMES[1], grads, j16[1], j32[1]):
        if n == "dx" and not need_dx:
            continue
        assert_bf16_close(n, pv, av, bv)


@pytest.mark.parametrize("case", list(LSTM_CASES))
def test_k1_bf16_mirror_matches_pallas_primal(case):
    """lstm_fwd_tc_plain in bf16 (the bf16 K1's decomposition: the
    interleave at the bf16 gate tile's 32 cells) against
    lstm_scan_pallas's primal under set_matmul_dtype(bf16), interpret
    mode: r for every t and the final state, by the module's rule."""
    S, T, I, C, R, keep, _ = LSTM_CASES[case]
    p, x, c0, r0, mask, cot = lstm_inputs(S, T, I, C, R, keep, seed=11 + S)
    j16 = jax_lstm(p, x, c0, r0, mask, cot, keep, False, jnp.bfloat16)
    j32 = jax_lstm(p, x, c0, r0, mask, cot, keep, False, None)
    tp = LstmParams(**{k: t(v) for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous()
    m8 = None if mask is None else \
        torch.from_numpy(mask).transpose(0, 1).to(torch.int8).contiguous()
    ik = 1.0 if keep is None else 1.0 / keep
    gifo, c_seq, r_seq = lt.lstm_fwd_tc_plain(
        tp, x_tm, t(c0), t(r0), m8, ik, 50.0, compute_dtype=BF16)
    assert gifo.dtype == BF16
    port = [r_seq.transpose(0, 1).numpy(), c_seq[T - 1].numpy(),
            r_seq[T - 1].numpy()]
    for n, pv, av, bv in zip(LSTM_NAMES[0], port, j16[0], j32[0]):
        assert_bf16_close(n, pv, av, bv)


def test_stage_matmul_is_stagewise():
    """_stage_matmul adds 32-deep stage products from zero, per split,
    then the splits in order: equal to the float64 product to f32
    rounding, and each split a sum of whole stages."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(5, 100, generator=g)
    b = torch.randn(100, 7, generator=g)
    want = (a.double() @ b.double()).float()
    for splits in (1, 2, 3):
        got = lt._stage_matmul(a, b, splits)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    manual = sum((a[:, k:k + 32] @ b[k:k + 32] for k in range(0, 100, 32)),
                 torch.zeros(5, 7))
    assert torch.equal(lt._stage_matmul(a, b), manual)


# ---------------------------------------------------------------------------
# no stale weights
# ---------------------------------------------------------------------------

def _update_in_place(tp: LstmParams, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for v in tp:
            v.add_(0.05 * torch.randn(v.shape, generator=g))


def test_k5_bf16_copies_follow_an_in_place_update():
    """The bf16 weight copies are made on every call: after an in-place
    update of the parameters (as the optimizer makes), the next call
    equals a call on fresh tensors holding the new values, and differs
    from the call before the update."""
    p, x, c0, r0, _, _ = lstm_inputs(5, 4, 37, 21, 13, None, seed=2)
    tp = LstmParams(**{k: t(v) for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous()
    before = li.lstm_infer_tc_plain(tp, x_tm, t(c0), t(r0), sms=3)
    _update_in_place(tp, 3)
    after = li.lstm_infer_tc_plain(tp, x_tm, t(c0), t(r0), sms=3)
    fresh = LstmParams(*(v.clone() for v in tp))
    want = li.lstm_infer_tc_plain(fresh, x_tm, t(c0), t(r0), sms=3)
    assert all(torch.equal(u, v) for u, v in zip(after, want))
    assert not torch.equal(before[0], after[0])


def test_k2_bf16_copies_follow_an_in_place_update():
    """The same for K2's bf16 backward (its weight copies Wr, Wrm, Wx)."""
    S, T, I, C, R = 3, 4, 9, 10, 6
    p, x, c0, r0, _, cot = lstm_inputs(S, T, I, C, R, None, seed=4)
    tp = LstmParams(**{k: t(v) for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous()
    g_r = t(cot[0]).transpose(0, 1).contiguous()

    def bwd(params):
        res = lt.lstm_fwd_tc_plain(params, x_tm, t(c0), t(r0),
                                   compute_dtype=BF16)
        return lt.lstm_bwd_split_plain(params, x_tm, t(c0), t(r0), *res,
                                       None, 1.0, g_r, t(cot[1]), True,
                                       compute_dtype=BF16)

    before = bwd(tp)
    _update_in_place(tp, 5)
    after = bwd(tp)
    want = bwd(LstmParams(*(v.clone() for v in tp)))
    for u, v in zip((*after[0], *after[1:]), (*want[0], *want[1:])):
        assert torch.equal(u, v)
    assert not torch.equal(before[0].w_gifo_r, after[0].w_gifo_r)


def _update_on_card(tp: LstmParams, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for v in tp:
            v.add_(0.05 * torch.randn(v.shape, generator=g).to(v.device))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bf16 kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,I,C,R", [(3, 4, 37, 200, 130),
                                       (8, 3, 2400, 800, 512)])
def test_k5_bf16_kernel_follows_an_in_place_update(S, T, I, C, R):
    """The card's copies of the weights (shared-memory slices where they
    are resident, the wg/wq slices in device memory at I=2400) are made
    on every call: after an in-place update of the parameters, K5 bf16
    equals a call on fresh clones, and differs from the call before."""
    _card()
    p, x, c0, r0, _, _ = lstm_inputs(S, T, I, C, R, None, seed=6)
    tp = LstmParams(**{k: t(v * 0.1).cuda() for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous().cuda()
    st = LstmState(t(c0).cuda(), t(r0).cuda())

    def run(params):
        with torch.no_grad():
            r, fin = li.lstm_infer_cuda(params, x_tm, st, compute_dtype=BF16)
        return r, fin.c, fin.r

    before = run(tp)
    _update_on_card(tp, 7)
    after = run(tp)
    want = run(LstmParams(*(v.clone() for v in tp)))
    assert all(torch.equal(u, v) for u, v in zip(after, want))
    assert not torch.equal(before[0], after[0])


@pytest.mark.gpu
def test_k2_bf16_kernel_follows_an_in_place_update():
    """The same for K2 bf16's prologue copies (Wr, Wrm, Wx into wr_b,
    wrm_b, wx_b), with the forward residuals held fixed."""
    _card()
    S, T, I, C, R = 3, 4, 37, 200, 130
    p, x, c0, r0, mask, cot = lstm_inputs(S, T, I, C, R, 0.75, seed=8)
    tp = LstmParams(**{k: t(v).cuda() for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous().cuda()
    m8 = torch.from_numpy(mask).transpose(0, 1).to(
        torch.int8).contiguous().cuda()
    c0, r0 = t(c0).cuda(), t(r0).cuda()
    res = lt.lstm_fwd_residuals_cuda(tp, x_tm, c0, r0, m8, 1 / 0.75, 50.0,
                                     compute_dtype=BF16)
    g_r = t(cot[0]).transpose(0, 1).contiguous().cuda()
    gcT = t(cot[1]).cuda()

    def bwd(params):
        out = lt.lstm_bwd_cuda(params, x_tm, c0, r0, *res, m8, 1 / 0.75,
                               g_r, gcT, True, compute_dtype=BF16)
        return (*out[0], *out[1:])

    before = bwd(tp)
    _update_on_card(tp, 9)
    after = bwd(tp)
    want = bwd(LstmParams(*(v.clone() for v in tp)))
    assert all(torch.equal(u, v) for u, v in zip(after, want))
    assert not torch.equal(before[0], after[0])


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,I,C,R", [(3, 4, 37, 200, 130),
                                       (1, 8, 40, 800, 512)])
def test_k1_bf16_kernel_follows_an_in_place_update(S, T, I, C, R):
    """K1 bf16's prologue copies (the interleaved Wr, Wrm, Wx into wr_b,
    wrm_b, wx_b) are made on every call: after an in-place update of the
    parameters, K1 bf16 equals a call on fresh clones (bit for bit: no
    atomics, a fixed order of sums), and differs from the call before."""
    _card()
    p, x, c0, r0, mask, _ = lstm_inputs(S, T, I, C, R, 0.75, seed=10)
    tp = LstmParams(**{k: t(v).cuda() for k, v in p.items()})
    x_tm = t(x).transpose(0, 1).contiguous().cuda()
    m8 = torch.from_numpy(mask).transpose(0, 1).to(
        torch.int8).contiguous().cuda()
    c0, r0 = t(c0).cuda(), t(r0).cuda()

    def fwd(params):
        return lt.lstm_fwd_residuals_cuda(params, x_tm, c0, r0, m8,
                                          1 / 0.75, 50.0,
                                          compute_dtype=BF16)

    before = fwd(tp)
    _update_on_card(tp, 11)
    after = fwd(tp)
    want = fwd(LstmParams(*(v.clone() for v in tp)))
    assert all(torch.equal(u, v) for u, v in zip(after, want))
    assert not torch.equal(before[2], after[2])


# ---------------------------------------------------------------------------
# chip_smoke.py's trace check
# ---------------------------------------------------------------------------

def _entry_of(name: str):
    """The counted entry point chip_smoke.py files a profiler kernel name
    under (its first KERNEL_NAMES entry with a key inside the name)."""
    import chip_smoke
    for entry, keys in chip_smoke.KERNEL_NAMES.items():
        if any(key in name for key in keys):
            return entry
    return None


@pytest.mark.parametrize("source,entries", [
    ("lstmp_train.cu", {"lstmp_train_fwd", "lstmp_train_bwd"}),
    ("lstmp_tc.cuh", {"lstmp_train_fwd", "lstmp_train_bwd"}),
    ("xent_affine.cu", {"xent_affine_fwd", "xent_affine_bwd"}),
    ("lstmp_infer.cu", {"lstmp_infer"}),
])
def test_trace_names_file_every_kernel_under_its_entry_point(source,
                                                             entries):
    """Every __global__ kernel of the counted sources lands under an entry
    point of its own source in phase 5's trace count, with the name the
    profiler shows (a namespace, template arguments, parameters): a key
    that is a substring of another source's kernel name (bwd_dr_kernel
    in xent_bwd_dr_kernel) would move launches between entry points."""
    import os
    import re
    path = os.path.join(os.path.dirname(li.__file__), os.pardir, "csrc",
                        source)
    with open(path) as f:
        text = f.read()
    names = set()
    for m in re.finditer(r"__global__", text):
        k = re.search(r"(\w+_kernel)\s*\(", text[m.end():m.end() + 300])
        names.add(k.group(1))
    assert names
    for name in names:
        shown = f"void (anonymous namespace)::{name}<tc::Bf16>(int)"
        entry = _entry_of(shown)
        assert entry in entries, (name, entry)
        if name.startswith("xent"):   # xent_* (f32) and xent16_* (bf16)
            assert entry.endswith("_fwd" if "fwd" in name else "_bwd")
        if name.startswith(("fwd16_", "bwd16_")):   # K1 / K2 in bf16
            assert entry == ("lstmp_train_fwd" if name.startswith("fwd")
                             else "lstmp_train_bwd"), name
    if source == "lstmp_train.cu":
        assert {"fwd16_prep_kernel", "fwd16_xw_kernel", "fwd16_xw_wg_kernel",
                "fwd16_gates_kernel", "fwd16_proj_kernel"} <= names


# ---------------------------------------------------------------------------
# tools/bench_infer_parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["nobar", "nomma", "nostage", "noepi"])
def test_bench_infer_parts_edits_apply_to_the_sources(variant):
    """Each timing probe of `tools/bench_infer_parts` is textual edits of
    the committed K5 sources; every edit still finds its text (a source
    change that moves it fails here, not on the card)."""
    import os
    from kaldi_lstm_tpu_torch.tools import bench_infer_parts as bp
    from kaldi_lstm_tpu_torch.tools import bench_stack_parts as bs
    edited = bs.variant_sources(variant, bp.VARIANTS)
    assert edited
    for fname, src in edited.items():
        with open(os.path.join(bs._build.CSRC_DIR, fname)) as fh:
            assert src != fh.read()


def test_bench_infer_parts_needs_a_card(monkeypatch):
    from kaldi_lstm_tpu_torch.tools import bench_infer_parts as bp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bp.main([]) == 1


@pytest.mark.parametrize("tool", ["bench_k1_parts", "bf16_seed_sweep"])
def test_k1_bf16_tools_need_a_card(monkeypatch, tool):
    """K1 bf16's timing and seed-sweep tools exit 1 where there is no
    card, and print no result."""
    import importlib
    mod = importlib.import_module(f"kaldi_lstm_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) == 1


# ---------------------------------------------------------------------------
# the tensor core's sums (ops/tc_sum.py) and the tc-exact mirrors, on the
# card
# ---------------------------------------------------------------------------

# chip_smoke.py's TC_SHARE: a bf16 kernel lies within this share of the
# bf16-vs-f32 distance of its tc-exact mirror (its tiles, its tensor
# cores' sums by the model, its cell math as nvcc fuses it)
TC_SHARE = 0.02
PROBE_CASES = {
    # name: (shape, chain depth, with an accumulator)
    "mma_zero": (ts.MMA_SHAPE, 1, False),
    "mma_chained": (ts.MMA_SHAPE, 1, True),
    "wgmma_1": (ts.WGMMA_SHAPE, 1, False),
    "wgmma_4": (ts.WGMMA_SHAPE, 4, False),
    "wgmma_64": (ts.WGMMA_SHAPE, 64, False),
}


@pytest.mark.gpu
def test_cuda_find_params_gives_the_models_constants():
    """find_params on the card settles each instruction's block,
    align_bits and rounding from crafted vectors; they are the constants
    the mirrors use, and the model with them matches the conventions'
    vectors and 2^16 random dot products."""
    _card()
    found = ts.find_params(device="cuda", random_dots=1 << 16)
    for name, const in (("mma", ts.MMA_M16N8K16_BF16),
                        ("wgmma", ts.WGMMA_M64NNK16_BF16)):
        got = found[name]
        assert {k: got[k] for k in const} == const, name
        assert got["conventions"] == 0 and got["random"] == (0, 0), name


@pytest.mark.gpu
@pytest.mark.parametrize("w", [0.04, 0.3])
@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_cuda_model_is_the_tensor_core_bit_for_bit(case, w):
    """tc_dot against probe_mma and probe_wgmma on 2^17 random dot
    products (weights in +-w against activations), every bit equal."""
    _card()
    shape, depth, with_c = PROBE_CASES[case]
    mma = shape == ts.MMA_SHAPE
    count = (1 << 17) // (shape[0] * shape[1])
    got = ts.check(ts.probe_mma if mma else ts.probe_wgmma, shape,
                   ts.MMA_M16N8K16_BF16 if mma else ts.WGMMA_M64NNK16_BF16,
                   depth, count, w, with_c,
                   torch.Generator().manual_seed(depth), "cuda")
    assert got == (0, 0)


def _tc_case(case: str):
    """(params, x_tm, c0, r0, clip) on the card: layer 1 of
    tests/test_torch_lstm_stack.py's make(seed=97) at S=8, T=4, C=800,
    R=512 with its weights scaled to +-w (ROADMAP C.4's data), or the
    flagship training shape with the deep configuration's +-0.04."""
    from test_torch_lstm_stack import make
    if case == "flagship":
        p, x, c0, r0, _, _ = lstm_inputs(256, 20, 40, 800, 512, None, 12)
        tp = LstmParams(**{k: t(v * (0.04 / 0.3)).cuda()
                           for k, v in p.items()})
        return (tp, t(x).transpose(0, 1).contiguous().cuda(), t(c0).cuda(),
                t(r0).cuda(), 50.0)
    I, w = {"c4_i40_w0.3": (40, 0.3), "c4_i1024_w0.04": (1024, 0.04),
            "c4_i1024_w0.3": (1024, 0.3)}[case]
    _, (p1, _, x, s1, _) = make(seed=97, s=8, t=4, i=I, c=800, r=512,
                                device="cuda")
    p1 = LstmParams(*(v * (w / 0.3) for v in p1))
    return p1, x, s1.c, s1.r, 0.4


def _near_mirror(name, got, mirror, plain, f32):
    """RMS of the kernel against its tc-exact mirror within TC_SHARE of
    the bf16-vs-f32 distance; None where it holds, else the miss."""
    got, mirror, plain, f32 = (u.double() for u in (got, mirror, plain,
                                                    f32))
    dist = float((plain - f32).pow(2).mean().sqrt())
    err = float((got - mirror).pow(2).mean().sqrt())
    assert bool(got.isfinite().all()) and dist > 0, name
    print(f"{name}: kernel against its tc-exact mirror / distance "
          f"{err / dist:.4f}")
    return None if err <= TC_SHARE * dist else \
        f"{name}: {err / dist:.4f} of the distance from its tc-exact mirror"


TC_CASES = ["c4_i40_w0.3", "c4_i1024_w0.04", "c4_i1024_w0.3", "flagship"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", TC_CASES)
def test_cuda_k1_k2_bf16_match_their_tc_mirrors(case):
    """K1 bf16 and K2 bf16 (on the bf16 plain forward's residuals, as
    chip_smoke.py's phase 3d feeds it, with dx) against their tc-exact
    mirrors, lstm_fwd_tc_plain and lstm_bwd_split_plain with tc, run on
    the card: every output within TC_SHARE of the distance."""
    _card()
    p, x_tm, c0, r0, clip = _tc_case(case)
    T, S, _ = x_tm.shape
    fa = (p, x_tm, c0, r0, None, 1.0, clip)
    fk = lt.lstm_fwd_residuals_cuda(*fa, compute_dtype=BF16)
    fp = lt.lstm_fwd_residuals_plain(*fa, compute_dtype=BF16)
    f32 = lt.lstm_fwd_residuals_plain(*fa)
    ftc = lt.lstm_fwd_tc_plain(*fa, compute_dtype=BF16, tc=True)
    misses = [_near_mirror(f"K1 {n}", *u) for n, u in zip(
        ("gifo", "c", "r"), zip(fk, ftc, fp, f32))]
    g = torch.Generator().manual_seed(13)
    g_r = torch.randn(T, S, p.recur_dim, generator=g).cuda()
    gcT = torch.randn(S, p.cell_dim, generator=g).cuda()
    ba = (p, x_tm, c0, r0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bk = lt.lstm_bwd_cuda(*ba, *fp, None, 1.0, g_r, gcT, True,
                          compute_dtype=BF16)
    bp = lt.lstm_bwd_plain(*ba, *fp, None, 1.0, g_r, gcT, True,
                           compute_dtype=BF16)
    b32 = lt.lstm_bwd_plain(*ba, *f32, None, 1.0, g_r, gcT, True)
    btc = lt.lstm_bwd_split_plain(*ba, *fp, None, 1.0, g_r, gcT, True,
                                  sms=sms, compute_dtype=BF16, tc=True)
    names = [f"d{f}" for f in LstmParams._fields] + ["dx", "dc0", "dr0"]
    misses += [_near_mirror(f"K2 {n}", *u) for n, u in zip(
        names, zip((*bk[0], *bk[1:]), (*btc[0], *btc[1:]),
                   (*bp[0], *bp[1:]), (*b32[0], *b32[1:])))]
    misses = [m for m in misses if m is not None]
    assert not misses, "\n".join(misses)


@pytest.mark.gpu
@pytest.mark.parametrize("case", TC_CASES)
def test_cuda_k5_bf16_matches_its_tc_mirror(case):
    """K5 bf16 against lstm_infer_tc_plain with tc on the card's SM
    count, run on the card: r and the final c within TC_SHARE of the
    distance."""
    _card()
    p, x_tm, c0, r0, clip = _tc_case(case)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with torch.no_grad():
        r, fin = li.lstm_infer_cuda(p, x_tm, LstmState(c0, r0), clip,
                                    compute_dtype=BF16)
        rp, finp = lstm_scan(p, x_tm, LstmState(c0, r0), clip,
                             compute_dtype=BF16, time_major=True)
        r32, fin32 = lstm_scan(p, x_tm, LstmState(c0, r0), clip,
                               time_major=True)
        rtc, ctc = li.lstm_infer_tc_plain(p, x_tm, c0, r0, clip, sms=sms,
                                          tc=True)
    misses = [_near_mirror("K5 r", r, rtc, rp, r32),
              _near_mirror("K5 c_T", fin.c, ctc, finp.c, fin32.c)]
    misses = [m for m in misses if m is not None]
    assert not misses, "\n".join(misses)
