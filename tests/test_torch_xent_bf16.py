"""The bf16 K3/K4 (``xent_affine_fwd_bf16`` / ``xent_affine_bwd_bf16``:
operands rounded once into bf16 copies, dz stored in bf16, every product
on wgmma fed by TMA, csrc/wg_gemm.cuh) on the CPU:

* their plan (``xent_bf16_plan``) at every shape chip_smoke.py and the
  tests run: each (row tile, class tile) of the logits walk, each dr
  tile and each dW tile owned by exactly one item, the bf16 copies'
  leading dimensions multiples of 8;
* the mirror of the backward's sum order (``xent_bwd_bf16_split_plain``:
  dz rounded once, db from the f32 dz split by 128-frame tile and the
  tiles added in order) against the JAX package's bf16 kernels
  (``xent_pallas.fused_affine_xent`` under ``set_matmul_dtype(bf16)``,
  interpret mode), and against ``xent_bwd_plain`` in bf16;
* the launch counts of ``xent_launches`` against the launches the C
  entry points make; ``tools/bench_xent_parts``'s source edits;

and on a card (``gpu``): first-max ties across a quad's lanes, within a
thread, across a tile edge and across a chunk edge, exact in bf16; two
calls bitwise equal; an in-place update of W seen by the next call.

Tolerance against JAX: tests/test_torch_bf16.py's rule (the port's RMS
error within a tenth of the RMS bf16-vs-f32 distance of the reference on
the same inputs, the distance itself real). Where a bias of 200 lets one
class take the whole softmax, bf16 cannot move db (the distance
vanishes), and db is held to float32's resolution instead (1e-6 of its
RMS, tests/test_torch_bf16.py's F32_FLOOR). Against the plain version:
1e-5 of each tensor's largest entry (the same roundings, other f32 sum
orders).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.models.components import set_matmul_dtype
from kaldi_lstm_tpu.ops.xent_pallas import fused_affine_xent as j_fused
from kaldi_lstm_tpu_torch.ops import xent_affine as xa
from kaldi_lstm_tpu_torch.ops.lstm_cell import rounded

from test_torch_bf16 import BF16, F32_FLOOR, assert_bf16_close, rms

# (N, R, K): chip_smoke.py's phase 3d, 5c, 6 and 10d shapes, the class
# shards of phase 13, the gpu tests' and this file's
PLAN_SHAPES = [
    (5120, 512, 8000), (5120, 512, 16624), (5120, 512, 3999),
    (1001, 136, 1003), (1001, 130, 1000), (2560, 512, 4000),
    (2560, 512, 3999), (1024, 1024, 8000), (256, 1024, 8000),
    (40, 16, 2148), (5120, 16, 2148), (70, 64, 300), (24, 6, 5),
    (37, 130, 1003), (1, 8, 1), (128, 128, 128), (129, 129, 129),
]


@pytest.fixture(autouse=True)
def reset_jax_dtype():
    yield
    set_matmul_dtype(None)


@pytest.mark.parametrize("N,R,K", PLAN_SHAPES)
def test_xent_bf16_plan_covers_every_tile_once(N, R, K):
    pl = xa.xent_bf16_plan(N, R, K)
    T = xa.TILE16
    nrt, nct, njt = -(-N // T), -(-K // T), -(-R // T)
    assert (pl["nrt"], pl["nct"], pl["njt"]) == (nrt, nct, njt)
    assert pl["chunk"] % T == 0 and pl["nch"] == -(-K // pl["chunk"])
    # the logits walk: items (row tile fastest, then chunk), each chunk's
    # 128-class tiles; every (row tile, class tile) exactly once
    seen = {}
    for it in range(pl["logits_items"]):
        rt, ch = it % nrt, it // nrt
        c_end = min(K, (ch + 1) * pl["chunk"])
        for c0 in range(ch * pl["chunk"], c_end, T):
            seen[(rt, c0 // T)] = seen.get((rt, c0 // T), 0) + 1
    assert seen == {(rt, ct): 1 for rt in range(nrt) for ct in range(nct)}
    # dr: (column tile fastest, then row tile), each once; dW: (column
    # tile fastest, then class tile), each once
    tiles = {(it // njt, it % njt) for it in range(pl["dr_items"])}
    assert pl["dr_items"] == nrt * njt and tiles == {
        (rt, jt) for rt in range(nrt) for jt in range(njt)}
    assert pl["dw_items"] == nct * njt
    for key in ("logits", "dr", "dw"):
        assert pl[f"{key}_grid"] == min(pl[f"{key}_items"], pl["sms"])
    assert pl["r_ld"] % 8 == 0 and R <= pl["r_ld"] < R + 8
    assert pl["dz_ld"] % 8 == 0 and K <= pl["dz_ld"] < K + 8


def _entry_launches(fn: str) -> int:
    """The kernel launches a C function of csrc/xent_affine.cu makes: its
    `<<<` and its calls of launch_prep (one launch each)."""
    path = os.path.join(os.path.dirname(xa.__file__), os.pardir, "csrc",
                        "xent_affine.cu")
    with open(path) as f:
        src = f.read()
    m = re.search(r"\nint " + fn + r"\(.*?\n}\n", src, re.S)
    body = m.group(0)
    return body.count("<<<") + body.count("launch_prep(")


def test_launch_counts_are_the_entry_points_launches():
    assert xa.xent_launches(bf16=True) == (_entry_launches("xent16_fwd"),
                                           _entry_launches("xent16_bwd"))
    assert xa.xent_launches(bf16=False) == (2, 3)
    # the CPU path launches nothing and counts a plain call per half
    g = torch.Generator().manual_seed(0)
    r = torch.randn(6, 8, generator=g).requires_grad_()
    w = (torch.randn(5, 8, generator=g) * 0.3).requires_grad_()
    b = torch.zeros(5, requires_grad=True)
    xa.reset_counts()
    ids = torch.zeros(6, 1, dtype=torch.int32)
    loss, _ = xa.fused_affine_xent(r, w, b, ids, torch.ones(6, 1),
                                   torch.ones(6), compute_dtype=BF16)
    loss.backward()
    assert (xa.FWD_BF16_LAUNCHES, xa.BWD_BF16_LAUNCHES,
            xa.PLAIN_CALLS) == (0, 0, 2)


# ---------------------------------------------------------------------------
# the backward's sum order against JAX and against the plain version
# ---------------------------------------------------------------------------

# name: (N, R, K, Km, mask_p, bias_scale, targets outside [0, K))
MIRROR_CASES = {
    # K = 300: three class tiles, the last ragged
    "ragged_masked_half_outside": (70, 64, 300, 2, 0.5, 0.1, True),
    # R = 130 (4-byte rows, TMA's zero fill past R), K off every tile
    "r130_k1003": (37, 130, 1003, 2, 0.8, 0.1, False),
    # exp(bias) overflows float32: no NaN, db pinned by one class
    "bias200": (24, 8, 300, 2, 0.5, 200.0, True),
    # db over five frame tiles, the last ragged; K under one tile, Km 1
    "five_frame_tiles_km1": (600, 8, 64, 1, 0.7, 0.1, False),
    # one whole tile each way, every frame kept
    "one_tile_unmasked": (128, 128, 128, 2, 1.0, 0.1, True),
    # R = 136 (lines padded to 8), two frame tiles, the second 2 rows
    "r136_two_frame_tiles": (130, 136, 515, 2, 0.6, 0.1, True),
    # R = 16, K a tile and one class past it
    "k129_narrow": (40, 16, 129, 1, 0.5, 0.1, True),
}


def _mirror_inputs(N, R, K, Km, mask_p, bias_scale, outside, seed=7):
    rng = np.random.RandomState(seed)
    r = rng.randn(N, R).astype(np.float32)
    w = (rng.randn(K, R) * 0.3).astype(np.float32)
    b = (rng.randn(K) * bias_scale).astype(np.float32)
    ids = rng.randint(0, K, (N, Km)).astype(np.int32)
    if outside:
        # targets in another class shard: past the padded classes of the
        # Pallas kernel and below 0; they add no one-hot anywhere
        ids[::3, 0] = K + 500
        ids[1::5, -1] = -3
    tw = rng.rand(N, Km).astype(np.float32)
    mask = (rng.rand(N) < mask_p).astype(np.float32)
    assert (mask == 0).any() or mask_p == 1.0
    return r, w, b, ids, tw, mask


def _jax_grads(r, w, b, ids, tw, mask, dtype):
    """dr, dW, db of the JAX fused op (interpret mode) under
    set_matmul_dtype(dtype), for a loss cotangent of 1."""
    set_matmul_dtype(dtype)
    try:
        (_, aux), vjp = jax.vjp(
            lambda a, c, d: j_fused(a, c, d, jnp.asarray(ids),
                                    jnp.asarray(tw), jnp.asarray(mask),
                                    True),
            jnp.asarray(r), jnp.asarray(w), jnp.asarray(b))
        g = vjp((jnp.float32(1.0),
                 jax.tree_util.tree_map(jnp.zeros_like, aux)))
        return [np.asarray(v) for v in g]
    finally:
        set_matmul_dtype(None)


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_split_mirror_matches_pallas_bf16(case):
    N, R, K, Km, mask_p, bias_scale, outside = MIRROR_CASES[case]
    r, w, b, ids, tw, mask = _mirror_inputs(*MIRROR_CASES[case])
    j16 = _jax_grads(r, w, b, ids, tw, mask, jnp.bfloat16)
    j32 = _jax_grads(r, w, b, ids, tw, mask, None)
    t = [torch.from_numpy(a) for a in (r, w, b, ids, tw, mask)]
    lse = xa.xent_fwd_plain(*t[:5], compute_dtype=BF16)[0]
    got = xa.xent_bwd_bf16_split_plain(*t[:5], lse, t[5], t[4].sum(-1))
    for name, a, ref16, ref32 in zip(("dr", "dW", "db"), got, j16, j32):
        a = a.numpy()
        assert np.isfinite(a).all(), name
        if name == "db" and bias_scale > 100:
            assert_bf16_close(name, a, ref16, ref32,
                              floor=F32_FLOOR * (rms(ref16) + 1e-30))
        else:
            assert_bf16_close(name, a, ref16, ref32)
    # masked frames give dz = 0 exactly: their dr rows are 0
    assert not got[0][t[5] == 0].any()


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_split_mirror_matches_plain_bf16(case):
    r, w, b, ids, tw, mask = (torch.from_numpy(a) for a in _mirror_inputs(
        *MIRROR_CASES[case]))
    lse = xa.xent_fwd_plain(r, w, b, ids, tw, compute_dtype=BF16)[0]
    args = (r, w, b, ids, tw, lse, mask, tw.sum(-1))
    want = xa.xent_bwd_plain(*args, compute_dtype=BF16)
    got = xa.xent_bwd_bf16_split_plain(*args)
    for a, ref in zip(got, want):
        assert float((a - ref).abs().max()) <= \
            1e-5 * float(ref.abs().max())


def test_split_mirror_sums_db_from_the_f32_dz():
    """db comes from the float32 dz, not from its bf16 rounding: with
    target weights of 1/3 (not a bf16 value) the rounded dz's column sums
    move off db by far more than the float32 sum orders do."""
    r, w, b, ids, tw, mask = (torch.from_numpy(a) for a in _mirror_inputs(
        *MIRROR_CASES["five_frame_tiles_km1"]))
    tw = torch.full_like(tw, 1.0 / 3.0)
    lse = xa.xent_fwd_plain(r, w, b, ids, tw, compute_dtype=BF16)[0]
    args = (r, w, b, ids, tw, lse, mask, tw.sum(-1))
    db = xa.xent_bwd_bf16_split_plain(*args)[2]
    z = rounded(r, BF16) @ rounded(w, BF16).T + b
    dz = torch.exp(z - lse[:, None]) * tw.sum(-1)[:, None]
    dz.scatter_add_(1, ids.long(), -tw)
    dz = dz * mask[:, None]
    ref = dz.double().sum(0)
    rounded_sum = rounded(dz, BF16).double().sum(0)
    err = float((db.double() - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max())
    assert float((rounded_sum - ref).abs().max()) > 10 * err


# ---------------------------------------------------------------------------
# tools/bench_xent_parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["noepi_fwd", "noepi_dz"])
def test_bench_xent_parts_edits_apply_to_the_source(variant):
    """Each timing probe of `tools/bench_xent_parts` is a textual edit of
    csrc/xent_affine.cu; every edit still finds its text (a source change
    that moves it fails here, not on the card)."""
    from kaldi_lstm_tpu_torch.tools import bench_stack_parts as bs
    from kaldi_lstm_tpu_torch.tools import bench_xent_parts as bx
    edited = bs.variant_sources(variant, bx.VARIANTS)
    with open(os.path.join(bs._build.CSRC_DIR, "xent_affine.cu")) as fh:
        assert edited["xent_affine.cu"] != fh.read()


def test_bench_xent_parts_needs_a_card(monkeypatch):
    from kaldi_lstm_tpu_torch.tools import bench_xent_parts as bx
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bx.main([]) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bf16 K3/K4 run only there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.gpu
@pytest.mark.parametrize("N,edge", [(40, "quad"), (40, "thread"),
                                    (40, "tile"), (5120, "tile"),
                                    (5120, "chunk")])
def test_cuda_bf16_argmax_tie_across_edges(N, edge):
    """Exact ties (small integers and eighths: exact in bf16, and every
    sum exact in f32) between neighbouring classes: across the 4 lanes of
    a quad (63/64), between two columns of one thread (64/65), across a
    128-class tile edge (127/128) and across the edge between two class
    chunks of the plan (chunk - 1 / chunk). The kernel keeps the first,
    and lse, picked and the max equal the plain version's."""
    from test_torch_xent_affine import tie_inputs
    _card()
    K = 2148
    chunk = xa.xent_bf16_plan(N, 16, K, _sms())["chunk"]
    tie_at = {"quad": 63, "thread": 64, "tile": 127,
              "chunk": chunk - 1}[edge]
    if edge == "chunk":
        assert chunk < K - 1
    r, w, b, ids, tw = (torch.tensor(a, device="cuda") for a in tie_inputs(
        N, 16, K, tie_at))
    xa.reset_counts()
    fk = xa.xent_fwd_cuda(r, w, b, ids, tw, compute_dtype=BF16)
    fp = xa.xent_fwd_plain(r, w, b, ids, tw, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert xa.FWD_BF16_LAUNCHES == xa.xent_launches(bf16=True)[0]
    assert int(fk[3][0]) == tie_at
    assert torch.equal(fk[3], fp[3])
    torch.testing.assert_close(fk[2], fp[2], rtol=0, atol=0)
    for a, ref in zip(fk[:2], fp[:2]):
        torch.testing.assert_close(a, ref, rtol=1e-5, atol=1e-5)


def _card_case(N, R, K, Km, seed):
    g = torch.Generator().manual_seed(seed)
    r = torch.randn(N, R, generator=g)
    w = torch.randn(K, R, generator=g) * 0.05
    b = torch.randn(K, generator=g) * 0.1
    ids = torch.randint(0, K, (N, Km), generator=g).to(torch.int32)
    tw = torch.rand(N, Km, generator=g)
    scale = (torch.rand(N, generator=g) < 0.5).float()
    return [t.cuda() for t in (r, w, b, ids, tw, scale)]


def _both(r, w, b, ids, tw, scale):
    fwd = xa.xent_fwd_cuda(r, w, b, ids, tw, compute_dtype=BF16)
    bwd = xa.xent_bwd_cuda(r, w, b, ids, tw, fwd[0], scale, tw.sum(-1),
                           compute_dtype=BF16)
    torch.cuda.synchronize()
    return (*fwd, *bwd)


@pytest.mark.gpu
@pytest.mark.parametrize("N,R,K,Km", [(1001, 130, 1003, 2),
                                      (5120, 512, 8000, 1)])
def test_cuda_bf16_two_calls_are_bitwise_equal(N, R, K, Km):
    """No float atomics: every output is summed in a fixed order (the
    grouped bf16 step's replays rely on it)."""
    _card()
    args = _card_case(N, R, K, Km, 11)
    first, second = _both(*args), _both(*args)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.gpu
def test_cuda_bf16_follows_an_in_place_update():
    """The bf16 copies of r and W are made on every call: after an
    in-place update of W (the optimizer's), the next call equals, bit for
    bit, a call on fresh clones, and differs from the call before."""
    _card()
    r, w, b, ids, tw, scale = _card_case(1001, 136, 1003, 2, 12)
    before = _both(r, w, b, ids, tw, scale)
    g = torch.Generator().manual_seed(13)
    with torch.no_grad():
        w.add_(0.05 * torch.randn(w.shape, generator=g).cuda())
    after = _both(r, w, b, ids, tw, scale)
    want = _both(r, w.clone(), b, ids, tw, scale)
    assert all(torch.equal(u, v) for u, v in zip(after, want))
    assert not torch.equal(before[0], after[0])
    assert not torch.equal(before[5], after[5])
