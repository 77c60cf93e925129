"""The redesigned bf16 kernels of K6 (``lstmp_stack_fwd2_bf16``, K1 bf16's
tiles over both layers of the wavefront) and K7 (``lstmp_stack_infer2_bf16``,
K5 bf16's persistent tensor-core recurrence over both layers) on the CPU:

* K7 bf16's plan (``k7_bf16_plan``, the C planner's mirror) at every
  shape chip_smoke.py and the tests run it: shared memory within an H100
  block's 232,448 bytes, every cell of both layers and every projection
  column of both layers owned by exactly one CTA, the residency cut-over
  of the weight slices in its stated order (layer 2's gate slice first,
  then the projection slice, then layer 1's);
* K6 bf16's tiles (``fwd2_plan(..., bf16=True)``): every output of every
  launch covered once;
* the plain mirrors of both decompositions (``lstm_stack_infer2_tc_plain``:
  the staged [x | r1 | r2] row feeding both layers' gate rows, 16-deep
  slices each from a zero fragment added in f32, the warps' splits in
  warp order; ``lstm_stack_fwd2_tc_plain``: K1 bf16's decomposition over
  each layer, layer 2's xw from r1's rounded copy) against the JAX
  package's ``_infer2_call`` / ``_fwd2_call`` in interpret mode under
  ``set_matmul_dtype(jnp.bfloat16)``, at several plans and time blocks;
* that both mirrors make their bf16 weight copies on every call, so an
  in-place update of the parameters (the optimizer's) is seen.

Tolerance: tests/test_torch_bf16.py's rule (``assert_bf16_close``). The
mirror's error (RMS) is at most a tenth of the bf16-vs-f32 distance (the
JAX reference in bf16 against itself in f32, RMS) on the same inputs,
and that distance must be real (above 1e-5 of the tensor's RMS). The
mirrors sum in other orders than XLA (~1e-7 relative) and may take a rare
bf16 rounding the other way; a missed or added rounding point would move
the error to about the distance itself. The JAX dtype is a module global,
restored to None in a ``finally`` after every bf16 call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_lstm_tpu.models.components import set_matmul_dtype
from kaldi_lstm_tpu.ops import lstm_stack_pallas as w2
from kaldi_lstm_tpu.ops.lstm_pallas import _plan_dims
from kaldi_lstm_tpu_torch.ops import lstm_stack as ls
from kaldi_lstm_tpu_torch.ops.lstm_cell import LstmParams

from test_torch_bf16 import assert_bf16_close
from test_torch_lstm_stack import make

OPTIN = 232448   # an H100 block's shared memory (bytes)
CLIP = 0.4       # small so the clip engages in both layers


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

# K7 bf16 at the deep widths (S = 1, 8, 64, 512; phase 3d's S=200 case),
# the ragged card shape, the wide input whose plan leaves a slice in
# device memory, and the gpu tests' shapes: (S, I, C, R)
K7_SHAPES = [(1, 40, 800, 512), (8, 40, 800, 512), (64, 40, 800, 512),
             (200, 40, 800, 512), (512, 40, 800, 512), (3, 37, 200, 130),
             (8, 1024, 800, 512), (8, 2400, 800, 512), (64, 40, 200, 64),
             (6, 12, 24, 16)]


def _k7_owners(pl: dict, S: int, C: int, R: int):
    """How many CTAs own each (stream, cell) of the gates (both layers
    alike: a gate CTA holds both layers' rows of its cells) and each
    (layer, stream, column) of the projection."""
    gates = np.zeros((S, C), int)
    for b in range(pl["gate_ctas"]):
        j0, sg = (b % pl["gcgroups"]) * pl["ncell"], b // pl["gcgroups"]
        gates[sg * pl["gnsg"]:(sg + 1) * pl["gnsg"],
              j0:j0 + pl["ncell"]] += 1
    proj = np.zeros((2, S, R), int)
    per = pl["qgroups"] * pl["sgroups"]
    for b in range(pl["proj_ctas"]):
        lay, q0 = b // per, (b % per % pl["qgroups"]) * pl["mq"]
        sg = b % per // pl["qgroups"]
        proj[lay, sg * pl["nsg"]:(sg + 1) * pl["nsg"],
             q0:q0 + pl["mq"]] += 1
    return gates, proj


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("S,I,C,R", K7_SHAPES)
def test_k7_bf16_plan_fits_and_deals_every_cell_and_column_once(S, I, C, R,
                                                                sms):
    pl = ls.k7_bf16_plan(S, I, C, R, sms)
    assert pl["smem"] <= OPTIN
    assert pl["grid"] <= sms
    assert pl["grid"] == max(pl["gate_ctas"], pl["proj_ctas"])
    # whole m16 tiles of each layer's gate rows and of projection columns
    assert pl["mg"] == 4 * pl["ncell"] and pl["mg"] % 16 == 0
    assert pl["mq"] % 16 == 0
    assert pl["gnsg"] % 8 == 0 and pl["nsg"] % 8 == 0
    gates, proj = _k7_owners(pl, S, C, R)
    assert (gates == 1).all() and (proj == 1).all()
    # the staged row [x | r1 | r2], each part a multiple of 16: both
    # layers' ranges start on a k16 boundary; rows an odd number of
    # 16-byte units (ldmatrix without bank conflicts)
    assert pl["xp"] % 16 == 0 and pl["xp"] >= I
    assert pl["rp"] % 16 == 0 and pl["rp"] >= R
    assert (pl["kg1"], pl["kg2"], pl["kg"]) == (
        pl["xp"] + pl["rp"], 2 * pl["rp"], pl["xp"] + 2 * pl["rp"])
    assert pl["kq"] % 16 == 0 and pl["kq"] >= pl["cp"] >= C
    for ld in (pl["ksg"], pl["ksq"], pl["kg1"] + 8, pl["kg2"] + 8,
               pl["kq"] + 8):
        assert (ld // 8) % 2 == 1 and ld % 8 == 0
    # staging tiles of whole n8 tiles, at most 64 streams and the group
    assert 8 <= pl["ns_g"] <= min(64, pl["gnsg"]) and pl["ns_g"] % 8 == 0
    assert 8 <= pl["ns_q"] <= min(64, pl["nsg"]) and pl["ns_q"] % 8 == 0
    assert pl["stage_elems"] == max(pl["ns_g"] * pl["ksg"],
                                    pl["ns_q"] * pl["ksq"])
    # the regions of shared memory follow each other, 16-byte aligned,
    # each sized as the kernel uses it
    offs = [0, pl["off_cst"], pl["off_c"], pl["off_g1"], pl["off_q"],
            pl["off_g2"], pl["off_stage"], pl["smem"]]
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)
    # partial sums: 128 floats an output tile and split (units x splits
    # at most max(8, units))
    gate = 2 * (pl["mg"] // 16) * (pl["ns_g"] // 8)
    proj = (pl["mq"] // 16) * (pl["ns_q"] // 8)
    assert pl["off_cst"] == 4 * pl["part_floats"] == \
        4 * 128 * max(8, gate, proj)
    sizes = {"g1": 2 * pl["mg"] * (pl["kg1"] + 8),
             "q": 2 * pl["mq"] * (pl["kq"] + 8),
             "g2": 2 * pl["mg"] * (pl["kg2"] + 8)}
    nxt = {"g1": "off_q", "q": "off_g2", "g2": "off_stage"}
    for name, size in sizes.items():
        held = pl[nxt[name]] - pl[f"off_{name}"]
        assert held == (size if pl[f"res_{name}"] else 0), name
    assert pl["smem"] == pl["off_stage"] + 4 * pl["stage_elems"]


def test_k7_bf16_plan_at_the_deep_widths():
    """At C=800, R=512, I=40 on 132 SMs: 100 gate CTAs of 8 cells of both
    layers, 64 projection CTAs of 16 columns of one layer (128 from S=16:
    two stream groups), every slice resident (36.4 + 25.9 + 66.0 KB),
    one gate stream group at every S (two would not fit), one 8-stream
    tile at S=8 with the c state in shared memory, tiles of 16 at S=512
    with the c state in device memory (it would halve them)."""
    s8 = ls.k7_bf16_plan(8, 40, 800, 512)
    assert (s8["ncell"], s8["gate_ctas"], s8["proj_ctas"]) == (8, 100, 64)
    assert (s8["res_g1"], s8["res_q"], s8["res_g2"], s8["c_smem"]) == \
        (1, 1, 1, 1)
    assert (s8["ns_g"], s8["ns_q"]) == (8, 8)
    assert s8["off_q"] - s8["off_g1"] == 36352
    assert s8["off_g2"] - s8["off_q"] == 25856
    assert s8["off_stage"] - s8["off_g2"] == 66048
    s512 = ls.k7_bf16_plan(512, 40, 800, 512)
    assert (s512["gsgroups"], s512["proj_ctas"], s512["nsg"]) == \
        (1, 128, 256)
    assert (s512["ns_g"], s512["ns_q"], s512["c_smem"]) == (16, 16, 0)
    assert (s512["res_g1"], s512["res_q"], s512["res_g2"]) == (1, 1, 1)


def test_k7_bf16_plan_takes_two_gate_stream_groups_where_they_fit():
    """K5 bf16's rule: two gate stream groups from S=128 where that plan
    keeps every slice resident with tiles of 32 streams or more."""
    two = ls.k7_bf16_plan(128, 8, 12, 8, sms=8)
    assert two["gsgroups"] == 2 and two["gnsg"] == 64
    assert ls.k7_bf16_plan(120, 8, 12, 8, sms=8)["gsgroups"] == 1
    assert ls.k7_bf16_plan(512, 40, 800, 512)["gsgroups"] == 1


def test_k7_bf16_residency_cut_over_follows_its_order():
    """As the input widens at S=8, C=800, R=512, the slices leave shared
    memory in the stated order: layer 2's gate slice first, then the
    projection slice, then layer 1's; each stays while it leaves room for
    two 8-stream staging tiles, and the plan still fits."""
    seen = []
    for i in range(40, 8001, 8):
        try:
            pl = ls.k7_bf16_plan(8, i, 800, 512)
        except ValueError:      # two 8-stream tiles alone no longer fit
            top = i
            break
        assert pl["smem"] <= OPTIN
        res = (pl["res_g1"], pl["res_q"], pl["res_g2"])
        if not seen or seen[-1][1] != res:
            seen.append((i, res))
    assert [r for _, r in seen] == [(1, 1, 1), (1, 1, 0), (1, 0, 0),
                                    (0, 0, 0)]
    # at each cut the slice that left no longer fits beside the tiles
    for i, res in seen[1:]:
        pl = ls.k7_bf16_plan(8, i, 800, 512)
        least = ls._k7_stage_bytes(pl, 8, 8)
        sizes = [2 * pl["mg"] * (pl["kg1"] + 8),
                 2 * pl["mq"] * (pl["kq"] + 8),
                 2 * pl["mg"] * (pl["kg2"] + 8)]
        gone = res.index(0)
        kept = sum(s for s, r in zip(sizes, res) if r)
        assert 4 * 2 * 4 * ((7 * pl["ncell"] + 3) // 4) + kept \
            + sizes[gone] + least > OPTIN
    # the gpu tests' wide cases: layer 2's slice in device memory, the
    # other two resident (I=1024); every slice there (I=2400)
    wide = ls.k7_bf16_plan(8, 1024, 800, 512)
    assert (wide["res_g1"], wide["res_q"], wide["res_g2"]) == (1, 1, 0)
    wider = ls.k7_bf16_plan(8, 2400, 800, 512)
    assert (wider["res_g1"], wider["res_q"], wider["res_g2"]) == (0, 0, 0)
    last = ls.k7_bf16_plan(8, top - 8, 800, 512)
    grow = 2 * 2 * 8 * (-(-top // 16) * 16 - last["xp"])   # two tiles' rows
    assert last["smem"] <= OPTIN < last["smem"] + grow


K6_SHAPES = [(20, 64, 40, 800, 512, 5), (20, 256, 40, 800, 512, 4),
             (20, 512, 40, 800, 512, 2), (2, 3, 37, 200, 130, 1),
             (10, 200, 40, 800, 512, 5), (8, 64, 40, 200, 64, 4)]


@pytest.mark.parametrize("phases", ["both", "l1", "l2"])
@pytest.mark.parametrize("T,S,I,C,R,tb", K6_SHAPES)
def test_k6_bf16_tiles_cover_every_output_once(T, S, I, C, R, tb, phases):
    """K6 bf16's launches: the gates' 64 x 128 tiles (32 cells, the
    interleave's width) over [S, 4 Cp] of each running layer, the
    projection's 32 x 32 over [S, R], xw1 over [T S, 4C] and xw2 over
    [tb S, 4C] on their routes; each output exactly once, the Gemm16
    shared memory within the block's."""
    pl = ls.fwd2_plan(S, C, phases, bf16=True, T=T, I=I, R=R, tb=tb)
    layers = 1 if phases != "both" else 2
    bm, bn = pl["gate_bm"], pl["gate_bn"]
    assert (bm, bn, pl["gate_cells"]) == (64, 128, 32)
    Cp = pl["padded_cells"]
    assert Cp % 32 == 0 and Cp - 32 < C <= Cp
    cover = np.zeros((S, 4 * Cp), int)
    for bx in range(-(-S // bm)):
        for by in range(4 * Cp // bn):
            cover[bx * bm:(bx + 1) * bm, by * bn:(by + 1) * bn] += 1
    assert (cover == 1).all()
    assert pl["gate_ctas"] == layers * (-(-S // bm)) * (4 * Cp // bn)
    proj = np.zeros((S, R), int)
    for bx in range(-(-S // 32)):
        for by in range(-(-R // 32)):
            proj[bx * 32:(bx + 1) * 32, by * 32:(by + 1) * 32] += 1
    assert (proj == 1).all()
    assert pl["proj_ctas"] == layers * (-(-S // 32)) * (-(-R // 32))
    for key, rows, depth in (("xw1", T * S, I), ("xw2", tb * S, R)):
        route = pl[f"{key}_route"]
        assert route == ("wg" if depth > 64 else "mma")
        tile = 128 if route == "wg" else 64
        tiles = -(-rows // tile) * -(-4 * C // tile)
        assert pl[f"{key}_ctas"] == (min(tiles, 132) if route == "wg"
                                     else tiles)
    for key in ("gate_smem", "xw_smem", "proj_smem"):
        assert pl[key] <= OPTIN
    assert ls.wavefront_launches(T, tb, phases) == {
        "both": 2 + T // tb + 2 * (T + tb), "l1": 2 + 2 * T,
        "l2": 1 + T // tb + 2 * T}[phases]


def test_fwd2_plan_in_bf16_needs_the_shape():
    with pytest.raises(ValueError):
        ls.fwd2_plan(64, 800, bf16=True)


# ---------------------------------------------------------------------------
# the mirrors against the JAX package's bf16 kernels
# ---------------------------------------------------------------------------

def _jax_infer2(jx, dims, tb, dtype):
    """_infer2_call in interpret mode under set_matmul_dtype(dtype):
    (r2 [T, S, R], c1T, r1T, c2T), unpadded."""
    S, T, I, C, R = dims
    set_matmul_dtype(dtype)
    try:
        d = _plan_dims(S, T, I, C, R)._replace(tb=tb)
        ops = w2._prep2(*jx, d, True)
        r2, c1T, r1T, c2T = w2._infer2_call(*ops, st=d.st, tb=tb,
                                            cell_clip=CLIP, interpret=True)
    finally:
        set_matmul_dtype(None)
    return (np.asarray(r2)[tb:tb + T, :S, :R], np.asarray(c1T)[:S, :C],
            np.asarray(r1T)[:S, :R], np.asarray(c2T)[:S, :C])


def _jax_fwd2(jx, dims, tb, dtype):
    """_fwd2_call in interpret mode under set_matmul_dtype(dtype), as the
    port returns it (gifo in bf16 under bf16)."""
    S, T, I, C, R = dims
    set_matmul_dtype(dtype)
    try:
        d = _plan_dims(S, T, I, C, R)._replace(tb=tb)
        ops = w2._prep2(*jx, d, True)
        out = w2._fwd2_call(*ops, st=d.st, tb=tb, cell_clip=CLIP,
                            gifo_dtype=dtype or jnp.float32, interpret=True)
    finally:
        set_matmul_dtype(None)
    g1, c1, r1, g2, c2, r2 = (np.asarray(a, np.float32) for a in out)

    def gates(a, lo):
        a = a[lo:lo + T, :S].reshape(T, S, 4, d.cp)[..., :C]
        return a.reshape(T, S, 4 * C)

    return (gates(g1, 0), c1[:T, :S, :C], r1[:T, :S, :R], gates(g2, tb),
            c2[tb:tb + T, :S, :C], r2[tb:tb + T, :S, :R])


def _optin_for_tiles(dims, ns, sms):
    """An opt-in budget whose K7 bf16 plan stages gate tiles of `ns`
    streams, so a small test walks several tiles."""
    S, _, I, C, R = dims
    pl = ls.k7_bf16_plan(S, I, C, R, sms)
    for optin in range(pl["smem"], 0, -16):
        p = ls.k7_bf16_plan(S, I, C, R, sms, optin)
        if p["ns_g"] == ns:
            return optin
    raise AssertionError("no budget gives that tile")


def _optin_without_g2(dims, sms):
    """The largest budget whose K7 bf16 plan keeps layer 2's gate slice
    in device memory."""
    S, _, I, C, R = dims
    pl = ls.k7_bf16_plan(S, I, C, R, sms)
    for optin in range(pl["smem"], 0, -16):
        if not ls.k7_bf16_plan(S, I, C, R, sms, optin)["res_g2"]:
            return optin
    raise AssertionError("no budget drops the slice")


K7_MIRROR_CASES = {
    # name: ((S, T, I, C, R), sms, budget or None, time block)
    "one_cta_per_sm": ((6, 8, 12, 24, 16), 132, None, 4),
    "ragged_few_sms": ((5, 6, 37, 21, 13), 3, None, 3),
    "several_tiles": ((20, 6, 40, 64, 40), 4, "tiles", 2),
    "stream_groups": ((128, 3, 8, 12, 8), 8, None, 3),
    "slices_in_device_memory": ((6, 4, 40, 24, 16), 3, "no_g2", 1),
}


@pytest.mark.parametrize("case", list(K7_MIRROR_CASES))
def test_k7_tc_mirror_matches_infer2_pallas(case):
    """lstm_stack_infer2_tc_plain (K7 bf16's decomposition) against the
    JAX wavefront inference kernel under set_matmul_dtype(bf16),
    interpret mode: r2 for every t and both layers' final state."""
    dims, sms, budget, tb = K7_MIRROR_CASES[case]
    S, T, I, C, R = dims
    jx, port = make(seed=S + I, s=S, t=T, i=I, c=C, r=R)
    optin = {None: OPTIN, "tiles": _optin_for_tiles(dims, 8, sms),
             "no_g2": _optin_without_g2(dims, sms)}[budget]
    pl = ls.k7_bf16_plan(S, I, C, R, sms, optin)
    if case == "several_tiles":
        assert pl["ns_g"] == 8 < S
    if case == "stream_groups":
        assert pl["gsgroups"] == 2 and pl["sgroups"] > 1
    if case == "slices_in_device_memory":
        assert not pl["res_g2"]
    if case == "ragged_few_sms":
        assert pl["grid"] <= 3 and C % pl["ncell"] != 0
    r2, f1, f2 = ls.lstm_stack_infer2_tc_plain(*port, CLIP, sms, optin)
    want = _jax_infer2(jx, dims, tb, jnp.bfloat16)
    want32 = _jax_infer2(jx, dims, tb, None)
    for name, a, b, c in zip(("r2", "c1T", "r1T", "c2T"),
                             (r2, f1.c, f1.r, f2.c), want, want32):
        assert_bf16_close(name, a.numpy(), b, c)
    assert torch.equal(f2.r, r2[T - 1])


@pytest.mark.parametrize("tb", [5, 4, 2, 1])
def test_k6_tc_mirror_matches_fwd2_pallas(tb):
    """lstm_stack_fwd2_tc_plain (K6 bf16's decomposition) against the JAX
    wavefront training forward under set_matmul_dtype(bf16), interpret
    mode, every time block: both layers' residuals."""
    dims = (6, 20, 12, 24, 16)
    S, T, I, C, R = dims
    jx, port = make(seed=120 + tb, s=S, t=T, i=I, c=C, r=R)
    got = ls.lstm_stack_fwd2_tc_plain(*port, CLIP)
    assert got[0].dtype == got[3].dtype == torch.bfloat16
    want = _jax_fwd2(jx, dims, tb, jnp.bfloat16)
    want32 = _jax_fwd2(jx, dims, tb, None)
    for name, a, b, c in zip(("gifo1", "c1", "r1", "gifo2", "c2", "r2"),
                             got, want, want32):
        assert_bf16_close(name, a.float().numpy(), b, c)
    assert bool((got[1].abs() == CLIP).any()), "the clip never engaged"


@pytest.mark.parametrize("phases", ["l1", "l2"])
def test_k6_tc_mirror_phases_are_the_plain_versions(phases):
    """The ablation in the mirror: the live layer as the plain version's
    (K1 bf16's decomposition over that layer, layer 2 over r1 = 0 with
    "l2"), the left-out layer zero."""
    _, port = make(seed=130)
    got = ls.lstm_stack_fwd2_tc_plain(*port, CLIP, phases=phases)
    want = ls.lstm_stack_fwd2_plain(*port, CLIP, phases=phases,
                                    compute_dtype=torch.bfloat16)
    live = slice(0, 3) if phases == "l1" else slice(3, 6)
    dead = slice(3, 6) if phases == "l1" else slice(0, 3)
    for a, b in zip(got[live], want[live]):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-5,
                                   atol=1e-5)
    assert all(not t.any() for t in got[dead])


# ---------------------------------------------------------------------------
# no stale weights
# ---------------------------------------------------------------------------

def _update_in_place(tp: LstmParams, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for v in tp:
            v.add_(0.05 * torch.randn(v.shape, generator=g))


def _fresh(p: LstmParams) -> LstmParams:
    return LstmParams(*(v.clone() for v in p))


@pytest.mark.parametrize("mirror", ["k6", "k7"])
def test_stack_bf16_copies_follow_an_in_place_update(mirror):
    """The bf16 weight copies of both layers are made on every call:
    after an in-place update of the parameters (as the optimizer makes),
    the next call equals a call on fresh tensors holding the new values,
    and differs from the call before the update."""
    _, (p1, p2, x, s1, s2) = make(seed=140, s=5, t=4, i=37, c=21, r=13)

    def run(q1, q2):
        if mirror == "k6":
            return ls.lstm_stack_fwd2_tc_plain(q1, q2, x, s1, s2, CLIP)
        r2, f1, f2 = ls.lstm_stack_infer2_tc_plain(q1, q2, x, s1, s2, CLIP,
                                                   sms=3)
        return r2, f1.c, f1.r, f2.c

    before = run(p1, p2)
    _update_in_place(p1, 141)
    _update_in_place(p2, 142)
    after = run(p1, p2)
    want = run(_fresh(p1), _fresh(p2))
    assert all(torch.equal(u, v) for u, v in zip(after, want))
    assert not torch.equal(before[-1], after[-1])


def test_k7_tc_mirror_state_is_not_written_in_place():
    """The mirror (as the kernel's wrapper) leaves the caller's states as
    they were."""
    _, (p1, p2, x, s1, s2) = make(seed=150)
    keep = [t.clone() for t in (*s1, *s2)]
    ls.lstm_stack_infer2_tc_plain(p1, p2, x, s1, s2, CLIP)
    assert all(torch.equal(a, b) for a, b in zip(keep, (*s1, *s2)))
