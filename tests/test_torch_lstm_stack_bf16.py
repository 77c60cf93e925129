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

import functools
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
                                     "unroll4", "nobar16", "nogates16",
                                     "noproj16", "cfirst16",
                                     "g2dev16", "nomma16", "rolled16"])
def test_bench_stack_parts_edits_apply_to_the_sources(variant):
    """Each timing probe of `tools/bench_stack_parts` is one textual edit
    of the committed K7 source (the f32 kernel's, or with a 16 suffix the
    bf16 kernel's); every edit still finds its text."""
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
    miss = _card_miss(name, got, ref, ref32, ref64)
    assert miss is None, miss


def _card_miss(name, got, ref, ref32, ref64):
    """_card_close's rule: None where it holds, else what missed."""
    got, ref, ref32, ref64 = (np.asarray(t.double().cpu()) for t in
                              (got, ref, ref32, ref64))
    err, dist, noise = rms(got - ref), rms(ref - ref32), rms(ref64 - ref)
    assert np.isfinite(got).all(), name
    assert dist > 1e-6 * rms(ref), name
    if err <= max(SHARE * dist, 2.0 * noise):
        return None
    return (f"{name}: error {err:.3e}, distance {dist:.3e} (error / "
            f"distance {err / dist:.4f}), noise {noise:.3e}")


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


def _mirrors_close(what, got, plain, plain32, plain64, mirror, names):
    """The kernel against its bf16 plain version and against its mirror,
    each by the card's rule (_card_close: the noise is the plain
    version's f32-vs-f64 distance, which another valid f32 order, the
    mirror's or the kernel's, may take). Every output is compared before
    the test fails, and the failure lists each miss."""
    misses = []
    for name, a, b, c, d, m in zip(names, got, plain, plain32, plain64,
                                   mirror):
        misses.append(_card_miss(f"{what} {name} vs plain", a, b, c, d))
        misses.append(_card_miss(f"{what} {name} vs mirror", a, m, c, d))
    return [m for m in misses if m is not None]


@pytest.mark.gpu
@pytest.mark.parametrize("dims,tb", [((3, 2, 37, 200, 130), 1),
                                     ((8, 4, 40, 800, 512), 2),
                                     ((40, 3, 40, 800, 512), 3)])
def test_cuda_bf16_kernels_match_plain_and_mirrors(cuda_device, dims, tb):
    """K6 bf16 and K7 bf16 against their bf16 plain versions and their
    mirrors (``lstm_stack_fwd2_tc_plain``, ``lstm_stack_infer2_tc_plain``
    on the card's SM count), ragged (4-byte copies, ragged tiles) and at
    the deep widths with the deep configuration's weight scale (S=40: K7
    stages 3 tiles), launch counts exact. At make()'s +-0.3 the deep
    widths take test_cuda_bf16_kernels_by_the_cpu_order_witness's rule."""
    S, T, I, C, R = dims
    _, port = make(seed=97, s=S, t=T, i=I, c=C, r=R, device=cuda_device)
    if C == 800:       # the deep configuration's weight scale, 0.04
        with torch.no_grad():
            for v in (*port[0], *port[1]):
                v.mul_(0.04 / 0.3)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ls.reset_counts()
    got = ls.lstm_stack_fwd2(*port, CLIP, tb=tb, compute_dtype=BF16)
    r2, f1, f2 = ls.lstm_stack_infer2(*port, CLIP, tb=tb, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert (ls.FWD2_BF16_LAUNCHES, ls.INFER2_BF16_LAUNCHES,
            ls.FWD2_LAUNCHES, ls.INFER2_LAUNCHES, ls.PLAIN_CALLS) == \
        (ls.wavefront_launches(T, tb), 1, 0, 0, 0)
    assert ls.infer2_plan(S, I, C, R, bf16=True) == \
        ls.k7_bf16_plan(S, I, C, R, sms)
    misses = _mirrors_close(
        "K6", got, ls.lstm_stack_fwd2_plain(*port, CLIP, compute_dtype=BF16),
        ls.lstm_stack_fwd2_plain(*port, CLIP),
        ls.lstm_stack_fwd2_plain(*_f64(port), CLIP, compute_dtype=BF16),
        ls.lstm_stack_fwd2_tc_plain(*port, CLIP), NAMES)

    def parts(o):     # phase 3d's (r2T is r2's last row)
        return o[0], o[1].c, o[1].r, o[2].c

    assert torch.equal(f2.r, r2[T - 1])
    misses += _mirrors_close(
        "K7", (r2, f1.c, f1.r, f2.c),
        parts(ls.lstm_stack_infer2_plain(*port, CLIP, compute_dtype=BF16)),
        parts(ls.lstm_stack_infer2_plain(*port, CLIP)),
        parts(ls.lstm_stack_infer2_plain(*_f64(port), CLIP,
                                         compute_dtype=BF16)),
        parts(ls.lstm_stack_infer2_tc_plain(*port, CLIP, sms=sms)),
        ("r2", "c1T", "r1T", "c2T"))
    assert not misses, "\n".join(misses)


# chip_smoke.py's TC_SHARE: a bf16 kernel lies within this share of the
# bf16-vs-f32 distance of its tc-exact mirror (its tiles, its tensor
# cores' sums by ops/tc_sum.py's model, which phase 3e holds to the card
# bit for bit, and its cell math as nvcc fuses it)
TC_SHARE = 0.02


@pytest.mark.gpu
@pytest.mark.parametrize("I,w", [(40, 0.3), (1024, 0.04), (1024, 0.3)])
def test_cuda_bf16_kernels_by_the_cpu_order_witness(cuda_device, I, w):
    """K6 bf16 and K7 bf16 at the deep widths (S=8, T=4, tb=2) with the
    weights uniform in +-w (make()'s 0.3, the deep configuration's 0.04)
    and a wide input (I=1024: K6's xw1 on the wgmma route, K7's layer-2
    gate slice in device memory), by chip_smoke.py's bf16 rule with two
    more noise witnesses, as its phase 3d holds every bf16 kernel: error
    <= max(0.1 x distance, 2 x noise), the noise the largest of the f64
    sum's, the CPU's f32 order's and the tc-exact mirror's distance from
    the plain version on the card; and each kernel within TC_SHARE of
    the distance from its tc-exact mirror (ROADMAP C.4: at +-0.3, I=40
    the kernels sit 0.11-0.19 of the distance off the plain version, the
    f64 sum and the CPU order at most 0.0103, and the tc-exact mirror,
    the sums the card's tensor cores make, where the kernels are).
    Every output's ratios are printed; launch counts exact."""
    S, T, C, R, tb = 8, 4, 800, 512, 2
    _, port = make(seed=97, s=S, t=T, i=I, c=C, r=R, device=cuda_device)
    with torch.no_grad():
        for v in (*port[0], *port[1]):
            v.mul_(w / 0.3)
    cpu = tuple(type(t)(*(v.cpu() for v in t)) if isinstance(t, tuple)
                else t.cpu() for t in port)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ls.reset_counts()
    k6 = ls.lstm_stack_fwd2(*port, CLIP, tb=tb, compute_dtype=BF16)
    r2, f1, f2 = ls.lstm_stack_infer2(*port, CLIP, tb=tb, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert (ls.FWD2_BF16_LAUNCHES, ls.INFER2_BF16_LAUNCHES,
            ls.PLAIN_CALLS) == (ls.wavefront_launches(T, tb), 1, 0)

    def parts(o):     # phase 3d's (r2T is r2's last row)
        return o[0], o[1].c, o[1].r, o[2].c

    assert torch.equal(f2.r, r2[T - 1])
    misses = []
    for what, got, plain, mirror, pick, names in (
            ("K6", k6, ls.lstm_stack_fwd2_plain, ls.lstm_stack_fwd2_tc_plain,
             tuple, NAMES),
            ("K7", (r2, f1.c, f1.r, f2.c), ls.lstm_stack_infer2_plain,
             functools.partial(ls.lstm_stack_infer2_tc_plain, sms=sms),
             parts, ("r2", "c1T", "r1T", "c2T"))):
        ref = pick(plain(*port, CLIP, compute_dtype=BF16))
        ref32 = pick(plain(*port, CLIP))
        ref64 = pick(plain(*_f64(port), CLIP, compute_dtype=BF16))
        other = pick(plain(*cpu, CLIP, compute_dtype=BF16))
        tc = pick(mirror(*port, CLIP, tc=True))
        for name, a, b, c, d, o, m in zip(names, got, ref, ref32, ref64,
                                          other, tc):
            a, b, c, d, o, m = (np.asarray(t.double().cpu())
                                for t in (a, b, c, d, o, m))
            err, dist = rms(a - b), rms(b - c)
            noise, wit, tcw = rms(d - b), rms(o - b), rms(m - b)
            assert np.isfinite(a).all() and dist > 1e-6 * rms(b), name
            line = (f"{what} {name} I={I} w={w}: error / distance "
                    f"{err / dist:.4f}, f64 noise / distance "
                    f"{noise / dist:.4f}, CPU-order witness / distance "
                    f"{wit / dist:.4f}, tc-exact witness / distance "
                    f"{tcw / dist:.4f}, kernel against its tc-exact mirror "
                    f"/ distance {rms(a - m) / dist:.4f}")
            print(line)
            if not err <= max(SHARE * dist, 2.0 * max(noise, wit, tcw)):
                misses.append(line)
            if not rms(a - m) <= TC_SHARE * dist:
                misses.append(line + " (off its tc-exact mirror)")
    # the two kernels' r2 against each other (both on mma.sync), beside
    # their distance from the plain version
    ref = ls.lstm_stack_infer2_plain(*port, CLIP, compute_dtype=BF16)[0]
    ref32 = ls.lstm_stack_infer2_plain(*port, CLIP)[0]
    dist = rms(np.asarray((ref - ref32).double().cpu()))
    print(f"K7 r2 against K6 r2 I={I} w={w}: / distance "
          f"{rms(np.asarray((r2 - k6[5]).double().cpu())) / dist:.4f}")
    assert not misses, "\n".join(misses)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,dims", [("K6", (512, 20, 40, 800, 512)),
                                         ("K7", (8, 20, 40, 800, 512))])
def test_cuda_stack_bf16_kernels_match_their_tc_mirrors_at_full_width(
        cuda_device, kernel, dims):
    """At the deep configuration's widths and weight scale (+-0.04, cell
    clip 50): K6 bf16 at S=512, T=20 and K7 bf16 at S=8, T=20 (its
    mirror walks the plan CTA by CTA) within TC_SHARE of the distance of
    their tc-exact mirrors."""
    S, T, I, C, R = dims
    _, port = make(seed=98, s=S, t=T, i=I, c=C, r=R, device=cuda_device)
    with torch.no_grad():
        for v in (*port[0], *port[1]):
            v.mul_(0.04 / 0.3)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count

    def parts(o):     # phase 3d's K7 outputs (r2T is r2's last row)
        return o if kernel == "K6" else (o[0], o[1].c, o[1].r, o[2].c)

    if kernel == "K6":
        got = ls.lstm_stack_fwd2(*port, 50.0, tb=5, compute_dtype=BF16)
        mirror = ls.lstm_stack_fwd2_tc_plain(*port, 50.0, tc=True)
        plain = ls.lstm_stack_fwd2_plain
    else:
        got = ls.lstm_stack_infer2(*port, 50.0, tb=5, compute_dtype=BF16)
        mirror = ls.lstm_stack_infer2_tc_plain(*port, 50.0, sms=sms,
                                               tc=True)
        plain = ls.lstm_stack_infer2_plain
    torch.cuda.synchronize()
    got, mirror = parts(got), parts(mirror)
    ref = parts(plain(*port, 50.0, compute_dtype=BF16))
    ref32 = parts(plain(*port, 50.0))
    misses = []
    for a, m, b, c in zip(got, mirror, ref, ref32):
        a, m, b, c = (np.asarray(t.double().cpu()) for t in (a, m, b, c))
        ratio = rms(a - m) / rms(b - c)
        print(f"{kernel} at {dims}: kernel against its tc-exact mirror / "
              f"distance {ratio:.4f}")
        if not ratio <= TC_SHARE:
            misses.append(f"{ratio:.4f}")
    assert not misses, misses


@pytest.mark.gpu
def test_cuda_k6_bf16_step_by_step_at_wide_weights(cuda_device):
    """test_cuda_bf16_kernels_by_the_cpu_order_witness's case at make()'s
    +-0.3 (S=8, T=4, I=40, seed 97) held step by step: each step t of K6
    bf16's layers against the plain version's step t from the kernel's
    own c_{t-1}, r_{t-1} (layer 2's input the kernel's r1), by the card's
    rule, the noise that step summed in f64. A rounding that the kernel
    takes the other way is not carried into later steps here, so a step
    computed wrong shows, and a divergence carried through the
    recurrence does not."""
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    S, T, I, C, R = 8, 4, 40, 800, 512
    _, (p1, p2, x, s1, s2) = make(seed=97, s=S, t=T, i=I, c=C, r=R,
                                  device=cuda_device)
    got = ls.lstm_stack_fwd2(p1, p2, x, s1, s2, CLIP, tb=2,
                             compute_dtype=BF16)
    torch.cuda.synchronize()

    def steps(p, xs, st, res, dt, dbl=False):
        out = []
        for t in range(T):
            a = (p, xs[t:t + 1], st.c if t == 0 else res[1][t - 1],
                 st.r if t == 0 else res[2][t - 1])
            if dbl:
                a = (type(p)(*(v.double() for v in p)),
                     *(v.double() for v in a[1:]))
            out.append(lt.lstm_fwd_residuals_plain(*a, None, 1.0, CLIP,
                                                   compute_dtype=dt))
        return tuple(torch.cat([o[i] for o in out]) for i in range(3))

    misses = []
    for layer, p, xs, st, res in ((1, p1, x, s1, got[:3]),
                                  (2, p2, got[2], s2, got[3:])):
        ref = steps(p, xs, st, res, BF16)
        ref32 = steps(p, xs, st, res, None)
        ref64 = steps(p, xs, st, res, BF16, dbl=True)
        for name, a, b, c, d in zip(("gifo", "c", "r"), res, ref, ref32,
                                    ref64):
            misses.append(_card_miss(f"K6 layer {layer} {name} step by step",
                                     a, b, c, d))
    misses = [m for m in misses if m is not None]
    assert not misses, "\n".join(misses)


@pytest.mark.gpu
@pytest.mark.parametrize("I,held", [(1024, (1, 1, 0)), (2400, (0, 0, 0))])
def test_cuda_k7_bf16_slices_in_device_memory(cuda_device, I, held):
    """At a wide input K7 bf16's plan leaves slices in device memory
    (layer 2's gate slice at I=1024; every slice at I=2400), rounded
    by the prologue into scratch and read through L2: the kernel still
    matches its bf16 plain version by the card's rule."""
    S, T, C, R = 8, 4, 800, 512
    pl = ls.infer2_plan(S, I, C, R, bf16=True)
    assert (pl["res_g1"], pl["res_q"], pl["res_g2"]) == held
    _, port = make(seed=98, s=S, t=T, i=I, c=C, r=R, device=cuda_device)
    with torch.no_grad():     # weights at 0.03: the wide sums stay unsaturated
        for v in (*port[0], *port[1]):
            v.mul_(0.1)
    ls.reset_counts()
    r2, f1, f2 = ls.lstm_stack_infer2(*port, CLIP, tb=2, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert (ls.INFER2_BF16_LAUNCHES, ls.PLAIN_CALLS) == (1, 0)
    ref = ls.lstm_stack_infer2_plain(*port, CLIP, compute_dtype=BF16)
    ref32 = ls.lstm_stack_infer2_plain(*port, CLIP)
    ref64 = ls.lstm_stack_infer2_plain(*_f64(port), CLIP, compute_dtype=BF16)
    for name, a, pick in (("r2", r2, lambda o: o[0]),
                          ("c1T", f1.c, lambda o: o[1].c),
                          ("r1T", f1.r, lambda o: o[1].r),
                          ("c2T", f2.c, lambda o: o[2].c)):
        _card_close(f"K7 I={I} {name}", a, pick(ref), pick(ref32),
                    pick(ref64))


@pytest.mark.gpu
def test_cuda_stack_bf16_kernels_follow_an_in_place_update(cuda_device):
    """K6 bf16's prologue copies (both layers' interleaved Wr, Wrm, Wx)
    and K7 bf16's slices are made on every call: after an in-place update
    of both layers' parameters each kernel equals, bit for bit, a call on
    fresh clones (a fixed order of sums, no atomics), and differs from
    the call before."""
    _, (p1, p2, x, s1, s2) = make(seed=99, s=3, t=4, i=37, c=200, r=130,
                                  device=cuda_device)

    def run(q1, q2):
        k6 = ls.lstm_stack_fwd2(q1, q2, x, s1, s2, CLIP, tb=2,
                                compute_dtype=BF16)
        r2, f1, f2 = ls.lstm_stack_infer2(q1, q2, x, s1, s2, CLIP, tb=2,
                                          compute_dtype=BF16)
        return (*k6, r2, f1.c, f1.r, f2.c)

    def update(p, seed):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for v in p:
                v.add_(0.05 * torch.randn(v.shape, generator=g).to(v.device))

    before = run(p1, p2)
    update(p1, 100)
    update(p2, 101)
    ls.reset_counts()
    after = run(p1, p2)
    assert (ls.FWD2_BF16_LAUNCHES, ls.INFER2_BF16_LAUNCHES) == \
        (ls.wavefront_launches(4, 2), 1)
    fresh = run(type(p1)(*(v.clone() for v in p1)),
                type(p2)(*(v.clone() for v in p2)))
    assert all(torch.equal(u, v) for u, v in zip(after, fresh))
    assert not torch.equal(before[5], after[5])     # K6 r2
    assert not torch.equal(before[6], after[6])     # K7 r2


@pytest.mark.gpu
@pytest.mark.parametrize("dims,tb", [((8, 4, 40, 800, 512), 2),
                                     ((3, 4, 37, 200, 130), 4),
                                     ((64, 10, 40, 800, 512), 5)])
def test_cuda_k6_bf16_is_k1_bf16_twice_bit_for_bit(cuda_device, dims, tb):
    """K6 bf16 runs K1 bf16's tiles (csrc/lstmp_tc16.cuh) on the same
    bf16 copies in the same order, layer 2's xw over each time block
    where K1's runs over all T S rows (each output summed over the same
    stages): its residuals equal K1 bf16 over layer 1 and then over r1,
    bit for bit, whatever the weights' scale (here make()'s 0.3)."""
    from kaldi_lstm_tpu_torch.ops import lstm_train as lt
    S, T, I, C, R = dims
    _, (p1, p2, x, s1, s2) = make(seed=102, s=S, t=T, i=I, c=C, r=R,
                                  device=cuda_device)
    got = ls.lstm_stack_fwd2(p1, p2, x, s1, s2, CLIP, tb=tb,
                             compute_dtype=BF16)
    l1 = lt.lstm_fwd_residuals_cuda(p1, x, s1.c, s1.r, cell_clip=CLIP,
                                    compute_dtype=BF16)
    l2 = lt.lstm_fwd_residuals_cuda(p2, l1[2], s2.c, s2.r, cell_clip=CLIP,
                                    compute_dtype=BF16)
    for name, a, b in zip(NAMES, got, (*l1, *l2)):
        assert torch.equal(a, b), name
