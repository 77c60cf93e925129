"""The H100 tensor core's bf16 -> f32 dot product, modelled bit for bit.

The bf16 kernels (K1, K2 and K6 on ``tc_gemm.cuh``'s Gemm16, K5 and K7 on
``persistent.cuh``'s mma products, K3, K4 and K1's wide xw on
``wg_gemm.cuh``'s wgmma) sum their exact bf16 products in the tensor
core, which does not add as IEEE f32 does. ``tc_dot`` is that sum in
plain torch, after Fasi, Higham, Mikaitis and Pranesh, "Numerical
behavior of NVIDIA tensor cores", PeerJ Computer Science 7:e330 (2021):

- every product a_k b_k is exact (two 8-bit significands);
- the products are taken ``block`` at a time together with the running
  accumulator (the instruction's C, then each block's result);
- a block's terms are aligned to its largest exponent E and each is cut
  toward zero to a multiple of 2^(E - align_bits). A product's exponent
  is the sum of its operands' exponents (its significand lies in [1, 4)),
  the accumulator's its own;
- the cut terms are summed exactly and the sum is rounded to f32 as
  ``rounding`` says ("rz" toward zero, "rn" to nearest even, "rd" down,
  "ru" up).

It is written on f64 and is exact there: a product of two bf16 values
has at most 16 significant bits; a cut term is an integer multiple of
q = 2^(E - align_bits) below 2^(E + 2) in magnitude, so t / q is an
integer below 2^(align_bits + 2), found exactly by dividing by a power
of two and truncating; and the block + 1 of them sum below
2^(align_bits + 2) (block + 1) <= 2^53 for align_bits <= 44 and block <=
64, so every partial sum is exact in f64 in any order. The only rounding
is the last one, to f32, done by hand. Operands and sums are finite and
away from f32's underflow (a bf16 subnormal operand is not probed).

``MMA_M16N8K16_BF16`` and ``WGMMA_M64NNK16_BF16`` hold the parameters of
the two instructions, found on the card by ``find_params`` (crafted
vectors whose answers follow from each parameter) and held to it bit for
bit on random fragments by chip_smoke.py's phase 3e. ``tc_matmul`` is a
product as the kernels chain it: ``chain`` 16-deep slices through one
accumulator, the runs' results added in IEEE f32.

``probe_mma`` and ``probe_wgmma`` run the instructions themselves
(``csrc/tc_probe.cu``) on fragments the caller supplies; on CPU tensors
they return the model's answer with the instruction's constants, the
probe's plain version.

The kernels' epilogues round where nvcc fuses a multiply into an add, so
the bf16 mirrors' ``tc=True`` form (the kernel's own arithmetic) also
takes ``fma_f32``, ``cell_math`` and ``cell_grad_math`` in their fused
forms. Nothing on a user path calls any of this.
"""

from __future__ import annotations

import ctypes

import torch

# Found on an NVIDIA H100 80GB HBM3 at a power limit of 700.00 W by
# find_params (chip_smoke.py phase 3e); the model matched both
# instructions bit for bit on 2^20 random dot products per accumulator
# mode and operand range there.
MMA_M16N8K16_BF16 = {"block": 16, "align_bits": 25, "rounding": "rz"}
WGMMA_M64NNK16_BF16 = {"block": 16, "align_bits": 25, "rounding": "rz"}

ROUNDINGS = ("rz", "rn", "rd", "ru")
_NO_EXP = -(1 << 20)      # the exponent of a zero term: below any other
_MAX_TERMS = 1 << 24      # products a block in one tc_matmul chunk


def _exponent(t: torch.Tensor) -> torch.Tensor:
    """The IEEE exponent e of each value (|t| in [2^e, 2^(e+1))), int64;
    _NO_EXP where t is zero."""
    e = torch.frexp(t)[1].long() - 1
    return torch.where(t == 0, torch.full_like(e, _NO_EXP), e)


def round_f32(s: torch.Tensor, rounding: str) -> torch.Tensor:
    """The f64 values s rounded to f32 as ``rounding`` says, returned in
    f64 (each an f32 value). ``s.float()`` rounds to nearest even; the
    other modes step that one f32 ulp back where it went the wrong way."""
    f = s.float()
    if rounding == "rn":
        return f.double()
    fd = f.double()
    if rounding == "rz":
        step, to = fd.abs() > s.abs(), torch.zeros_like(f)
    elif rounding == "rd":
        step, to = fd > s, torch.full_like(f, float("-inf"))
    elif rounding == "ru":
        step, to = fd < s, torch.full_like(f, float("inf"))
    else:
        raise ValueError(f"rounding must be one of {ROUNDINGS}, got "
                         f"{rounding!r}")
    return torch.where(step, torch.nextafter(f, to), f).double()


def tc_dot(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
           *, block: int, align_bits: int, rounding: str) -> torch.Tensor:
    """sum_k a[..., k] b[..., k] (+ c) as one tensor-core chain sums it
    (the module's docstring): a and b bf16-valued, of broadcastable
    shapes [..., K]; c f32-valued of the broadcast shape without K, or
    None (a zero accumulator). K need not be a multiple of ``block``: a
    last short block is a block with zero products. Returns f32."""
    if not 1 <= block <= 64 or not 1 <= align_bits <= 44:
        raise ValueError(f"tc_dot: block {block} or align_bits "
                         f"{align_bits} outside the exact range")
    a, b = a.double(), b.double()
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    K = a.shape[-1]
    if b.shape[-1] != K:
        raise ValueError(f"tc_dot: a has K={K}, b has K={b.shape[-1]}")
    acc = (torch.zeros(shape, dtype=torch.float64, device=a.device)
           if c is None else c.double().expand(shape).clone())
    ea, eb = _exponent(a), _exponent(b)
    for k0 in range(0, K, block):
        sl = slice(k0, k0 + block)
        prod = a[..., sl] * b[..., sl]
        e = torch.where(prod == 0, torch.full_like(prod, _NO_EXP,
                                                   dtype=torch.long),
                        ea[..., sl] + eb[..., sl])
        top = torch.maximum(e.max(-1).values, _exponent(acc))
        q = torch.exp2((top - align_bits).clamp_min(-1000).double())
        s = acc.div(q).trunc() + prod.div(q[..., None]).trunc().sum(-1)
        acc = round_f32(s * q, rounding)
    return acc.float()


def tc_runs(a: torch.Tensor, b: torch.Tensor, chain: int | None,
            params: dict | None = None) -> torch.Tensor:
    """The runs of a [M, K] @ b [K, N] (bf16-valued) as the tensor cores
    sum them: K in 16-deep slices (the last zero-padded), each run of
    ``chain`` slices (all of them when None: a whole-K wgmma chain)
    summed through one accumulator from zero (``tc_dot`` with ``params``,
    default ``MMA_M16N8K16_BF16``). Returns f32 [M, N, runs]. A zero
    slice passes the accumulator through unchanged, so padding is free."""
    params = MMA_M16N8K16_BF16 if params is None else params
    if 16 % params["block"]:
        raise ValueError("tc_runs: a block must not straddle slices")
    (M, K), N = a.shape, b.shape[1]
    slices = max(1, -(-K // 16))
    per = chain if chain is not None else slices
    runs = -(-slices // per)
    pad = runs * per * 16 - K
    ar = torch.nn.functional.pad(a, (0, pad)).view(M, 1, runs, 16 * per)
    br = torch.nn.functional.pad(b.T, (0, pad)).view(1, N, runs, 16 * per)
    return tc_dot(ar, br, **params)


def tc_matmul(a: torch.Tensor, b: torch.Tensor, chain: int | None,
              params: dict | None = None) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the kernels sum it on the tensor cores:
    ``tc_runs``'s runs added in IEEE f32 in order, from zero. Rows go in
    chunks of about ``_MAX_TERMS`` products a block. Returns f32 [M, N]."""
    M, N = a.shape[0], b.shape[1]
    out = a.new_empty((M, N), dtype=torch.float32)
    block = (params or MMA_M16N8K16_BF16)["block"]
    runs = -(-max(1, -(-a.shape[1] // 16)) // (chain or 1 << 30))
    rows = max(1, _MAX_TERMS // max(1, N * runs * block))
    for m0 in range(0, M, rows):
        part = tc_runs(a[m0:m0 + rows], b, chain, params)
        acc = torch.zeros_like(part[..., 0])
        for r in range(part.shape[-1]):
            acc = acc + part[..., r]
        out[m0:m0 + rows] = acc
    return out


# ---------------------------------------------------------------------------
# the kernels' cell math, as nvcc compiles it
# ---------------------------------------------------------------------------

def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """fmaf(a, b, c) on f32 tensors: a b + c rounded once to f32 (to
    nearest even). a b is exact in f64 (two 24-bit significands); s = a b
    + c rounded to f64 is the f32 rounding's answer except where s lands
    exactly on a midpoint of two f32 values, and there the sign of the
    f64 sum's error (TwoSum, exact) picks the side."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    f = s.float()
    fd = f.double()
    up = torch.nextafter(f, torch.full_like(f, float("inf")))
    dn = torch.nextafter(f, torch.full_like(f, float("-inf")))
    tie_up = (s == (fd + up.double()) / 2) & (err > 0)
    tie_dn = (s == (fd + dn.double()) / 2) & (err < 0)
    return torch.where(tie_up, up, torch.where(tie_dn, dn, f))


def cell_math(g_pre, i_pre, f_pre, o_pre, c_prev, pi, pf, po,
              cell_clip: float, fused: bool = False):
    """One step of the LSTMP cell from its gate pre-activations: (g, i, f,
    the clipped new c, o). The plain versions' order, each product and
    add rounded; with ``fused`` the kernels' (persistent.cuh::cell_step,
    lstmp_tc16.cuh::gates_tile) as nvcc contracts them: each peephole
    term fused into its add (fmaf(c, p, pre)) and the new c as fmaf(g, i,
    c_prev f), the form the kernels matched bit for bit on an H100 (held
    by chip_smoke.py's phase 3d)."""
    g = torch.tanh(g_pre)
    if fused:
        i = torch.sigmoid(fma_f32(c_prev, pi, i_pre))
        f = torch.sigmoid(fma_f32(c_prev, pf, f_pre))
        cn = fma_f32(g, i, c_prev * f)
    else:
        i = torch.sigmoid(i_pre + c_prev * pi)
        f = torch.sigmoid(f_pre + c_prev * pf)
        cn = g * i + c_prev * f
    if cell_clip > 0:
        cn = torch.clamp(cn, -cell_clip, cell_clip)
    o = torch.sigmoid(fma_f32(cn, po, o_pre) if fused else o_pre + cn * po)
    return g, i, f, cn, o


def cell_grad_math(dm, g, i, f, o, h, c_prev, dc, pi, pf, po,
                   fused: bool = False):
    """One reverse step of the cell from dm (the gradient of m = h o) and
    the residuals (h = tanh of the clipped c_t): (dg, di, df, do, the
    gradient of c_{t-1}). The plain versions' order, each product and
    add rounded; with ``fused`` K2 bf16's epilogue (csrc/lstmp_train.cu's
    bwd16_dm_kernel) as nvcc contracts it: 1 - h^2 and 1 - g^2 as
    fmaf(-h, h, 1), dc_total as fmaf(do, po, fmaf(dm o, 1 - h^2, dc)) and
    the new dc as fmaf(df, pf, fmaf(dc_total, f, di pi)) (the card's
    kernel matched this form bit for bit at S=1, T=1 and free-running)."""
    one = torch.ones_like(h)
    dh_c = fma_f32(-h, h, one) if fused else 1.0 - h * h
    d_o = dm * h * o * (1.0 - o)
    dc_total = fma_f32(d_o, po, fma_f32(dm * o, dh_c, dc)) if fused else \
        dc + dm * o * dh_c + d_o * po
    df = dc_total * c_prev * f * (1.0 - f)
    di = dc_total * g * i * (1.0 - i)
    dg = dc_total * i * (fma_f32(-g, g, one) if fused else 1.0 - g * g)
    dcn = fma_f32(df, pf, fma_f32(dc_total, f, di * pi)) if fused else \
        dc_total * f + di * pi + df * pf
    return dg, di, df, d_o, dcn


# ---------------------------------------------------------------------------
# the probes (csrc/tc_probe.cu)
# ---------------------------------------------------------------------------

MMA_SHAPE = (16, 8, 16)        # m, n, k of one mma.sync
WGMMA_SHAPE = (64, 128, 16)    # m, n, k of one wgmma step


def _probe_lib():
    from kaldi_lstm_tpu_torch.ops import _build
    lib = _build.load("tc_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    if lib.tc_probe_mma.argtypes is None:
        lib.tc_probe_mma.argtypes = [p, p, p, p, i, p]
        lib.tc_probe_mma.restype = i
        lib.tc_probe_wgmma.argtypes = [p, p, p, p, i, i, p]
        lib.tc_probe_wgmma.restype = i
    return lib


def _check_probe(what: str, a, b, c, m: int, n: int, k: int) -> int:
    count = a.shape[0]
    for name, t, shape, dtype in (("a", a, (count, m, k), torch.bfloat16),
                                  ("b", b, (count, n, k), torch.bfloat16),
                                  ("c", c, (count, m, n), torch.float32)):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{a.device}")
    return count


def probe_mma(a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor | None = None) -> torch.Tensor:
    """n mma.sync.m16n8k16 bf16 -> f32: d[i] = a[i] b[i]^T (+ c[i]), a
    [n, 16, 16] and b [n, 8, 16] bf16 (K-major), c [n, 16, 8] f32 or None
    (tc_gemm.cuh's mma_bf16_zero; with c its mma_bf16). On CPU tensors
    the model with ``MMA_M16N8K16_BF16``."""
    n = _check_probe("probe_mma", a, b, c, *MMA_SHAPE)
    if a.device.type == "cpu":
        return tc_dot(a[:, :, None], b[:, None], c, **MMA_M16N8K16_BF16)
    d = torch.empty((n, 16, 8), device=a.device, dtype=torch.float32)
    err = _probe_lib().tc_probe_mma(
        a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(),
        d.data_ptr(), n, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_mma: CUDA launch failed with error {err}")
    return d


def probe_wgmma(a: torch.Tensor, b: torch.Tensor, depth: int,
                c: torch.Tensor | None = None) -> torch.Tensor:
    """n chains of ``depth`` wgmma m64n128k16 bf16 -> f32: d[i] = a[i]
    b[i]^T (+ c[i]), a [n, 64, 16 depth] and b [n, 128, 16 depth] bf16
    (K-major), c [n, 64, 128] f32 or None (the chain starts at zero, as
    wg_gemm.cuh's ring starts it). On CPU tensors the model with
    ``WGMMA_M64NNK16_BF16``."""
    n = _check_probe("probe_wgmma", a, b, c, 64, 128, 16 * depth)
    if a.device.type == "cpu":
        return tc_dot(a[:, :, None], b[:, None], c, **WGMMA_M64NNK16_BF16)
    d = torch.empty((n, 64, 128), device=a.device, dtype=torch.float32)
    err = _probe_lib().tc_probe_wgmma(
        a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(),
        d.data_ptr(), n, depth,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_wgmma: CUDA launch failed with error "
                           f"{err}")
    return d


# ---------------------------------------------------------------------------
# finding the parameters on the card, and holding the model to it
# ---------------------------------------------------------------------------

def _crafted(probe, shape, device, vecs) -> torch.Tensor:
    """d[0, 0] of one instruction (a chain of depth 1) per crafted
    vector: (a, b, c) with a and b 16 bf16-exact values, c a float or
    None; every other row of A and B and entry of C zero."""
    m, n, k = shape
    count = len(vecs)
    A = torch.zeros((count, m, k), dtype=torch.float64)
    B = torch.zeros((count, n, k), dtype=torch.float64)
    A[:, 0] = torch.tensor([v[0] for v in vecs], dtype=torch.float64)
    B[:, 0] = torch.tensor([v[1] for v in vecs], dtype=torch.float64)
    C = None
    if any(v[2] is not None for v in vecs):
        C = torch.zeros((count, m, n), dtype=torch.float32, device=device)
        C[:, 0, 0] = torch.tensor([v[2] or 0.0 for v in vecs])
    A, B = (t.to(torch.bfloat16).to(device) for t in (A, B))
    d = probe(A, B, C) if shape == MMA_SHAPE else probe(A, B, 1, C)
    return d[:, 0, 0].double().cpu()


def _vec(*lead: float) -> list:
    return list(lead) + [0.0] * (16 - len(lead))


ONES = [1.0] * 16


def _find(probe, shape, device) -> tuple[dict, dict]:
    """(block, align_bits, rounding) of one instruction from crafted
    vectors (b all ones, so each product is an entry of a), and what
    each question saw."""
    seen = {}
    # block: 1 and -1 cancel to exactly 0 in their block; a tiny 2^-40
    # at position j survives only where it starts a block of its own
    # (the accumulator is then an exact 0), else the cut to align_bits
    # below 2^0 removes it
    tiny = 2.0 ** -40
    pos = list(range(2, 16))
    got = _crafted(probe, shape, device,
                   [([1.0, -1.0] + [tiny if i == j else 0.0
                                    for i in range(2, 16)], ONES, None)
                    for j in pos])
    seen["block: position of 2^-40 -> kept"] = {
        j: bool(v != 0) for j, v in zip(pos, got.tolist())}
    kept = [j for j, v in zip(pos, got.tolist()) if v != 0]
    block = kept[0] if kept else 16
    if block < 3:
        raise RuntimeError(f"find_params: block {block} < 3; the crafted "
                           f"vectors below need three terms in a block")
    # align_bits: 1 - 1 + 2^-j in one block keeps 2^-j iff j <= align_bits
    js = list(range(8, 45))
    got = _crafted(probe, shape, device,
                   [(_vec(1.0, -1.0, 2.0 ** -j), ONES, None) for j in js])
    keep = [bool(v == 2.0 ** -j) for j, v in zip(js, got.tolist())]
    lost = [bool(v == 0) for v in got.tolist()]
    seen["align_bits: j -> 1 - 1 + 2^-j kept"] = dict(zip(js, keep))
    align = max((j for j, k in zip(js, keep) if k), default=0)
    if not all(k for j, k in zip(js, keep) if j <= align) or \
            not all(z for j, z in zip(js, lost) if j > align):
        raise RuntimeError("find_params: 2^-j is neither kept whole nor "
                           "lost whole; the alignment is not a cut")
    # rounding: 1 + 3/4, 1/4, 1/2 and 3/2 ulp and their negatives, every
    # term kept by the cut (align_bits >= 25), against each mode
    u = 2.0 ** -23
    lead = [(1.0, u / 2, u / 4), (1.0, u / 4), (1.0, u / 2), (1.0, u, u / 2)]
    vecs = [(_vec(*(sg * v for v in t)), ONES, None)
            for t in lead for sg in (1.0, -1.0)]
    got = _crafted(probe, shape, device, vecs)
    a = torch.tensor([v[0] for v in vecs], dtype=torch.float64)
    fits = [r for r in ROUNDINGS if torch.equal(
        tc_dot(a, torch.ones(16, dtype=torch.float64), block=block,
               align_bits=align, rounding=r).double(), got)]
    seen["rounding: 1 + {3/4, 1/4, 1/2, 3/2} ulp, +-"] = got.tolist()
    if len(fits) != 1:
        raise RuntimeError(f"find_params: the rounding vectors fit "
                           f"{fits or 'no mode'} (align_bits {align})")
    return {"block": block, "align_bits": align, "rounding": fits[0]}, seen


def _convention_vectors() -> list:
    """Crafted vectors the model's conventions decide: a product of two
    1.5s (significand 2.25) aligns by its exponent sum 0, so 2^-25
    survives beside it; an accumulator 1 aligns by its own exponent 0;
    cancellation that leaves a sum below the largest term; a block cut
    toward zero of a negative term."""
    return [([1.5, -1.5, 2.0 ** -25] + [0.0] * 13,
             [1.5, 1.5, 1.0] + [0.0] * 13, None),
            (_vec(-1.0, 2.0 ** -25), ONES, 1.0),
            (_vec(-1.0, 2.0 ** -26), ONES, 1.0),
            (_vec(1.0, -0.75, 2.0 ** -24, -(2.0 ** -30)), ONES, None),
            (_vec(-1.0, 2.0 ** -26, 2.0 ** -26), ONES, 0.5),
            (_vec(*([2.0 ** -10] * 16)), ONES, -3.0)]


def operands(shape, depth: int, count: int, w: float, gen, device,
             with_c: bool):
    """``count`` random fragments of one instruction (``MMA_SHAPE``, or
    a chain of ``depth`` wgmma steps): A the weights, uniform in +-w; B
    the activations as chip_smoke.py's phase 3d makes them, half of the
    rows x-like (normal) and half m-like (tanh(c) o); with ``with_c`` an
    accumulator at the scale of a partial sum. All rounded to bf16."""
    m, n, k = shape
    k = k * depth
    a = (torch.rand((count, m, k), generator=gen) * 2 - 1) * w
    x = torch.randn((count, n, k), generator=gen)
    mm = torch.tanh(torch.randn((count, n, k), generator=gen)) \
        * torch.sigmoid(torch.randn((count, n, k), generator=gen))
    b = torch.where(torch.arange(n)[None, :, None] % 2 == 0, x, mm)
    c = (torch.randn((count, m, n), generator=gen) * 4 * w * k ** 0.5
         if with_c else None)
    return (a.to(torch.bfloat16).to(device), b.to(torch.bfloat16).to(device),
            None if c is None else c.to(device))


def compare(got: torch.Tensor, want: torch.Tensor) -> tuple[int, int]:
    """(entries whose f32 bits differ, the largest gap in f32 ulps of
    the larger magnitude) between two f32 tensors; +0 and -0 differ."""
    bits = got.view(torch.int32) != want.view(torch.int32)
    if not bool(bits.any()):
        return 0, 0
    g, w = got[bits].double(), want[bits].double()
    ulp = torch.maximum(g.abs(), w.abs()).float()
    ulp = (torch.nextafter(ulp, torch.full_like(ulp, float("inf")))
           - ulp).double()
    return int(bits.sum()), int(((g - w).abs() / ulp).max().ceil())


def check(probe, shape, params: dict, depth: int, count: int, w: float,
          with_c: bool, gen, device) -> tuple[int, int]:
    """The model with ``params`` against the instruction on ``count``
    random fragments (``operands``), 2^18 dot products at a time:
    (mismatching entries, largest ulp gap)."""
    m, n, _ = shape
    per = max(1, (1 << 18) // (m * n))
    bad, gap = 0, 0
    for i0 in range(0, count, per):
        a, b, c = operands(shape, depth, min(per, count - i0), w, gen,
                           device, with_c)
        d = probe(a, b, c) if shape == MMA_SHAPE else probe(a, b, depth, c)
        model = tc_dot(a[:, :, None], b[:, None], c, **params)
        nb, ng = compare(d, model)
        bad, gap = bad + nb, max(gap, ng)
    return bad, gap


def find_params(mma=None, wgmma=None, device="cuda", seed: int = 0,
                random_dots: int = 1 << 16) -> dict:
    """Each instruction's (block, align_bits, rounding), settled by
    crafted vectors after Fasi et al. (``_find``), then the model with
    them held to the instruction on the conventions' vectors and on
    ``random_dots`` random dot products (weights +-0.3, an accumulator
    given). ``mma`` and ``wgmma`` default to ``probe_mma`` and
    ``probe_wgmma``. Returns {"mma": {...}, "wgmma": {...}}, each with
    its parameters, "seen" (what each crafted question saw),
    "conventions" (mismatching conventions' vectors) and "random"
    (mismatching entries, largest ulp gap)."""
    out = {}
    gen = torch.Generator().manual_seed(seed)
    for name, probe, shape in (("mma", mma or probe_mma, MMA_SHAPE),
                               ("wgmma", wgmma or probe_wgmma,
                                WGMMA_SHAPE)):
        params, seen = _find(probe, shape, device)
        vecs = _convention_vectors()
        got = _crafted(probe, shape, device, vecs)
        a = torch.tensor([v[0] for v in vecs], dtype=torch.float64)
        b = torch.tensor([v[1] for v in vecs], dtype=torch.float64)
        c = torch.tensor([v[2] or 0.0 for v in vecs], dtype=torch.float32)
        want = tc_dot(a, b, c, **params).double()
        m, n, _ = shape
        rnd = check(probe, shape, params, 1,
                    max(1, random_dots // (m * n)), 0.3, True, gen, device)
        out[name] = {**params, "seen": seen,
                     "conventions": int((got != want).sum()),
                     "random": rnd}
    return out
