"""The yardstick against hand counts at the two configurations' shapes,
and the trace reduction's union of overlapping kernels."""

import pytest

from bench_h100 import catalog
from bench_h100 import yardstick as ys

GOOGLE = catalog.cell("train-google-f32").config
DEEP = catalog.cell("train-deep-f32").config


def test_model_operations_per_frame_by_hand():
    # google: LSTMP 40 -> 800c/512r, 512 -> 8000
    fwd = 2 * (4 * 800 * 40 + 4 * 800 * 512 + 512 * 800)       # 4,352,000
    bwd_no_dx = fwd + 2 * (4 * 800 * 512 + 512 * 800)           # 8,448,000
    aff = 2 * 512 * 8000                                        # 8,192,000
    assert ys.model_ops_per_frame(GOOGLE, train=False) == fwd + aff
    assert ys.model_ops_per_frame(GOOGLE, train=True) == 37_376_000
    assert fwd + bwd_no_dx + 3 * aff == 37_376_000
    # deep: a second layer at I=512 whose dx is needed, 16624 pdfs
    fwd2 = 2 * (2 * 4 * 800 * 512 + 512 * 800)                  # 7,372,800
    bwd2 = fwd2 + 2 * (4 * 800 * 512 + 512 * 800) + 2 * 4 * 800 * 512
    aff2 = 2 * 512 * 16624
    assert ys.model_ops_per_frame(DEEP, train=False) == \
        fwd + fwd2 + aff2 == 28_747_776
    assert ys.model_ops_per_frame(DEEP, train=True) == \
        fwd + bwd_no_dx + fwd2 + bwd2 + 3 * aff2 == 85_987_328


def test_kernel_bounds_by_hand():
    w = 4 * 800 * 40 + 4 * 800 * 512 + 4 * 800 + 3 * 800 + 512 * 800
    assert ys.lstmp_weight_elems(40, 800, 512) == w == 2_181_600
    assert ys.k5_bytes(1000, 40, 800, 512) == 4 * (1000 * 40 + w + 1000 * 512)
    assert ys.k3_ops(5120, 512, 8000) == 2 * 5120 * 512 * 8000
    assert ys.k4_ops(5120, 512, 8000) == 2 * ys.k3_ops(5120, 512, 8000)
    t, which = ys.bound_s(ys.k1_ops(5120, 40, 800, 512),
                          ys.k1_bytes(5120, 256, 40, 800, 512))
    assert which == "compute"
    assert t == pytest.approx(2 * 5120 * 2_176_000 / 495e12)
    # K5 at one frame is bound by reading its weights
    assert ys.bound_s(ys.k5_ops(1, 40, 800, 512),
                      ys.k5_bytes(1, 40, 800, 512))[1] == "bytes"


def test_kernel_names_map_to_entry_points():
    assert ys.entry_of("void k1::contract_tc_kernel<32, 32, true, true, "
                       "true, true, tc::F32>(k1::Contract)") \
        == "lstmp_train_fwd"
    assert ys.entry_of("void k1::contract_tc_kernel<64, 64, false, false, "
                       "true, true, tc::F32>(k1::Contract)") \
        == "lstmp_train_bwd"
    assert ys.entry_of("(anonymous namespace)::lstmp_infer_kernel<true, "
                       "true>(Params)") == "lstmp_infer"
    assert ys.entry_of("Memcpy DtoH (Device -> Pinned)") is None


def _trace(device, host=(), t0=0.0, t1=10.0):
    return ys.Trace([ys.DeviceEvent(n, ys.device_kind(n), s, e)
                     for n, s, e in device],
                    [ys.HostEvent(n, s, e) for n, s, e in host], t0, t1)


def test_overlapping_kernels_count_once():
    tr = _trace([("a_kernel", 1.0, 3.0), ("b_kernel", 2.0, 4.0),
                 ("Memcpy DtoH (Device -> Pinned)", 3.5, 6.0),
                 ("c_kernel", 9.5, 11.0)])
    assert ys.union_s(tr) == pytest.approx(3.5)            # 1-4, 9.5-10
    assert ys.busy_s(tr) == pytest.approx(5.5)             # 1-6, 9.5-10
    assert ys.union_s(tr, ("memcpy_dtoh",)) == pytest.approx(2.5)
    assert ys.kernel_time_s(tr, ("lstmp_infer",)) == 0.0


def test_idle_gaps_are_named_by_the_host():
    tr = _trace([("k", 0.0, 1.0), ("k", 1.00001, 2.0), ("k", 5.0, 10.0)],
                host=[("cudaGraphLaunch", 2.5, 4.5),
                      (ys.WINDOW_MARK, 0.0, 10.0)])
    gaps = dict(ys.idle_gaps(tr))
    assert gaps["cudaGraphLaunch"] == pytest.approx(3.0)
    assert gaps["between device ops"] == pytest.approx(1e-5)
