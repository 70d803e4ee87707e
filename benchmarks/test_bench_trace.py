"""The trace's arithmetic on synthetic events: the union of overlapping
device intervals, the idle gaps and their host operations, the kinds."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmarks.harness import readers, trace


def event(name, start_s, end_s, device=True, annotation=False):
    return SimpleNamespace(
        name=lambda: name, device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU,
        start_ns=lambda: int(start_s * 1e9), end_ns=lambda: int(end_s * 1e9),
        is_user_annotation=lambda: annotation)


def test_union_counts_overlap_once():
    length, merged = trace.union_length([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)])
    assert length == pytest.approx(4.0)
    assert merged == [(0.0, 3.0), (5.0, 6.0)]


def test_idle_gaps_inside_the_window():
    gaps = trace.idle_gaps([(1.0, 3.0), (5.0, 6.0)], 0.0, 10.0)
    assert gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 10.0)]


def test_gap_goes_to_the_innermost_host_operation():
    host = [(0.0, 10.0, "bench.call"), (2.5, 5.5, "aten::copy_"), (6.0, 9.0, "aten::pad")]
    idle = trace.attribute([(3.0, 5.0), (6.5, 7.5), (9.2, 9.8), (11.0, 12.0)], host)
    assert idle == pytest.approx({"aten::copy_": 2.0, "aten::pad": 1.0, "bench.call": 0.6,
                                  "host outside any operation": 1.0})


def test_summarize_a_synthetic_trace():
    events = [
        event(trace.WINDOW, 0.0, 10.0, device=False),
        event("bench.demix_tracks", 0.0, 10.0, device=False),
        event("aten::copy_", 7.0, 9.5, device=False),
        # two streams overlapping, a copy, an annotation that must not count
        event("void lstm_resident_kernel<1, false>(float const*)", 1.0, 4.0),
        event("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n", 3.0, 5.0),
        event("Memcpy DtoH (Device -> Pageable)", 6.0, 7.0),
        event("Optimizer.step#AdamW.step", 0.0, 10.0, annotation=True),
        event("void wiener_reduce_kernel<true>(float const*)", 9.0, 11.0),  # cut at the window
        event("early", -2.0, -1.0),
    ]
    tr, why = trace.summarize(events)
    assert why == "" and tr is not None
    assert tr.window_s == pytest.approx(10.0)
    assert tr.busy_s == pytest.approx(3.0 + 1.0 + 1.0 + 1.0)  # (1, 5), (6, 7), (9, 10)
    assert tr.by_kind["recurrence"] == pytest.approx(3.0)
    assert tr.by_kind["matmul"] == pytest.approx(2.0)
    assert tr.by_kind["d2h"] == pytest.approx(1.0)
    assert tr.by_kind["wiener"] == pytest.approx(1.0)
    assert tr.idle_by_host["aten::copy_"] == pytest.approx(2.0)  # (7, 9)
    assert tr.idle_by_host["bench.demix_tracks"] == pytest.approx(2.0)  # (0, 1), (5, 6)
    r = SimpleNamespace(trace=tr)
    assert readers.idle_pct(r) == pytest.approx(40.0)
    assert readers.kind_pct(r, "d2h") == pytest.approx(10.0)
    assert readers.kind_pct(r, "fft") is None  # nothing of the kind: no number, never 0


def test_no_device_work_gives_no_trace():
    tr, why = trace.summarize([event(trace.WINDOW, 0.0, 1.0, device=False),
                               event("aten::add", 0.1, 0.2, device=False)])
    assert tr is None and "no device activity" in why
    r = SimpleNamespace(trace=None)
    assert readers.idle_pct(r) is None and readers.mfu(r, 1e12) is None


def test_short_names_keep_the_kernel():
    assert trace.short("void (anonymous namespace)::lstm_resident_kernel<1, false>(float const*)") \
        == "lstm_resident_kernel<1, false>"
    assert trace.short("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"


@pytest.mark.parametrize("name, kind", [
    ("void lstm_bwd_resident_kernel<2>(...)", "recurrence"),
    ("void lstm_dw_wgmma_kernel(...)", "recurrence"),
    ("void (anonymous namespace)::apply_kernel<true, true>(float const*)", "wiener"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>", "other"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNN", "matmul"),
    ("Memcpy HtoD (Pageable -> Device)", "h2d"),
    ("void regular_fft<512u, ...>", "fft"),
])
def test_kinds(name, kind):
    assert trace.kind_of(name) == kind
