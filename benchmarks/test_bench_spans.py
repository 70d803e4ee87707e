"""The program's spans read from synthetic events that carry correlation
ids: idle by the innermost ``umx.`` span, device time by the span open at
its launch (a launch from a second thread included), the unlinked share,
no number from a trace without ``umx.`` spans, and the benchmark's
host-idle readers."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmarks import run as R
from benchmarks.harness import cells, spans, trace


def event(name, start_s, end_s, device=False, corr=0, linked=0, annotation=False, thread=1):
    return SimpleNamespace(
        name=lambda: name, device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU,
        start_ns=lambda: int(start_s * 1e9), end_ns=lambda: int(end_s * 1e9),
        is_user_annotation=lambda: annotation, correlation_id=lambda: corr,
        linked_correlation_id=lambda: linked, start_thread_id=lambda: thread)


def kernel(name, start_s, end_s, corr, linked=0):
    return event(name, start_s, end_s, device=True, corr=corr, linked=linked)


def span(name, start_s, end_s, corr):
    return event(name, start_s, end_s, corr=corr, annotation=True)


def launch(start_s, corr, linked, thread=1, name="cudaLaunchKernel"):
    return event(name, start_s, start_s + 0.01, corr=corr, linked=linked, thread=thread)


def training_window():
    """A 10 s window: the forward launched outside any span (0–2 s), the
    backward launched from a second thread while ``umx.train.backward``
    is open (2–5 s), the optimizer (5–6.5 s), then idle under the
    optimizer's aten op, and a kernel whose launch is not in the trace."""
    return [
        event(trace.WINDOW, 0.0, 10.0, annotation=True, corr=1),
        event("bench.train_step", 0.0, 10.0, annotation=True, corr=2),
        event("aten::mm", 0.1, 0.2, corr=3), launch(0.15, corr=1001, linked=3),
        kernel("sm90_xmma_gemm_f32f32", 0.2, 2.0, corr=1001, linked=3),
        span(spans.BACKWARD, 2.0, 5.0, corr=4),
        event("aten::mm", 2.1, 2.2, corr=5, thread=2), launch(2.15, 1002, 5, thread=2),
        kernel("lstm_bwd_resident_kernel<2>", 2.2, 5.0, corr=1002, linked=5),
        span(spans.OPTIMIZER, 5.0, 9.0, corr=6),
        event("aten::_foreach_add_", 5.05, 8.5, corr=7),
        launch(5.1, 1003, 7, name="cuLaunchKernelEx"),
        kernel("multi_tensor_apply_kernel", 5.1, 6.0, corr=1003, linked=7),
        # no runtime call for this one: found through its linked operation
        kernel("multi_tensor_apply_kernel", 6.0, 6.5, corr=1004, linked=7),
        kernel("orphan", 9.5, 9.7, corr=1005),
        # a runtime call outside any operation, whose id is the aten op's:
        # the two number their ids apart, so it must not stand for the op
        launch(9.2, corr=7, linked=0, name="cudaStreamSynchronize"),
    ]


def test_idle_goes_to_the_innermost_program_span():
    p = spans.summarize(training_window())
    # the gap 6.5–9.5 has its middle under aten::_foreach_add_, which is
    # not looked at, inside umx.train.optimizer; 0–0.2 and 9.7–10 under no
    # span
    assert p.idle_by_span == pytest.approx({spans.OPTIMIZER: 0.1 + 3.0, spans.BACKWARD: 0.2,
                                            spans.OUTSIDE: 0.2 + 0.3})
    assert p.window_s == pytest.approx(10.0)
    assert spans.idle_pct(p, [spans.OPTIMIZER]) == pytest.approx(31.0)
    tr, _ = trace.summarize(training_window())
    # the trace's own view gives that gap, and 5.0–5.1, to the aten op
    assert tr.idle_by_host["aten::_foreach_add_"] == pytest.approx(3.0 + 0.1)


def test_device_time_goes_to_the_span_open_at_its_launch():
    p = spans.summarize(training_window())
    assert p.device_by_span == pytest.approx({spans.OUTSIDE: 1.8, spans.BACKWARD: 2.8,
                                              spans.OPTIMIZER: 0.9 + 0.5})
    assert p.device_s == pytest.approx(1.8 + 2.8 + 1.4 + 0.2)
    assert p.unlinked_s == pytest.approx(0.2)
    assert spans.device_ms(p, spans.BACKWARD, 4) == pytest.approx(700.0)
    assert spans.device_ms(p, spans.OPTIMIZER, 4) == pytest.approx(350.0)
    assert spans.device_ms(p, "umx.nothing", 4) is None


def test_unlinked_share_above_the_limit_gives_no_device_number():
    events = training_window() + [kernel("orphan", 9.7, 9.95, corr=1006)]
    p = spans.summarize(events)
    assert p.unlinked_share == pytest.approx(0.45 / 6.45)
    assert spans.device_ms(p, spans.BACKWARD, 4) is not None
    events.append(kernel("orphan", 6.5, 7.5, corr=1007))
    p = spans.summarize(events)
    assert p.unlinked_share == pytest.approx(1.45 / 7.45) and p.unlinked_share > spans.MAX_UNLINKED
    assert spans.device_ms(p, spans.BACKWARD, 4) is None
    assert spans.idle_pct(p, [spans.OPTIMIZER]) is not None  # idle needs no link


def test_events_without_correlation_ids_are_unlinked():
    bare = [SimpleNamespace(name=e.name, device_type=e.device_type, start_ns=e.start_ns,
                            end_ns=e.end_ns, is_user_annotation=e.is_user_annotation)
            for e in training_window()]
    p = spans.summarize(bare)
    assert p.unlinked_share == pytest.approx(1.0)
    assert p.idle_by_span[spans.OPTIMIZER] == pytest.approx(3.1)
    assert spans.device_ms(p, spans.BACKWARD, 4) is None


def demix_window():
    """A 10 s catalogue window: a dispatch's upload under ``umx.prepare``
    (idle 0–0.5 s under the span, 0.6–1.8 s under its ``aten::copy_``),
    its program, its copy out, the combine (idle 5.8–9.0 s), a second
    program, then the harness's loop (idle 9.5–10 s)."""
    return [
        event(trace.WINDOW, 0.0, 10.0, annotation=True, corr=1),
        event("bench.demix_tracks", 0.0, 10.0, annotation=True, corr=2),
        span("umx.prepare", 0.0, 2.0, corr=3),
        kernel("Memset (Device)", 0.5, 0.6, corr=1001),
        event("aten::copy_", 1.0, 2.0, corr=4),
        kernel("Memcpy HtoD (Pageable -> Device)", 1.8, 2.0, corr=1002),
        span("umx.program", 2.0, 5.0, corr=5),
        kernel("lstm_resident_kernel<2, true, 8>", 2.0, 5.0, corr=1003),
        span("umx.to_host", 5.0, 6.0, corr=6),
        kernel("Memcpy DtoH (Device -> Pageable)", 5.0, 5.8, corr=1004),
        span("umx.combine", 6.0, 9.0, corr=7),
        span("umx.program", 9.0, 9.5, corr=8),
        kernel("lstm_resident_kernel<2, true, 8>", 9.0, 9.5, corr=1005),
    ]


def test_no_program_span_no_number():
    events = [e for e in training_window() if not e.name().startswith(spans.PREFIX)]
    assert spans.summarize(events) is None
    assert spans.idle_pct(None, spans.HOST) is None
    assert spans.device_ms(None, spans.BACKWARD, 4) is None
    assert spans.host_idle_pct(None) is None
    readers = cells.readers()
    for events in ([e for e in demix_window() if not e.name().startswith(spans.PREFIX)], None):
        tr = events and trace.summarize(events)[0]
        for name in ("host_idle_pct.demix", "host_idle_pct.track"):
            assert readers[name].read(R.Reading({}, {}, tr, (readers[name].MOVES,))) is None


@pytest.mark.parametrize("name", ["host_idle_pct.demix", "host_idle_pct.track"])
def test_host_idle_readers_read_the_innermost_host_operation(name):
    tr, _ = trace.summarize(demix_window())
    assert tr.idle_by_host == pytest.approx({"umx.prepare": 0.5, "aten::copy_": 1.2,
                                             "umx.combine": 3.2, "bench.demix_tracks": 0.5})
    reader = cells.readers()[name]
    assert reader.read(R.Reading({}, {}, tr, (reader.MOVES,))) == pytest.approx(37.0)
    # the span reading gives the aten op's idle to the span around it
    p = spans.summarize(demix_window())
    assert spans.idle_pct(p, spans.HOST) == pytest.approx(49.0)
    assert spans.idle_pct(p, spans.PROGRAM) == pytest.approx(0.0)
