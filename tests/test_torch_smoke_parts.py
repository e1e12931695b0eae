"""``chip_smoke.parts_ms`` on the CPU with a stand-in profiler: a trace that
lacks a needed part's device rows is taken again with the next, wider
host-idle window of ``PARTS_PAD_S``, the parts are summed from the first
complete trace, and after the last try the callers' checks see the last
trace."""

import types

import pytest
import torch

import chip_smoke

CUDA = torch.autograd.DeviceType.CUDA
PARTS = {"count_ms": ("first_k_count_kernel",),
         "write_ms": ("first_k_write_kernel",)}


def _row(name, us):
    return types.SimpleNamespace(name=name, device_type=CUDA,
                                 device_time_total=us)


def _fake_profiler(monkeypatch, traces):
    """``torch.profiler.profile`` yielding ``traces`` in turn; returns the
    pads slept before the calls of each trace and the calls of ``fn``."""
    seen = {"pads": [], "calls": 0, "trace": -1}

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            seen["trace"] += 1
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return traces[min(seen["trace"], len(traces) - 1)]

    def sleep(s):
        # the pad before the calls, not the one after them
        if len(seen["pads"]) <= seen["trace"]:
            seen["pads"].append(s)

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke.time, "sleep", sleep)
    return seen


@pytest.mark.parametrize("lost", [0, 1, 3])
def test_parts_ms_retakes_a_trace_that_lost_rows(monkeypatch, lost):
    full = [_row("first_k_count_kernel", 50.0),
            _row("first_k_write_kernel", 100.0)]
    # a lost trace: no device row, or the write kernel's rows alone
    traces = [[], [full[1]], []][:lost] + [full]
    seen = _fake_profiler(monkeypatch, traces)
    calls = []
    out = chip_smoke.parts_ms(lambda: calls.append(1), PARTS, reps=5)
    assert seen["pads"] == list(chip_smoke.PARTS_PAD_S[:lost + 1])
    assert len(calls) == 1 + 5 * (lost + 1)
    assert out == {"count_ms": 0.05 / 5, "write_ms": 0.1 / 5,
                   "other_ms": 0.0}


def test_parts_ms_gives_the_last_trace_after_every_try(monkeypatch):
    part = [_row("first_k_write_kernel", 100.0), _row("other_kernel", 5.0)]
    seen = _fake_profiler(monkeypatch, [part])
    out = chip_smoke.parts_ms(lambda: None, PARTS, reps=1)
    assert seen["pads"] == list(chip_smoke.PARTS_PAD_S)
    assert out == {"count_ms": 0.0, "write_ms": 0.1, "other_ms": 0.005}


def test_parts_ms_needs_only_the_parts_asked_for(monkeypatch):
    parts = chip_smoke.SCATTER_PARTS
    # a sorted call: no key preparation and no sort
    seen = _fake_profiler(monkeypatch, [[_row("segsum_tile_kernel", 20.0)]])
    out = chip_smoke.parts_ms(lambda: None, parts, need=("sum_ms",), reps=2)
    assert seen["pads"] == [chip_smoke.PARTS_PAD_S[0]]
    assert out == {"prep_sort_ms": 0.0, "sum_ms": 0.01, "other_ms": 0.0}


def test_parts_ms_leaves_out_the_user_annotation_rows(monkeypatch):
    """A ``record_function`` range shows as a CUDA row flagged as a user
    annotation: it is no device work, and no part or ``other_ms`` holds
    it."""
    note = types.SimpleNamespace(name="d3h.fields.mlp", device_type=CUDA,
                                 device_time_total=1000.0,
                                 is_user_annotation=True)
    full = [_row("first_k_count_kernel", 50.0),
            _row("first_k_write_kernel", 100.0), note]
    _fake_profiler(monkeypatch, [full])
    out = chip_smoke.parts_ms(lambda: None, PARTS, reps=1)
    assert out == {"count_ms": 0.05, "write_ms": 0.1, "other_ms": 0.0}


def _annotation(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1}


def _launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 2, "tid": tid, "args": {"correlation": corr}}


def _device(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


def test_span_ms_books_work_by_its_launch_time():
    """Nested ranges each count what was launched inside them; a kernel
    launched from autograd's thread (tid 2) inside the backward's range
    counts there; the device's own annotation rows and work launched
    outside every range count toward none."""
    events = [
        _annotation("d3h.geometry.fit.step", 0, 100),
        _annotation("d3h.geometry.fit.forward", 0, 40),
        _annotation("d3h.fields.mlp", 5, 30),
        _annotation("d3h.geometry.fit.backward", 40, 50),
        _annotation("d3h.fields.mlp", 500, 10, cat="gpu_user_annotation"),
        _annotation("d3h_bench.step", 0, 1000),
        _launch(1, 10), _device(1, 20, 1000),               # in the mlp
        _launch(2, 37), _device(2, 60, 500),                # forward alone
        _launch(3, 45, tid=2), _device(3, 100, 2000),       # backward
        _launch(4, 50), _device(4, 120, 250, "gpu_memset"),
        _launch(5, 95), _device(5, 130, 125, "gpu_memcpy"),  # step alone
        _launch(6, 200), _device(6, 300, 4000),             # outside all
        _device(7, 400, 8000),                              # no launch
    ]
    assert chip_smoke.span_ms(events) == {
        "d3h.geometry.fit.step": 3.875,
        "d3h.geometry.fit.forward": 1.5,
        "d3h.fields.mlp": 1.0,
        "d3h.geometry.fit.backward": 2.25,
    }


def test_span_ms_without_a_port_range_is_empty():
    events = [_annotation("d3h_bench.window", 0, 100), _launch(1, 10),
              _device(1, 20, 1000)]
    assert chip_smoke.span_ms(events) == {}
