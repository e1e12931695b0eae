"""The port's profiler ranges (``utils/logging.py:span``) on the CPU.

The ranges are read from the Chrome trace of a ``torch.profiler``
session, the form in which ``chip_smoke.py``'s ``profile`` phase and the
benchmark's traced window read them."""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from d3human_tpu_torch.models.fields import MLP, DeformMLP
from d3human_tpu_torch.models.geometry import GeometryModel
from d3human_tpu_torch.utils.logging import span

FIT = "d3h.geometry.fit"
STEP, PARTS = FIT + ".step", tuple(FIT + "." + p for p in (
    "forward", "backward", "optimizer"))
FIELDS = "d3h.fields.mlp"


def _trace(fn, path) -> list:
    """The Chrome trace events of ``fn()`` under ``torch.profiler``, CPU
    activities only."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _ranges(events, name):
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"] == name)


def _within(inner, outer):
    return [r for r in inner if outer[0] <= r[0] and r[1] <= outer[1]]


def test_span_without_a_profiler_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = span("d3h.a"), span("d3h.b")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a, b:      # nests, as the fit's spans do
        pass


def test_fit_spans_under_the_profiler(tmp_path):
    gen = torch.Generator().manual_seed(3)
    mlp = MLP(n_freq=2, d_hidden=16, n_hidden=2, skip_in=(1,))
    params = mlp.init(gen, "cpu")
    x = torch.rand(64, 3, generator=gen)
    tgt = torch.rand(64, generator=gen)
    out = {}

    def fit():
        out["fit"] = GeometryModel._fit(
            params, lambda net: ((mlp.apply(net, x)[..., 0] - tgt) ** 2
                                 ).mean(), 3, 1e-3)

    events = _trace(fit, tmp_path / "trace.json")
    assert not torch.autograd._profiler_enabled()
    assert isinstance(out["fit"][1], float)
    (whole,) = _ranges(events, FIT)
    steps = _ranges(events, STEP)
    assert len(steps) == 3 and _within(steps, whole) == steps
    parts = {p: _ranges(events, p) for p in PARTS}
    fields = _ranges(events, FIELDS)
    assert len(fields) == 3
    for step in steps:
        held = [_within(parts[p], step) for p in PARTS]
        assert [len(h) for h in held] == [1, 1, 1]
        (fwd,), (bwd,), (opt,) = held
        assert fwd[1] <= bwd[0] and bwd[1] <= opt[0]
        assert len(_within(fields, fwd)) == 1
    # chip_smoke's reader finds each range; a CPU trace has no device work
    assert chip_smoke.span_ms(events) == {
        n: 0.0 for n in (FIT, STEP, *PARTS, FIELDS)}


@pytest.mark.parametrize("cls", [MLP, DeformMLP])
def test_one_fields_span_per_apply(tmp_path, cls):
    """``DeformMLP.apply`` goes through ``MLP.apply``: one range a call,
    not one nested in another."""
    kw = dict(pose_dim=5) if cls is DeformMLP else {}
    net = cls(n_freq=2, d_hidden=8, n_hidden=2, skip_in=(1,), **kw)
    gen = torch.Generator().manual_seed(4)
    params = net.init(gen, "cpu")
    x = torch.rand(6, 3, generator=gen)
    args = (torch.zeros(5),) if cls is DeformMLP else ()
    events = _trace(lambda: [net.apply(params, x, *args) for _ in range(2)],
                    tmp_path / "trace.json")
    fields = _ranges(events, FIELDS)
    assert len(fields) == 2 and fields[0][1] <= fields[1][0]
