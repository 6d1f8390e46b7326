"""The readers of the metrics taken from the port's own spans
(``spmv_tpu_torch.trace``): on a fabricated buffer, on an empty one, and
with a program that has no recorder."""

from __future__ import annotations

import sys

import pytest

from benchmark import spec
from benchmark.run import Context

from .conftest import ROOT

READERS = ("spmv_per_iter.cg", "spmv_per_iter.power", "replay_launch_us.cg",
           "starved_launch_ms.cg", "wrapper_host_us.cg")


def _buffer():
    from spmv_tpu_torch.trace import Span

    spans, ids = [], iter(range(1, 1000))

    def add(name, request, us, parent=None, **counts):
        t0 = 1_800_000_000_000_000_000 + 10_000_000 * request + 1000 * len(spans)
        s = Span(name, t0, t0 + int(us * 1000), next(ids), parent, request, counts)
        spans.append(s)
        return s

    # two cg solves: 10 iterations on 2 replays of 8 bodies, 6 on 1
    for req, (k, replays) in enumerate(((10, (300, 500)), (6, (400,))), start=1):
        r = add("solve.cg", req, 5000, mode="replay", replays=len(replays),
                host_reads=len(replays) + 1, spmvs=1 + 8 * len(replays), iterations=k)
        add("spmv.wrapper", req, 100 if req == 1 else 60, r.id, launches=2)
        for us in replays:
            add("solve.read", req, 20, r.id)
            add("solve.replay", req, us, r.id, after_read=1)
    # a power iteration job of 100 iterations: 13 replays, none after a read
    r = add("solve.power_iteration", 3, 9000, mode="replay", replays=13, host_reads=0,
            spmvs=105, iterations=100)
    for _ in range(13):
        add("solve.replay", 3, 50, r.id, after_read=0)
    add("spmv.wrapper", 3, 20, r.id, launches=2)
    return spans


def _read(name):
    return spec.metric_reader(ROOT, name)(Context())


def test_readers_on_a_buffer(monkeypatch):
    from spmv_tpu_torch import trace

    monkeypatch.setattr(trace, "spans", _buffer)
    assert _read("spmv_per_iter.cg") == pytest.approx((17 + 9) / 16)
    assert _read("spmv_per_iter.power") == pytest.approx(1.05)
    assert _read("replay_launch_us.cg") == pytest.approx(400.0)
    assert _read("starved_launch_ms.cg") == pytest.approx((0.3 + 0.5 + 0.4) / 2)
    assert _read("wrapper_host_us.cg") == pytest.approx(80.0)


def test_only_launches_after_a_read_are_starved(monkeypatch):
    from spmv_tpu_torch import trace

    spans = _buffer()
    for s in spans:
        if s.name == "solve.replay" and s.request == 1:
            s.counts["after_read"] = 0
    monkeypatch.setattr(trace, "spans", lambda: spans)
    assert _read("starved_launch_ms.cg") == pytest.approx(0.4 / 2)
    for s in spans:
        s.counts["after_read"] = 0
    assert _read("starved_launch_ms.cg") == 0.0  # replays, none starved


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(monkeypatch, name):
    from spmv_tpu_torch import trace

    monkeypatch.setattr(trace, "spans", lambda: [])
    assert _read(name) is None
    # spans of another kind of solve only
    monkeypatch.setattr(trace, "spans", lambda: [
        s for s in _buffer() if s.request == (3 if name.endswith(".cg") else 1)])
    assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_recorder(monkeypatch, name):
    """The parent's program has no ``trace``: the reader gives nothing and
    does not raise."""
    import spmv_tpu_torch

    monkeypatch.setattr(spmv_tpu_torch.trace, "spans", _buffer)
    assert _read(name) is not None
    monkeypatch.delattr(spmv_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "spmv_tpu_torch.trace", None)  # its import fails
    assert _read(name) is None
