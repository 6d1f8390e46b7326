"""Spans of the port's work on the host, on the clock of the profiler's
trace.

A span is a named stretch of host time at a boundary of the port's layers:
its name, its start and end in nanoseconds since the Unix epoch (the clock
of ``torch.profiler``'s kineto events, read by ``time.time_ns``), the span
open around it when it began (its parent), the request it belongs to, and
the counts taken at that boundary. A span opened with no span open around
it starts a request of its own: each public solve and each ``from_coo``
call is one.

=================  ===================================  ===========================
span               where                                counts
=================  ===================================  ===========================
solve.cg,          ``solve.cg``, ``bicgstab``,          iterations, spmvs, replays,
solve.bicgstab,    ``power_iteration``                  host_reads, mode (eager,
solve.power_...                                         capture or replay); cg:
                                                        rhs, and on a block
                                                        column_iterations
solve.capture      the CUDA graph loop's capture        bodies
solve.replay       each graph replay                    after_read
solve.read         each host read of a solve's value
spmv.wrapper       each engine wrapper call of a        launches, x_gathers
                   container's ``matvec``/``matmat``
plan.from_coo      ``api.from_coo``                     nnz, bytes
plan.host          ``build_csr_plan``,
                   ``build_panel_plan``
plan.upload        ``DevCsr/DevPanel.from_plan``        relabeled, top_share,
                                                        near_share (CSR plans);
                                                        hot_cols, hot_share
                                                        (relabelled plans)
=================  ===================================  ===========================

Spans are recorded only while the recorder is armed: after ``enable()``
until ``disable()``, or while a ``torch.profiler`` records. Disarmed, a
solve pays one arming check and an eager wrapper call one. While a
profiler records, each span also opens a ``record_function`` range of its
own name, so the spans appear in the profiler's timeline. No span name
holds a key of ``kernels.engines.LAUNCHES``: a trace reader that counts
the port's kernels by those names must not count a span.

Recorded spans go to a bounded buffer: ``spans()`` returns it, oldest
first by end, ``clear()`` empties it, and ``dropped()`` says how many
spans fell off its end since the last ``clear()``.

    from spmv_tpu_torch import solve, trace
    trace.enable()
    solve.cg(a, b)
    trace.disable()
    for s in trace.spans():
        print(s.name, s.seconds, s.counts)
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass

import torch
from torch.autograd.profiler import record_function

__all__ = ["Span", "Recorder", "BOUND", "armed", "enable", "disable", "spans", "clear",
           "dropped", "span", "maybe", "traced", "current"]

BOUND = 1 << 16  # spans the buffer keeps

_profiling = torch._C._autograd._profiler_enabled


@dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None  # the id of the span open around this one
    request: int
    counts: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Stack(threading.local):
    def __init__(self):
        self.open: list[Span] = []


class Recorder:
    """The buffer of closed spans, its arming switch, and each thread's
    open spans."""

    def __init__(self, bound: int = BOUND):
        self.on = False
        self.buffer: deque[Span] = deque(maxlen=bound)
        self.dropped = 0
        self.stack = _Stack()
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)

    def keep(self, s: Span) -> None:
        if len(self.buffer) == self.buffer.maxlen:
            self.dropped += 1
        self.buffer.append(s)


_REC = Recorder()


def armed() -> bool:
    """Whether spans are recorded now: after ``enable()``, or while a
    ``torch.profiler`` records."""
    return _REC.on or _profiling()


def enable() -> None:
    _REC.on = True


def disable() -> None:
    """Undo ``enable()``; a recording profiler still arms the recorder."""
    _REC.on = False


def spans() -> list[Span]:
    return list(_REC.buffer)


def clear() -> None:
    _REC.buffer.clear()
    _REC.dropped = 0


def dropped() -> int:
    return _REC.dropped


def current() -> Span | None:
    """The innermost span open on this thread."""
    stack = _REC.stack.open
    return stack[-1] if stack else None


class span:
    """Record the body as a span named ``name``, whether armed or not (the
    caller has decided); ``with`` gives the ``Span``, whose ``counts`` the
    body may add to. ``counts`` are its first counts."""

    __slots__ = ("name", "counts", "_span", "_range")

    def __init__(self, name: str, **counts):
        self.name, self.counts = name, counts

    def __enter__(self) -> Span:
        stack = _REC.stack.open
        parent = stack[-1] if stack else None
        s = self._span = Span(self.name, 0, 0, next(_REC._ids),
                              parent.id if parent else None,
                              parent.request if parent else next(_REC._requests),
                              self.counts)
        self._range = record_function(self.name) if _profiling() else None
        s.start_ns = time.time_ns()
        if self._range is not None:
            self._range.__enter__()
        stack.append(s)
        return s

    def __exit__(self, *exc) -> None:
        _REC.stack.open.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        s = self._span
        s.end_ns = time.time_ns()
        _REC.keep(s)


_OFF = contextlib.nullcontext()


def maybe(name: str, **counts):
    """``span(name)`` where armed, else a context that records nothing and
    gives None."""
    return span(name, **counts) if armed() else _OFF


def traced(name: str, tally=None):
    """Decorate a function so that each call made while armed is a span
    named ``name``; a call made inside a span of that name is part of it,
    not a span of its own. ``tally``, a function of no arguments returning
    running totals by name, gives the span each total's growth over the
    call as a count."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not armed():
                return fn(*args, **kwargs)
            inner = current()
            if inner is not None and inner.name == name:
                return fn(*args, **kwargs)
            if tally is None:
                with span(name):
                    return fn(*args, **kwargs)
            before = tally()
            with span(name) as s:
                out = fn(*args, **kwargs)
                after = tally()
                s.counts.update({k: after[k] - before.get(k, 0) for k in after})
            return out
        return call
    return wrap
