"""Spans and counters inside the scan: where its time goes, by layer.

A span names one layer's work on one thread; a counter adds a quantity to
the innermost open span::

    with spans.span("extract", batch=b, block=k):
        ...
        spans.count("d2h_bytes", n)

Recording is off by default.  A call site then costs one test of the module
flag ``_on``: it reads no clock, allocates nothing and takes no lock.  It is
on between ``start()`` and ``stop()`` (``gwas scan --trace-spans``), and
in a scan from the first cell after a ``torch.profiler`` session starts to
the scan's end: the scan session calls ``follow_profiler()`` once a cell,
so a profiled scan carries the program's layers over the same cells as its
``ScanMetrics``, without ``record_function`` ranges or the profiler's
all-threads mode.

On, each span appends one record when it closes: ``name``, ``parent`` (the
name of the enclosing span on the same thread), ``cell`` (``(batch, block)``,
the batch alone, or the parent's), the OS ``thread`` id and ``thread_name``,
``t0_ns``/``t1_ns`` from ``time.time_ns()`` (the clock of the profiler's
records) and its ``counters``.  A span opened with ``device_of=`` a CUDA
tensor also brackets the card's work with two CUDA events on that tensor's
current stream; ``device_ns`` is their interval once the card has passed
both.  Appends are safe from any thread.  Records stay in memory, kept only
while ``start()`` asked for them: ``take()`` hands them out.  Running totals
per name (``n``, total, self time less child spans, device time) and per
counter are kept in every mode; ``summary(since=snapshot())`` folds them
into the ``spans`` block of ``ScanMetrics.summary()``.
"""
from __future__ import annotations

import threading
import time

import torch

__all__ = ["count", "follow_profiler", "snapshot", "span", "start", "stop",
           "summary", "take"]

_on = False          # the one flag a call site tests
_explicit = False    # start() holds recording on, whatever the profiler does
_lock = threading.Lock()
_local = threading.local()
_records: list[dict] = []
_totals: dict[str, list] = {}     # name -> [n, total_ns, self_ns, device_n, device_ns]
_counters: dict[str, int] = {}
_pending: list[tuple] = []        # (record, name, start event, end event)


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str, *, batch=None, block=None, device_of=None):
    """A context manager around one layer's work (see the module docstring)."""
    if not _on:
        return _NULL
    return _Span(name, batch, block, device_of)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` in the innermost open span."""
    if not _on:
        return
    stack = _stack()
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + n
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "cell", "parent", "events", "counters", "child_ns", "t0")

    def __init__(self, name, batch, block, device_of):
        self.name = name
        self.cell = batch if block is None else (batch, block)
        self.events = None
        if device_of is not None and device_of.is_cuda:
            stream = torch.cuda.current_stream(device_of.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
        self.counters: dict[str, int] = {}
        self.child_ns = 0

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.cell is None and self.parent is not None:
            self.cell = self.parent.cell
        stack.append(self)
        if self.events is not None:
            self.events[0].record(self.events[2])
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.events is not None:
            self.events[1].record(self.events[2])
        _stack().pop()
        ns = t1 - self.t0
        if self.parent is not None:
            self.parent.child_ns += ns
        th = threading.current_thread()
        rec = {"name": self.name, "parent": None if self.parent is None else self.parent.name,
               "cell": self.cell, "thread": th.native_id, "thread_name": th.name,
               "t0_ns": self.t0, "t1_ns": t1, "counters": self.counters}
        with _lock:
            tot = _totals.setdefault(self.name, [0, 0, 0, 0, 0])
            tot[0] += 1
            tot[1] += ns
            tot[2] += ns - self.child_ns
            if self.events is not None:
                _pending.append((rec, self.name, self.events[0], self.events[1]))
            if _explicit:
                _records.append(rec)
        return False


def _settle() -> None:
    """Fold the device time of every span whose end event the card has
    passed (caller holds ``_lock``)."""
    left = []
    for rec, name, ev0, ev1 in _pending:
        if ev1.query():
            ns = int(ev0.elapsed_time(ev1) * 1e6)
            rec["device_ns"] = ns
            _totals[name][3] += 1
            _totals[name][4] += ns
        else:
            left.append((rec, name, ev0, ev1))
    _pending[:] = left


def start() -> None:
    """Record from now on, keeping every record for ``take()``."""
    global _on, _explicit
    with _lock:
        _records.clear()
        _explicit = _on = True


def stop() -> None:
    """Stop recording (records and totals stay)."""
    global _on, _explicit
    _explicit = _on = False


def take() -> list[dict]:
    """Hand out the kept records and forget them."""
    with _lock:
        _settle()
        out = list(_records)
        _records.clear()
    return out


def follow_profiler(*, end: bool = False) -> None:
    """Unless ``start()`` holds recording on: switch it on once a
    ``torch.profiler`` session records (one C call while off), and off
    again at the scan's ``end``."""
    global _on
    if _explicit:
        return
    if end:
        _on = False
    elif not _on:
        _on = torch._C._autograd._profiler_enabled()


def snapshot() -> tuple[dict, dict]:
    """The running totals, to be passed to ``summary(since=)`` later."""
    with _lock:
        _settle()
        return {k: list(v) for k, v in _totals.items()}, dict(_counters)


def summary(since: tuple[dict, dict]) -> dict | None:
    """Totals since a ``snapshot()``: per span name ``n``, ``total_s``,
    ``self_s`` and, for spans timed on the card, ``device_s``; and the
    counters.  None when nothing was recorded since."""
    now, counters = snapshot()
    base, base_counters = since
    by_name = {}
    for name, v in now.items():
        b = base.get(name, [0] * 5)
        d = [x - y for x, y in zip(v, b)]
        if d[0]:
            by_name[name] = {"n": d[0], "total_s": round(d[1] / 1e9, 6),
                             "self_s": round(d[2] / 1e9, 6)}
            if d[3]:
                by_name[name]["device_s"] = round(d[4] / 1e9, 6)
    counted = {k: c - base_counters.get(k, 0) for k, c in counters.items()
               if c != base_counters.get(k, 0)}
    if not by_name and not counted:
        return None
    return {"by_name": by_name, "counters": counted}
