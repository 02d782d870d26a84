"""Profiler arithmetic: what a ``torch.profiler`` trace of the window says.

The device timeline is the union of kernel, memcpy and memset intervals per
card (``busy_s``); kernels are grouped by name; idle gaps are labelled by
the host-side operation that overlaps them most.  The kernel and busy-time
rules follow ``chip_smoke.py::_device_profile`` (NCCL's ``nccl:`` ranges
beside its kernels are not counted twice).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class Interval:
    name: str
    start_us: float
    end_us: float
    device: int = -1

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclass
class Trace:
    """One traced window: device intervals, host operations, the span."""

    device_ops: list[Interval] = field(default_factory=list)
    host_ops: list[Interval] = field(default_factory=list)
    window_s: float = 0.0
    devices: tuple[int, ...] = (0,)


def from_profiler(prof, window_s: float, devices: tuple[int, ...]) -> Trace:
    """Read a stopped ``torch.profiler.profile``'s raw events (the kineto
    records: building the profiler's event tree would cost minutes on a
    window's hundreds of thousands of host operations)."""
    from torch.autograd import DeviceType

    tr = Trace(window_s=window_s, devices=tuple(devices))
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() / 1e3
        iv = Interval(name, start, start + e.duration_ns() / 1e3, int(e.device_index()))
        if e.device_type() == DeviceType.CUDA:
            # annotation ranges (NCCL's "nccl:<op>" among them) span kernels
            if not e.is_user_annotation() and not name.startswith("nccl:"):
                tr.device_ops.append(iv)
        elif iv.us > 0:
            tr.host_ops.append(iv)
    return tr


def _union(intervals: list[Interval]) -> list[tuple[float, float]]:
    spans = sorted((iv.start_us, iv.end_us) for iv in intervals)
    out: list[list[float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s_by_device(tr: Trace) -> dict[int, float]:
    """Seconds in which some operation ran, per card of the run."""
    return {
        d: sum(e - s for s, e in _union([iv for iv in tr.device_ops if iv.device == d])) / 1e6
        for d in tr.devices
    }


def busy_s(tr: Trace) -> float:
    """``busy_s_by_device`` averaged over the run's cards."""
    by = busy_s_by_device(tr)
    return sum(by.values()) / max(1, len(by))


def device_seconds_matching(tr: Trace, patterns: list[str]) -> tuple[float, int]:
    """Summed device seconds and count of the operations whose name matches
    any of ``patterns`` (regular expressions, searched)."""
    rx = [re.compile(p) for p in patterns]
    hits = [iv for iv in tr.device_ops if any(r.search(iv.name) for r in rx)]
    return sum(iv.us for iv in hits) / 1e6, len(hits)


def top_device_ops(tr: Trace, top: int = 10) -> list[list]:
    """The device operations that took most time, summed over cards."""
    by: dict[str, float] = {}
    for iv in tr.device_ops:
        by[iv.name] = by.get(iv.name, 0.0) + iv.us / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(tr: Trace, top: int = 10) -> list[list]:
    """The longest idle gaps of the first card inside the window, each
    labelled by the host operation whose calls overlap it most in sum
    (``host python`` where no traced operation does)."""
    dev = tr.devices[0]
    busy = _union([iv for iv in tr.device_ops if iv.device == dev])
    if not busy:
        return []
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out = []
    for s, e in gaps:
        by: dict[str, float] = {}
        for iv in tr.host_ops:
            ov = min(e, iv.end_us) - max(s, iv.start_us)
            # a whole-window wrapper says nothing about the gap
            if ov > 0 and iv.us < 4 * (e - s):
                by[iv.name] = by.get(iv.name, 0.0) + ov
        out.append([max(by, key=by.get) if by else "host python", (e - s) / 1e6])
    return out
