"""The traced window, read from ``torch.profiler``'s timeline.

The profiler runs around the measured window only.  Its Chrome trace is
written to the run's temporary directory, read once and deleted.  What the
readers of the per-layer metrics get is a :class:`Trace`: the device
operations (kernels, copies, fills) with their names and intervals, the
host ranges the harness puts around its own calls (``frame.dispatch``,
``frame.copy``, ``step.dispatch``, ...), and the window's bounds.  All
times are seconds.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"


@dataclass
class Trace:
    ops: list = field(default_factory=list)      # (name, start, end)
    ranges: list = field(default_factory=list)   # (name, start, end), host
    start: float = 0.0
    end: float = 0.0

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def in_window(self):
        return [(n, max(a, self.start), min(b, self.end)) for n, a, b in self.ops
                if b > self.start and a < self.end]

    def busy(self) -> list:
        """The union of the device intervals inside the window, merged."""
        spans = sorted((a, b) for _, a, b in self.in_window())
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def idle_gaps(self) -> list:
        """(start, seconds) of each stretch of the window with no device
        operation."""
        edges = [self.start] + [x for ab in self.busy() for x in ab] + [self.end]
        return [(a, b - a) for a, b in zip(edges[0::2], edges[1::2]) if b > a]

    def label_at(self, t: float) -> str:
        """The innermost harness range the host was in at ``t``
        ("host.other" outside them)."""
        best, width = "host.other", float("inf")
        for name, a, b in self.ranges:
            if name != WINDOW and a <= t < b and b - a < width:
                best, width = name, b - a
        return best

    def by_name(self) -> dict:
        out: dict = {}
        for n, a, b in self.in_window():
            out[n] = out.get(n, 0.0) + (b - a)
        return out

    def named(self, pred) -> list:
        """The window's device operations whose name satisfies ``pred``, in
        order of start."""
        return sorted((x for x in self.in_window() if pred(x[0])),
                      key=lambda x: x[1])

    def breakdown(self, top: int = 10, width: int = 160) -> dict:
        """The device operations that took most time (names cut to
        ``width`` characters) and the longest idle gaps, by label."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:width], s] for n, s in ops],
                "idle_gaps": [[self.label_at(a), s] for a, s in gaps]}


def read(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    tr = Trace()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            tr.ops.append((e.get("name", "?"), a, b))
        elif cat == "user_annotation":
            tr.ranges.append((e.get("name", "?"), a, b))
    windows = [(a, b) for n, a, b in tr.ranges if n == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window range")
    tr.start, tr.end = windows[0]
    return tr
