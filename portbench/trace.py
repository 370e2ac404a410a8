"""The traced slice: a short, fixed run of the cell's own calls under
``torch.profiler``, read back from its Chrome trace.

The harness wraps the slice in a ``portbench.slice`` range and each call in
a span of the benchmark's own (``record_function``, such as ``sann.batch``).
The trace file goes to the temporary directory and is deleted once read.
Every reading here is of the device's own timeline: the operations (kernels,
copies, fills) with their start and length, and the spans the host was in.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

from portbench import yardstick

SLICE = "portbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """Device operations and benchmark spans of one profiled slice; times in
    seconds from the trace's own origin."""

    def __init__(self, events: List[dict], span_names: Tuple[str, ...]):
        self.ops: List[Tuple[str, float, float]] = []  # (name, start, end)
        self.spans: List[Tuple[str, float, float]] = []
        slice_spans = []
        for e in events:
            cat, ph = e.get("cat", ""), e.get("ph")
            if ph != "X":
                continue
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
            if cat in DEVICE_CATS:
                self.ops.append((e["name"], ts, ts + dur))
            elif cat == "user_annotation":
                if e["name"] == SLICE:
                    slice_spans.append((ts, ts + dur))
                elif e["name"] in span_names:
                    self.spans.append((e["name"], ts, ts + dur))
        starts = [s for s, _ in slice_spans] + [s for _, s, _ in self.ops]
        ends = [e for _, e in slice_spans] + [e for _, _, e in self.ops]
        self.window = (min(starts), max(ends)) if starts else (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of their
        intervals, not their sum (operations of two streams overlap)."""
        return yardstick.union_length(yardstick.clip_intervals([(s, e) for _, s, e in self.ops], *self.window))

    def ops_named(self, part: str):
        return [o for o in self.ops if part in o[0]]

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, and the idle gaps of
        the device summed by the benchmark span the host was in (``host``
        outside every span), each the ``top`` largest."""
        by_op: Dict[str, float] = collections.Counter()
        for name, s, e in self.ops:
            by_op[name[:120]] += e - s
        merged = yardstick.merge_intervals(
            yardstick.clip_intervals([(s, e) for _, s, e in self.ops], *self.window))
        edges = [self.window[0]] + [x for iv in merged for x in iv] + [self.window[1]]
        gaps: Dict[str, float] = collections.Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                mid = (a + b) / 2
                inside = [(e - s, n) for n, s, e in self.spans if s <= mid <= e]
                gaps["idle in " + min(inside)[1] if inside else "idle outside every span"] += b - a
        return {"device_ops": [[n, t] for n, t in by_op.most_common(top)],
                "idle_gaps": [[n, t] for n, t in gaps.most_common(top)]}


def profile(run: Callable[[], None], span_names: Tuple[str, ...]) -> Trace:
    """``run`` once under ``torch.profiler`` (CPU and CUDA), in a
    ``portbench.slice`` range, with the device synchronised at its end."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            run()
            sync()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, span_names)
