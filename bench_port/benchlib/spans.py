"""The program's own spans in the traced run: ``nfdpf_torch::<layer>``
ranges that the port opens under a profiler that records the host
(``nfdpf_torch/utils/profiling.py``), read from ``trace.read_events``'s
host events on the profiler's clock.

A device operation belongs to a span when the host call that launched it
(``trace.launch_of``, by correlation id) started inside the span on the
span's thread.  An idle gap of the device (between consecutive device
operations, their intervals merged as in ``trace.busy_ns``) belongs to a
span when the gap starts while the span is open on the thread that launched
the operation ending the gap: the host was inside the span when the device
ran dry, and the next work came from that thread.  Where the program opened
none of the named spans, the readers find nothing to read (the parent of
the PR that added the spans, the CPU).
"""

from __future__ import annotations

import bisect

from benchlib import trace

PREFIX = "nfdpf_torch::"


def ranges(events: dict, layers) -> dict:
    """Each thread's merged (start, end) ranges of the named spans (no
    prefix), sorted; {} where none was recorded."""
    names = {PREFIX + layer for layer in layers}
    by_thread: dict = {}
    for name, s, e, tid, _ in events["host"]:
        if name in names:
            by_thread.setdefault(tid, []).append((s, e))
    for tid, spans in by_thread.items():
        merged = []
        for s, e in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        by_thread[tid] = merged
    return by_thread


def _inside(by_thread: dict, tid, ts) -> bool:
    spans = by_thread.get(tid)
    if not spans:
        return False
    i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= ts <= spans[i][1]


def idle_gaps(events: dict) -> list:
    """(start, end, correlation of the operation that ends it) of each gap
    between the device operations' merged intervals."""
    gaps, end = [], None
    for _, s, e, corr in sorted(events["device"], key=lambda d: d[1]):
        if end is not None and s > end:
            gaps.append((end, s, corr))
        end = e if end is None else max(end, e)
    return gaps


def idle_ns_under(events: dict, layers):
    """Idle ns of the device in gaps that start inside the named spans
    (matched as the module says); None where the spans are absent or no
    device operation was traced."""
    by_thread = ranges(events, layers)
    if not by_thread or not events["device"]:
        return None
    total = 0
    for g0, g1, corr in idle_gaps(events):
        launch = trace.launch_of(events, corr)
        if launch is not None and _inside(by_thread, launch[1], g0):
            total += g1 - g0
    return total


def device_ns_under(events: dict, layers):
    """Device ns of the operations launched inside the named spans; None
    where the spans are absent or no device operation was traced."""
    by_thread = ranges(events, layers)
    if not by_thread or not events["device"]:
        return None
    total = 0
    for _, s, e, corr in events["device"]:
        launch = trace.launch_of(events, corr)
        if launch is not None and _inside(by_thread, launch[1], launch[0]):
            total += e - s
    return total


def idle_share(ctx: dict, layers):
    """% of the host-and-device traced window that the device sat idle in
    gaps under the named spans; None where there is nothing to read."""
    tr = ctx["trace"]
    if tr is None or tr["spans_window_s"] <= 0:
        return None
    idle = idle_ns_under(tr["events"], layers)
    return None if idle is None else 100.0 * idle / 1e9 / tr["spans_window_s"]
