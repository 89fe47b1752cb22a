"""The traced run: spans the harness puts around two layers' entries, the
profiler's window, and what is read from its events.

A span is a ``torch.profiler`` range named ``bench_port::<layer>`` around
the layer's entry (the forward), and a second one, ``bench_port::<layer>.bwd``,
opened when the gradient reaches the entry's outputs and closed when it
leaves through its inputs (identity autograd functions at both ends).  A
device operation belongs to a span when the host call that launched it (a
kernel launch or a CUDA-graph replay, matched by the profiler's correlation
id) lies inside the span on the span's thread.  So a layer keeps its device
time when the program replaces its kernels.  Each entry call is also
recorded with its shapes (and, for the resampler, its Sinkhorn iterations)
for the layer's least time.
"""

from __future__ import annotations

import bisect
import contextlib

import torch

PREFIX = "bench_port::"


class _Open(torch.autograd.Function):
    """Identity on the entry's outputs; its backward, which runs once every
    output's gradient is in, opens the layer's backward span."""

    @staticmethod
    def forward(ctx, name, handles, *xs):
        ctx.name, ctx.handles = name, handles
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.handles.append(torch.ops.profiler._record_function_enter_new(ctx.name, None))
        return (None, None) + gs


class _Close(torch.autograd.Function):
    """Identity on the entry's inputs; its backward closes the span."""

    @staticmethod
    def forward(ctx, handles, *xs):
        ctx.handles = handles
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.handles:
            torch.ops.profiler._record_function_exit(ctx.handles.pop())
        return (None,) + gs


def spanned(fn, layer: str, calls: list, describe):
    """``fn`` with its forward inside the span ``layer`` and its backward
    inside ``layer.bwd``; ``describe(args, out)`` gives the record of a
    call, appended to ``calls``.  A call none of whose tensor inputs needs a
    gradient gets no backward span."""
    def wrapper(*args, **kwargs):
        handles: list = []
        grad = torch.is_grad_enabled()
        slots = [i for i, a in enumerate(args)
                 if grad and torch.is_tensor(a) and a.requires_grad]
        args = list(args)
        if slots:
            for i, a in zip(slots, _Close.apply(handles, *(args[i] for i in slots))):
                args[i] = a
        with torch.profiler.record_function(PREFIX + layer):
            out = fn(*args, **kwargs)
        record = describe(args, out)
        outs = [i for i, o in enumerate(out) if torch.is_tensor(o) and o.requires_grad]
        record["backward"] = bool(slots and outs)
        if record["backward"]:
            out = list(out)
            for i, o in zip(outs, _Open.apply(PREFIX + layer + ".bwd", handles,
                                              *(out[i] for i in outs))):
                out[i] = o
            out = tuple(out)
        calls.append(record)
        return out

    return wrapper


@contextlib.contextmanager
def patched(module, name: str, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield original
    finally:
        setattr(module, name, original)


def _device_op(ev, name: str) -> bool:
    """A kernel, copy or fill: not an annotation mirrored onto the device
    and not a synchronisation record (torch builds without
    ``activity_type`` are told by name)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return any(k in kind() for k in ("kernel", "memcpy", "memset"))
    annotation = getattr(ev, "is_user_annotation", None)
    if (annotation is not None and annotation()) or name.startswith(PREFIX):
        return False
    return not any(w in name for w in ("Sync", "Wait Event"))


def read_events(prof) -> dict:
    """From a finished profiler: the device operations (kernels, copies and
    fills: name, start ns, end ns, (own correlation id, linked host op's)),
    the host ops and annotations (name, start, end, thread, is an
    annotation), each host op's (start, thread) by its correlation id and
    each runtime call's by its own, all on the profiler's clock."""
    device, host, launches, runtime = [], [], {}, {}
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if _device_op(ev, name):
                device.append((name, start, start + dur,
                               (ev.correlation_id(), ev.linked_correlation_id())))
            continue
        if name.startswith("cuda"):
            # a CUDA runtime call (a kernel launch, a graph replay), which
            # shares its correlation id with the device operations it started
            runtime[ev.correlation_id()] = (start, ev.start_thread_id())
            continue
        if ev.linked_correlation_id() != 0:
            continue
        annotation = getattr(ev, "is_user_annotation", None)
        host.append((name, start, start + dur, ev.start_thread_id(),
                     bool(annotation()) if annotation is not None else name.startswith(PREFIX)))
        launches[ev.correlation_id()] = (start, ev.start_thread_id())
    return {"device": device, "host": host, "launches": launches, "runtime": runtime}


def launch_of(events: dict, corr) -> tuple | None:
    """(host start, thread) of the call that launched a device operation: the
    runtime call with its correlation id, else the host op it is linked to."""
    own, linked = corr
    return events["runtime"].get(own) or events["launches"].get(linked)


def attributed_share(events: dict) -> float:
    """The share of device time whose launching host call was found."""
    total = sum(e - s for _, s, e, _ in events["device"])
    found = sum(e - s for _, s, e, c in events["device"] if launch_of(events, c) is not None)
    return found / total if total else 0.0


def busy_ns(device) -> int:
    """The union of the device operations' intervals."""
    total, end = 0, None
    for _, s, e, _ in sorted(device, key=lambda d: d[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def span_device_ns(events: dict, layer: str) -> float:
    """Device ns of the operations launched inside ``layer``'s spans
    (forward and backward)."""
    spans = [(s, e, tid) for name, s, e, tid, _ in events["host"]
             if name in (PREFIX + layer, PREFIX + layer + ".bwd")]
    if not spans:
        return 0.0
    by_thread: dict = {}
    for s, e, tid in spans:
        by_thread.setdefault(tid, []).append((s, e))
    for v in by_thread.values():
        v.sort()
    total = 0.0
    for _, s, e, corr in events["device"]:
        launch = launch_of(events, corr)
        if launch is None:
            continue
        ts, tid = launch
        ranges = by_thread.get(tid)
        if not ranges:
            continue
        i = bisect.bisect_right(ranges, (ts, float("inf"))) - 1
        if i >= 0 and ranges[i][0] <= ts <= ranges[i][1]:
            total += e - s
    return total


def breakdown(events: dict, main_thread: int, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device with the innermost host op of the main thread that
    was running at the gap's start."""
    by_name: dict = {}
    for name, s, e, _ in events["device"]:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    intervals = sorted((s, e) for _, s, e, _ in events["device"])
    gaps, end = [], None
    for s, e in intervals:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(s, e, name) for name, s, e, tid, ann in events["host"]
            if tid == main_thread and not ann]
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for g0, g1 in gaps[:top]:
        i = bisect.bisect_right(starts, g0) - 1
        what = "host idle or outside an op"
        best = None
        while i >= 0 and starts[i] >= g0 - 10**10:
            s, e, name = host[i]
            if s <= g0 <= e and (best is None or s >= best[0]):
                best = (s, name)
            i -= 1
        if best is not None:
            what = best[1]
        named.append([what[:120], (g1 - g0) / 1e9])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
