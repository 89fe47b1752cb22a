"""Profiling: spans on the profiler's clock, and a Chrome-trace exporter.

Counterpart of ``nfdpf_tpu/utils/profiling.py`` (its ``trace``):

  * ``span(name, args=None)``: a range ``nfdpf_torch::<name>`` in the trace
    of the ``torch.profiler`` that is recording, else nothing;
  * ``bracket_backward(name, fn, *inputs)``: ``fn(*inputs)`` inside
    ``span(name)``, and its backward inside ``nfdpf_torch::<name>.bwd``;
  * ``trace(logdir)``: context manager around ``torch.profiler`` (host, and
    the GPU when there is one) that writes a Chrome trace of everything
    inside, spans included, to ``logdir/trace.json``.

A span is a ``RecordFunction`` of the profiler, entered through
``torch._C._profiler._RecordFunctionFast``: its start and end sit on the
same clock as the kernels, copies and graph launches of the trace, so a
span is compared with the device's work directly (a device operation
belongs to the span that was open on the thread that launched it).  The
spans stay in the profiler's memory until it ends.  With no profiler
recording, ``span`` returns one shared no-op context and
``bracket_backward`` calls ``fn`` as it is: no RecordFunction is made and
no autograd node is added.  Under a profiler that records the device
alone a span records nothing; ``torch.profiler.record_function`` would
still cost ~7.6 us a span there (its operator goes through the
dispatcher), the fast form ~0.6 us (an H100 host, torch 2.11).
"""

from __future__ import annotations

import contextlib
import os

import torch

PREFIX = "nfdpf_torch::"


class _Off:
    """The shared no-op context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, args=None):
    """A context recording ``nfdpf_torch::<name>`` while a torch profiler
    records (``args``, e.g. a step's index, goes with it as the range's
    input, shown under ``record_shapes``), else the shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if args is None:
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return torch._C._profiler._RecordFunctionFast(PREFIX + name, (args,))


class _Backward:
    """One call's backward range: opened once, closed once (``range`` is
    None before it opens and False once it has closed)."""

    __slots__ = ("name", "range")

    def __init__(self, name: str):
        self.name, self.range = name, None

    def open(self) -> None:
        if self.range is None:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
            # where no input takes a gradient the range closes with the
            # backward pass
            torch.autograd.Variable._execution_engine.queue_callback(self.close)

    def close(self) -> None:
        opened, self.range = self.range, False
        if opened:
            opened.__exit__(None, None, None)


class _Open(torch.autograd.Function):
    """Identity on a call's outputs; its backward, which runs once every
    output's gradient is in, opens the call's backward range."""

    @staticmethod
    def forward(ctx, bwd, *xs):
        ctx.bwd = bwd
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.bwd.open()
        return (None,) + gs


class _Close(torch.autograd.Function):
    """Identity on a call's inputs; its backward closes the range."""

    @staticmethod
    def forward(ctx, bwd, *xs):
        ctx.bwd = bwd
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.bwd.close()
        return (None,) + gs


def _graded(values) -> list:
    return [i for i, v in enumerate(values) if torch.is_tensor(v) and v.requires_grad]


def bracket_backward(name: str, fn, *inputs):
    """``fn(*inputs)`` inside ``span(name)``; while a profiler records, its
    backward (where its outputs take a gradient) inside
    ``nfdpf_torch::<name>.bwd``, opened when the gradient reaches the tensor
    outputs (``fn`` returns a tensor or a tuple) and closed when it leaves
    through the tensor inputs, or at the end of the backward pass where no
    input takes a gradient.  Identity autograd functions at both ends mark
    the points; with no profiler recording ``fn`` is called as it is."""
    if not torch.autograd._profiler_enabled():
        return fn(*inputs)
    bwd = _Backward(PREFIX + name + ".bwd")
    inputs = list(inputs)
    slots = _graded(inputs)
    if slots:
        for i, x in zip(slots, _Close.apply(bwd, *(inputs[i] for i in slots))):
            inputs[i] = x
    with span(name):
        out = fn(*inputs)
    single = torch.is_tensor(out)
    outs = [out] if single else list(out)
    slots = _graded(outs)
    if not slots:
        return out
    for i, y in zip(slots, _Open.apply(bwd, *(outs[i] for i in slots))):
        outs[i] = y
    return outs[0] if single else tuple(outs)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; the Chrome trace (Perfetto, chrome://tracing) goes
    to ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
