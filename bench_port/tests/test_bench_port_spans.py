"""The readers of the program's spans (``benchlib/spans.py``,
``metrics/ot_loop_idle_share.py``, ``gate_idle_share.py``,
``nets_roofline.py``) on a synthetic trace with known gaps, spans and
launching threads."""

from __future__ import annotations

import pytest

from benchlib import counts, spans, spec, trace

MAIN, AUTOGRAD = 1, 2
P = spans.PREFIX


def _events():
    """Times in ns.  The main thread: the gate over [20, 60], the loop over
    [100, 400], the encoder over [500, 600]; the autograd thread: the
    encoder's backward over [700, 900].  Device operations, each with its
    launching call (host start, thread) by correlation id:

    A [0, 30] → gap [30, 70], which starts in the gate, ended by B (main): 40
    B [70, 80] → gap [80, 110] starts outside every span
    C [110, 150] → gap [150, 200] starts in the loop, ended by D (main): 50
    D [200, 250] → gap [250, 260] in the loop, but E came from the autograd
    thread
    E [260, 300] → gap [300, 450] starts in the loop, ended by F (main, after
    the loop): 150
    F [450, 460], G [455, 470] overlap: no gap
    H [510, 530] and I [520, 560], launched in the encoder: 20 + 40
    J [710, 750] launched in the encoder's backward (autograd thread): 40
    K [760, 770] launched on the main thread during that backward: not the
    nets'
    """
    ops = {  # name: (start, end, launch start, launch thread)
        "A": (0, 30, 0, MAIN), "B": (70, 80, 65, MAIN), "C": (110, 150, 105, MAIN),
        "D": (200, 250, 190, MAIN), "E": (260, 300, 255, AUTOGRAD),
        "F": (450, 460, 420, MAIN), "G": (455, 470, 421, MAIN),
        "H": (510, 530, 505, MAIN), "I": (520, 560, 515, MAIN),
        "J": (710, 750, 705, AUTOGRAD), "K": (760, 770, 720, MAIN),
    }
    device, runtime, launches = [], {}, {}
    for k, (name, (s, e, ts, tid)) in enumerate(sorted(ops.items()), start=1):
        if name == "I":
            # found through the host op it is linked to, not a runtime call
            device.append((name, s, e, (0, 1000 + k)))
            launches[1000 + k] = (ts, tid)
        else:
            device.append((name, s, e, (k, 0)))
            runtime[k] = (ts, tid)
    host = [
        (P + "filter.gate", 20, 60, MAIN, False),
        (P + "ot.loop", 100, 400, MAIN, False),
        (P + "ot.replay", 102, 106, MAIN, False),
        (P + "ot.stop_read", 107, 180, MAIN, False),
        (P + "nets.encoder", 500, 600, MAIN, False),
        (P + "nets.encoder.bwd", 700, 900, AUTOGRAD, False),
        ("aten::copy_", 150, 160, MAIN, False),
        ("bench_port::window", 0, 1000, MAIN, True),
    ]
    return {"device": device, "host": host, "launches": launches, "runtime": runtime}


class _Cfg:
    width = 128
    hidden_size = 32


def _ctx(events, window_s=1e-6):
    return {"trace": {"events": events, "spans_window_s": window_s, "steps": 2},
            "cfg": _Cfg(), "b": 8, "t": 50}


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_gaps_and_their_spans():
    events = _events()
    assert [(g0, g1) for g0, g1, _ in spans.idle_gaps(events)] == [
        (30, 70), (80, 110), (150, 200), (250, 260), (300, 450), (470, 510), (560, 710),
        (750, 760)]
    assert spans.idle_ns_under(events, ("filter.gate",)) == 40
    assert spans.idle_ns_under(events, ("ot.loop",)) == 50 + 150
    # the reads and replays nest in the loop: their own gaps are fewer
    assert spans.idle_ns_under(events, ("ot.stop_read",)) == 50
    assert spans.device_ns_under(events, ("nets.encoder", "nets.encoder.bwd")) == 20 + 40 + 40


def test_idle_shares_over_the_host_window():
    ctx = _ctx(_events())
    loop, gate = _read("ot_loop_idle_share", ctx), _read("gate_idle_share", ctx)
    assert loop == pytest.approx(100.0 * 200 / 1000)
    assert gate == pytest.approx(100.0 * 40 / 1000)
    # together no more than the window's whole idle share
    busy_ns = trace.busy_ns(ctx["trace"]["events"]["device"])
    assert busy_ns == 290 and loop + gate <= 100.0 * (1 - busy_ns / 1000)


def test_nets_roofline_is_the_frames_least_time_over_the_spans_device_time():
    enc, dec = counts.conv_ops_per_frame(128)
    dense = 2 * (2 * 4096 * 32)
    ops = 2 * 8 * 50 * (3 * (enc + dec + dense) - counts.first_conv_ops(128))
    want = 100.0 * (ops / 494.7e12) / 100e-9
    assert _read("nets_roofline", _ctx(_events())) == pytest.approx(want)


@pytest.mark.parametrize("name", ["ot_loop_idle_share", "gate_idle_share", "nets_roofline"])
def test_nothing_to_read_without_the_programs_spans_or_the_device(name):
    """The parent program opens no ``nfdpf_torch::`` span; the CPU traces no
    device operation; an untraced run has no trace."""
    events = _events()
    bare = dict(events, host=[h for h in events["host"] if not h[0].startswith(P)])
    assert _read(name, _ctx(bare)) is None
    assert _read(name, _ctx(dict(events, device=[]))) is None
    assert _read(name, {"trace": None}) is None
