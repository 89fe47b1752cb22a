"""The port's spans (``nfdpf_torch/utils/profiling.py``) on the CPU: the
span tree of one train step of the bootstrap DPF and of the NF-DPF with
flows under a host profiler, the spans' counts against the step's own
counters, the backward ranges, and that with no profiler nothing is
recorded, no autograd node is added and the numbers are bit for bit those
of a step under the profiler."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nfdpf_torch.config import DPFConfig
from nfdpf_torch.ops.cuda import sinkhorn_cuda
from nfdpf_torch.train import Trainer
from nfdpf_torch.utils import profiling

B, N, T = 2, 16, 5
BOOTSTRAP = dict(num_particles=N, sequence_length=T, batch_size=B, width=128,
                 resampler_type="ot", measurement="cos", train_type="DPF",
                 use_pallas=True, compute_dtype="float32", ess_threshold=0.97)
# the NF-DPF: flow dynamics and proposal on the packed chains, the CRNVP
# measurement, resampling at every time step
NFDPF = dict(BOOTSTRAP, ess_threshold=1.01, nf_dyn=True, nf_cond=True,
             pallas_coupling=True, measurement="CRNVP")
CONFIGS = {"bootstrap": BOOTSTRAP, "nfdpf": NFDPF}
P = profiling.PREFIX


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.random((B, T, 128, 128, 3), dtype=np.float32),
        "state": (rng.standard_normal((B, T, 4)) * 10).astype(np.float32),
        "start_state": (rng.standard_normal((B, 4)) * 10).astype(np.float32),
    }


def _spans(prof) -> list:
    """(name without the prefix, start, end, thread, inputs) of each span."""
    return [(e.name()[len(P):], e.start_ns(), e.end_ns(), e.start_thread_id(),
             e.concrete_inputs())
            for e in prof.profiler.kineto_results.events() if e.name().startswith(P)]


def _parents(spans) -> dict:
    """Each span's name → the names of its innermost enclosing spans on its
    thread ("" at the top)."""
    parents = collections.defaultdict(set)
    for i, (name, s, e, tid, _) in enumerate(spans):
        enclosing = [(s2, -e2, n2) for j, (n2, s2, e2, t2, _) in enumerate(spans)
                     if j != i and t2 == tid and s2 <= s and e <= e2 and (s2, e2) != (s, e)]
        parents[name].add(max(enclosing)[2] if enclosing else "")
    return parents


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def traced_step(request):
    """One train step of a configuration under a host profiler, with the
    Sinkhorn loop's counters over it."""
    torch.set_num_threads(1)
    trainer = Trainer(DPFConfig(**CONFIGS[request.param]), device="cpu")
    before = dict(sinkhorn_cuda.STREAMING_LOOP)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        metrics = trainer.train_step(_batch(), generator=trainer.generator(3))
    loop = {k: sinkhorn_cuda.STREAMING_LOOP[k] - before[k] for k in before}
    return dict(name=request.param, spans=_spans(prof), metrics=metrics, loop=loop)


def test_span_tree_of_a_train_step(traced_step):
    """Each span nests in the layer above it, by time on its thread."""
    parents = _parents(traced_step["spans"])
    want = {
        "train_step": {""},
        "loss": {"train_step"}, "backward": {"train_step"}, "optimizer": {"train_step"},
        "nets.encoder": {"loss"}, "filter.step": {"loss"}, "losses": {"loss"},
        "nets.decoder": {"losses"},
        "filter.gate": {"filter.step"}, "measurement": {"filter.step"},
        "resample": {"filter.step"}, "ot.loop": {"resample"},
        "ot.replay": {"ot.loop"}, "ot.stop_read": {"ot.loop"},
    }
    if traced_step["name"] == "nfdpf":
        want.update({"dynamics": {"filter.step"}, "proposal": {"filter.step"}})
    assert {k: parents[k] for k in want} == want
    assert set(parents) - set(want) <= {n for n in parents if n.endswith(".bwd")}


def test_backward_ranges_lie_in_the_backward(traced_step):
    """Every ``.bwd`` range sits inside ``backward``; the encoder's and the
    decoder's once, the measurement's at every time step, the flows' and
    the resampler's where their inputs take a gradient."""
    spans = traced_step["spans"]
    (_, b0, b1, _, _), = [s for s in spans if s[0] == "backward"]
    bwd = collections.Counter(s[0] for s in spans if s[0].endswith(".bwd"))
    assert all(b0 <= s <= e <= b1 for name, s, e, _, _ in spans if name.endswith(".bwd"))
    assert bwd["nets.encoder.bwd"] == bwd["nets.decoder.bwd"] == 1
    assert bwd["measurement.bwd"] == T
    if traced_step["name"] == "nfdpf":
        # the first firing's particles are the initial draw, which takes no
        # gradient; the dynamics run twice a step (inverse, then forward on
        # the proposal)
        assert bwd["resample.bwd"] == T - 1
        assert bwd["proposal.bwd"] == T and bwd["dynamics.bwd"] == 2 * T
    else:
        assert "resample.bwd" not in bwd


def test_span_counts_hold(traced_step):
    """``filter.step`` = ``filter.gate`` = T, ``resample`` = the step's
    firings, ``ot.loop`` one a firing and ``ot.replay`` = ``ot.stop_read``
    = the loop's host reads."""
    count = collections.Counter(s[0] for s in traced_step["spans"])
    loop, metrics = traced_step["loop"], traced_step["metrics"]
    assert count["filter.step"] == count["filter.gate"] == T
    assert count["resample"] == metrics["resample_count"] == count["ot.loop"] == loop["calls"]
    assert metrics["resample_count"] >= 1
    assert count["ot.stop_read"] == count["ot.replay"] == loop["host_reads"] >= 1
    assert count["train_step"] == count["loss"] == count["backward"] == 1


def test_spans_carry_the_step_and_the_time_step(traced_step):
    """``train_step`` carries the trainer's step count, each ``filter.step``
    its t."""
    spans = traced_step["spans"]
    assert [s[4] for s in spans if s[0] == "train_step"] == [[1]]
    assert sorted(s[4][0] for s in spans if s[0] == "filter.step") == list(range(T))


def _graph_nodes(tensor) -> collections.Counter:
    seen, stack, names = set(), [tensor.grad_fn], collections.Counter()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names[type(node).__name__] += 1
        stack.extend(fn for fn, _ in node.next_functions)
    return names


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_no_profiler_records_nothing_and_adds_no_node(config, monkeypatch):
    """With no profiler no span is entered (no range of the port's is made,
    in either form the profiler has) and the loss's graph has no identity
    node of the backward ranges, which a profiler's step has."""
    made = []

    class Counting:
        def __init__(self, *args):
            made.append(args)

        def __enter__(self):
            return None

        def __exit__(self, *exc):
            return False

    trainer = Trainer(DPFConfig(**CONFIGS[config]), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        traced, _ = trainer._loss(_batch(), True, generator=trainer.generator(3))
    assert {"_OpenBackward", "_CloseBackward"} <= set(_graph_nodes(traced))

    enter = torch.ops.profiler._record_function_enter_new

    def entering(name, *args):
        # torch's optimizer opens ranges of its own whatever the profiler
        if name.startswith(P):
            made.append((name,) + args)
        return enter(name, *args)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", entering)
    loss, _ = trainer._loss(_batch(), True, generator=trainer.generator(3))
    nodes = _graph_nodes(loss)
    assert not {"_OpenBackward", "_CloseBackward"} & set(nodes)
    loss.backward()
    trainer.train_step(_batch(), generator=trainer.generator(3))
    assert made == []
    # the same graph but for the identity nodes
    traced_nodes = _graph_nodes(traced)
    for name in ("_OpenBackward", "_CloseBackward"):
        del traced_nodes[name]
    assert nodes == traced_nodes


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_numbers_are_bit_equal_with_spans_on_and_off(config):
    """Two trainers from the same initial weights take the same step, one
    under a host profiler: the loss, every gradient and every parameter
    after Adam are bit for bit equal."""
    runs = []
    for traced in (True, False):
        trainer = Trainer(DPFConfig(**CONFIGS[config]), device="cpu")
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                m = trainer.train_step(_batch(), generator=trainer.generator(3))
        else:
            m = trainer.train_step(_batch(), generator=trainer.generator(3))
        runs.append((m, {name: (p.grad.clone(), p.detach().clone())
                         for name, p in trainer.engine.named_parameters() if p.grad is not None}))
    (m_on, on), (m_off, off) = runs
    assert torch.equal(m_on["loss"], m_off["loss"])
    assert m_on["sinkhorn_iters"] == m_off["sinkhorn_iters"]
    assert on.keys() == off.keys() and len(on) > 0
    for name in on:
        assert torch.equal(on[name][0], off[name][0]), name
        assert torch.equal(on[name][1], off[name][1]), name


def test_span_is_one_shared_no_op_without_a_profiler():
    assert profiling.span("a") is profiling.span("b", 3) is profiling._OFF
    with profiling.span("a") as value:
        assert value is None


def test_backward_range_closes_with_the_pass_where_no_input_takes_a_gradient():
    """A call whose inputs need no gradient (the encoder's frames) gets its
    ``.bwd`` range from the gradient's arrival at its output to the end of
    the backward pass; a call whose input takes one closes it there, before
    the rest of the pass."""
    w = torch.ones(3, requires_grad=True)
    frames = torch.arange(3.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enc = profiling.bracket_backward("enc", lambda x: x * w, frames)
        dec = profiling.bracket_backward("dec", lambda z: (z.exp(), z.sum()), enc)
        loss = dec[0].sum() + dec[1]
        with profiling.span("backward"):
            loss.backward()
    spans = {name: (s, e) for name, s, e, _, _ in _spans(prof)}
    assert set(spans) == {"enc", "dec", "backward", "enc.bwd", "dec.bwd"}
    assert spans["backward"][0] <= spans["dec.bwd"][0]
    assert spans["dec.bwd"][1] <= spans["enc.bwd"][0] <= spans["enc.bwd"][1]
    assert spans["enc.bwd"][1] <= spans["backward"][1]
    torch.testing.assert_close(w.grad, frames * (frames * w).detach().exp() + frames)


def test_bracket_backward_without_gradients_is_a_span_alone():
    """Under no_grad, or with no output that takes a gradient, the call is
    spanned and returns its own outputs, with no identity node."""
    x = torch.ones(2, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            y = profiling.bracket_backward("f", torch.exp, x)
        out = profiling.bracket_backward("g", lambda v: (v.detach(), 3), x)
    assert y.grad_fn is None and out[1] == 3 and out[0].grad_fn is None
    assert [s[0] for s in _spans(prof)] == ["f", "g"]


def test_trace_exports_the_spans_in_the_chrome_trace(tmp_path):
    """``trace(logdir)``, the operator's exporter, writes the spans into the
    Chrome trace with the rest of the profiler's events."""
    import json

    trainer = Trainer(DPFConfig(**BOOTSTRAP), device="cpu")
    with profiling.trace(str(tmp_path / "prof")):
        trainer.train_step(_batch(), generator=trainer.generator(3))
    with open(tmp_path / "prof" / "trace.json") as fh:
        names = collections.Counter(ev.get("name") for ev in json.load(fh)["traceEvents"])
    assert names[P + "train_step"] == 1 and names[P + "filter.step"] == T
    assert names[P + "ot.stop_read"] >= 1 and names[P + "nets.encoder.bwd"] == 1
