"""The readers of the program's device spans (``dabench/spans.py`` and
the five ``*_ns_per_sample`` metrics), on a synthetic window: one
forward of 4 samples whose steps' device times are known, so each
metric's ns per sample is exact, the five add up to the forward, and a
window the spans do not describe reads ``None``."""

from types import SimpleNamespace

import pytest

from dabench import harness, spans
from dabench.drivers import Window
from repro_torch.obs import trace


def _span(name, sid, parent, d0, d1, **args):
    return trace.Span(name, sid, parent, 1, args or None, d0, d1, 0, 7, d0, d1)


# forward [0, 1000]: dense [0, 300] with its launch [50, 250]; relu; requant;
# residual [500, 1000] over a transpose and a dense [600, 900] with its launch [650, 850]
WINDOW = [
    _span("adder_graph", 3, 2, 50, 250, batch=256),
    _span("executor.dense", 2, 1, 0, 300, step=0, table=0),
    _span("executor.relu", 4, 1, 300, 400, step=1, table=-1),
    _span("executor.requant", 5, 1, 400, 500, step=2, table=-1),
    _span("executor.transpose", 7, 6, 500, 600, step=0, table=-1),
    _span("adder_graph", 9, 8, 650, 850, batch=64),
    _span("executor.dense", 8, 6, 600, 900, step=1, table=1),
    _span("executor.residual", 6, 1, 500, 1000, step=3, table=-1),
    _span("executor.forward", 1, None, 0, 1000, batch=4),
    trace.Span("graph.replay", 10, None, 1, None, 0, 5),  # a host span: not read
]
WANT = {"adder_graph_ns_per_sample.bulk": 100.0, "relu_ns_per_sample.bulk": 25.0,
        "requant_ns_per_sample.bulk": 25.0, "transpose_ns_per_sample.bulk": 25.0,
        "epilogue_ns_per_sample.bulk": 75.0}


def _run(samples=4):
    return SimpleNamespace(traced=Window(seconds=1.0, attempted=1, completed=1, samples=samples))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_known_window(monkeypatch, name):
    monkeypatch.setattr(trace, "spans", lambda: (WINDOW, 0))
    assert harness.reader(name)(_run()) == WANT[name]


def test_the_five_cover_the_forward(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: (WINDOW, 0))
    assert sum(harness.reader(n)(_run()) for n in WANT) == 1000 / 4


def test_self_time_leaves_out_what_children_cover():
    parent = _span("p", 1, None, 0, 100)
    kids = [_span("a", 2, 1, 10, 30), _span("b", 3, 1, 20, 40), _span("c", 4, 1, 90, 120)]
    assert spans.self_ns(parent, kids) == 100 - 30 - 10
    assert spans.self_ns(parent, []) == 100


@pytest.mark.parametrize("name", sorted(WANT))
@pytest.mark.parametrize("case", ["no_spans", "dropped", "untraced", "other_samples", "old_tree"])
def test_reader_finds_nothing(monkeypatch, name, case):
    run = _run(8 if case == "other_samples" else 4)
    if case == "untraced":
        run.traced = None
    if case == "old_tree":
        monkeypatch.delattr(trace, "spans")
    else:
        monkeypatch.setattr(trace, "spans", lambda: ([] if case == "no_spans" else WINDOW,
                                                     1 if case == "dropped" else 0))
    assert harness.reader(name)(run) is None
