"""The readers of a CNN's executor spans (``unfold_ns_per_sample``,
``pool_ns_per_sample`` and ``conv_pad_pct``) on a synthetic window: one
forward of 4 samples through two convs (their unfolds' cells and zeros
known) and a pool, whose device times are known, so each reading is
exact; and a window the spans do not describe, or a program whose conv
spans do not count their cells, reads ``None``."""

from types import SimpleNamespace

import pytest

from dabench import harness
from dabench.drivers import Window
from repro_torch.obs import trace


def _span(name, sid, parent, d0, d1, **args):
    return trace.Span(name, sid, parent, 1, args or None, d0, d1, 0, 7, d0, d1)


def _run(samples=4):
    return SimpleNamespace(traced=Window(seconds=1.0, attempted=1, completed=1, samples=samples))


# forward [0, 1000]: conv [0, 400] with its launch [100, 300]; pool [400, 480];
# conv [480, 900] with its launch [600, 800]; a dense [900, 1000]
WINDOW = [
    _span("adder_graph", 3, 2, 100, 300, batch=4096),
    _span("executor.conv", 2, 1, 0, 400, step=0, table=0, folded=2,
          unfold_cells=27648, pad_cells=1140),
    _span("executor.pool", 4, 1, 400, 480, step=1, table=-1),
    _span("adder_graph", 6, 5, 600, 800, batch=1024),
    _span("executor.conv", 5, 1, 480, 900, step=2, table=1, folded=2,
          unfold_cells=36864, pad_cells=3008),
    _span("executor.dense", 7, 1, 900, 1000, step=3, table=2, folded=0),
    _span("executor.forward", 1, None, 0, 1000, batch=4),
]
# the same forward from a program whose conv spans carry no cell counts
UNCOUNTED = [s._replace(args={k: v for k, v in s.args.items() if not k.endswith("_cells")})
             if s.name == "executor.conv" else s for s in WINDOW]
WANT = {"unfold_ns_per_sample.bulk": (200 + 220) / 4, "pool_ns_per_sample.bulk": 80 / 4,
        "conv_pad_pct.bulk": 100.0 * (1140 + 3008) / (27648 + 36864)}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_known_window(monkeypatch, name):
    monkeypatch.setattr(trace, "spans", lambda: (WINDOW, 0))
    assert harness.reader(name)(_run()) == pytest.approx(WANT[name], rel=1e-12)


def test_pad_share_needs_the_counts(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: (UNCOUNTED, 0))
    assert harness.reader("conv_pad_pct.bulk")(_run()) is None
    # the time readers need no counts
    assert harness.reader("unfold_ns_per_sample.bulk")(_run()) == WANT["unfold_ns_per_sample.bulk"]


def test_pad_share_of_a_valid_design_is_zero(monkeypatch):
    valid = [s._replace(args={**s.args, "pad_cells": 0}) if s.name == "executor.conv" else s
             for s in WINDOW]
    monkeypatch.setattr(trace, "spans", lambda: (valid, 0))
    assert harness.reader("conv_pad_pct.bulk")(_run()) == 0.0


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
