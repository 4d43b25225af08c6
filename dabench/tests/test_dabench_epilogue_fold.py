"""The reader of ``epilogue_fold_pct``, on a synthetic window: one
forward of 4 samples whose first table took its ReLU and requant into its
launch and whose residual is followed by a ReLU and requant run alone, so
the fold's share is exact, and a window the spans do not describe (or a
program whose CMVM spans carry no ``folded`` attribute) reads ``None``."""

from types import SimpleNamespace

import pytest

from dabench import harness
from dabench.drivers import Window
from repro_torch.obs import trace


def _span(name, sid, parent, d0, d1, **args):
    return trace.Span(name, sid, parent, 1, args or None, d0, d1, 0, 7, d0, d1)


def _run(samples=4):
    return SimpleNamespace(traced=Window(seconds=1.0, attempted=1, completed=1, samples=samples))


# the forward with the fold: the first dense took its ReLU and requant,
# the second nothing, and a ReLU and requant after the residual ran alone
FOLDED = [
    _span("adder_graph", 3, 2, 50, 250, batch=256),
    _span("executor.dense", 2, 1, 0, 300, step=0, table=0, folded=2),
    _span("executor.transpose", 7, 6, 500, 600, step=0, table=-1),
    _span("adder_graph", 9, 8, 650, 850, batch=64),
    _span("executor.dense", 8, 6, 600, 900, step=1, table=1, folded=0),
    _span("executor.residual", 6, 1, 500, 900, step=1, table=-1),
    _span("executor.relu", 4, 1, 900, 950, step=2, table=-1),
    _span("executor.requant", 5, 1, 950, 1000, step=3, table=-1),
    _span("executor.forward", 1, None, 0, 1000, batch=4),
]

# the same forward on a program without the fold: no ``folded`` attribute
UNFOLDED = [
    _span("adder_graph", 3, 2, 50, 250, batch=256),
    _span("executor.dense", 2, 1, 0, 300, step=0, table=0),
    _span("executor.relu", 4, 1, 300, 400, step=1, table=-1),
    _span("executor.requant", 5, 1, 400, 500, step=2, table=-1),
    _span("executor.transpose", 7, 6, 500, 600, step=0, table=-1),
    _span("adder_graph", 9, 8, 650, 850, batch=64),
    _span("executor.dense", 8, 6, 600, 900, step=1, table=1),
    _span("executor.residual", 6, 1, 500, 1000, step=3, table=-1),
    _span("executor.forward", 1, None, 0, 1000, batch=4),
]


@pytest.mark.parametrize("window,want", [(FOLDED, 50.0), (FOLDED[:6] + FOLDED[8:], 100.0),
                                         (UNFOLDED, None)])
def test_fold_share_on_a_known_window(monkeypatch, window, want):
    """2 of 4 steps folded; all with none left; none on a program without
    the ``folded`` attribute."""
    monkeypatch.setattr(trace, "spans", lambda: (window, 0))
    assert harness.reader("epilogue_fold_pct.bulk")(_run()) == want


@pytest.mark.parametrize("case", ["no_spans", "dropped", "untraced", "other_samples", "old_tree"])
def test_fold_share_finds_nothing(monkeypatch, case):
    run = _run(8 if case == "other_samples" else 4)
    if case == "untraced":
        run.traced = None
    if case == "old_tree":
        monkeypatch.delattr(trace, "spans")
    else:
        monkeypatch.setattr(trace, "spans", lambda: ([] if case == "no_spans" else FOLDED,
                                                     1 if case == "dropped" else 0))
    assert harness.reader("epilogue_fold_pct.bulk")(run) is None
