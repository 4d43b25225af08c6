"""Share of the integer executor's ReLU and requant steps that ran inside
an adder-graph launch's epilogue in the traced window, in percent: the
``folded`` attributes of the program's ``executor.dense`` and
``executor.conv`` device spans over those plus the ``executor.relu`` and
``executor.requant`` spans that ran as steps of their own.  ``None`` where
no CMVM span carries the attribute (a program without the fold) or the
window holds no such step."""

from dabench.spans import window_spans


def read(run):
    spans = window_spans(run)
    if spans is None:
        return None
    cmvm = [s for s in spans if s.name in ("executor.dense", "executor.conv")]
    if not any("folded" in (s.args or {}) for s in cmvm):
        return None
    folded = sum(s.args.get("folded", 0) for s in cmvm)
    steps = sum(s.name in ("executor.relu", "executor.requant") for s in spans)
    return 100.0 * folded / (folded + steps) if folded + steps else None
