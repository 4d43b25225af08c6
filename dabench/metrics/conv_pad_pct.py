"""Share of the cells the convolutions' unfolds wrote in the traced window
that are SAME padding, in percent: the ``pad_cells`` attributes of the
program's ``executor.conv`` device spans over their ``unfold_cells``
(each a count a sample, so the window's spans weigh alike).  ``None``
where no conv span carries the attributes (a program that does not
count them, a design without a conv) or the window holds no span."""

from dabench.spans import window_spans


def read(run):
    spans = window_spans(run)
    if spans is None:
        return None
    convs = [s.args for s in spans if s.name == "executor.conv" and "pad_cells" in (s.args or {})]
    cells = sum(a["unfold_cells"] for a in convs)
    return 100.0 * sum(a["pad_cells"] for a in convs) / cells if cells else None
