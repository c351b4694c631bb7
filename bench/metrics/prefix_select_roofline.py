"""Share of its roofline that a ``prefix_select`` launch reaches, in %:
the launch's least time on the cell's inputs (set-up's bound: distinct
table entries, indices and outputs once, at 3.35 TB/s) over the mean
device time of the ``prefix_select`` kernels in the profiled window."""


def read(reading):
    tr = reading["trace"]
    ops = [s for _, s in tr["op_seconds"]] if tr else []
    if not ops or sum(ops) <= 0:
        return None
    return 100.0 * reading["bound"]["bound_s"] / (sum(ops) / len(ops))
