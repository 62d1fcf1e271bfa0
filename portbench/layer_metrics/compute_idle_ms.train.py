"""``compute_idle_ms.train``: the card's idle ms a step put down to
``bsp.compute``: the gaps between device operations that a launch ended
while the host was inside that span.  Read in the profiled pass, so it holds
the profiler's host cost.  Nothing to read where the program records no
spans (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    split = spans.read(ctx)
    if split is not None:
        return split.idle_by_phase.get("bsp.compute")
