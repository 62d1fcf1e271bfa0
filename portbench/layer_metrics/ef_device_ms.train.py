"""``ef_device_ms.train``: the device windows of the ``bsp.ef`` spans a step
(the EF add and the codec's residual of each codec'd bucket), summed over
the buckets, in ms.  Nothing to read where the program records no spans
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    split = spans.read(ctx)
    if split is not None:
        return split.device_ms.get("bsp.ef")
