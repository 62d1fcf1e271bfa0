"""``reduce_scatter_device_ms.train``: the device windows of the
``bsp.reduce_scatter`` spans a step (each bucket's hops: encode, exchange,
decode-add; and the division by the world), summed over the buckets, in ms.
Nothing to read where the program records no spans (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    split = spans.read(ctx)
    if split is not None:
        return split.device_ms.get("bsp.reduce_scatter")
