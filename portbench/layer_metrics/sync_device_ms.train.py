"""``sync_device_ms.train``: the device window of the ``bsp.sync`` span a step
(the bucket loop, the unpack into the params and the fsync), in ms.  Nothing
to read where the program records no spans (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    split = spans.read(ctx)
    if split is not None:
        return split.device_ms.get("bsp.sync")
