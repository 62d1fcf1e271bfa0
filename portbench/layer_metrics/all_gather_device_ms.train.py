"""``all_gather_device_ms.train``: the device windows of the ``bsp.all_gather``
spans a step (each bucket's updated shards gathered), summed over the
buckets, in ms.  Nothing to read where the program records no spans
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    split = spans.read(ctx)
    if split is not None:
        return split.device_ms.get("bsp.all_gather")
