"""``zero1_device_ms.train``: the device windows of the ``bsp.zero1`` spans a
step (each bucket's params packed, its shards gathered, ZeRO-1 AdamW and the
moments' copies), summed over the buckets, in ms.  Nothing to read where the
program records no spans (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    split = spans.read(ctx)
    if split is not None:
        return split.device_ms.get("bsp.zero1")
