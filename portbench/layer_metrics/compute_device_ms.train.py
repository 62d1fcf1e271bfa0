"""``compute_device_ms.train``: the device window of the ``bsp.compute`` span a
step (every rank's forward, backward and pack into the bucket rows), in ms.
Nothing to read where the program records no spans (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    split = spans.read(ctx)
    if split is not None:
        return split.device_ms.get("bsp.compute")
