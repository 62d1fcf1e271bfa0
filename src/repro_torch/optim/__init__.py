"""Optimizer and wire codecs (port of ``repro/optim``)."""
