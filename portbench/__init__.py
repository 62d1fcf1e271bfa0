"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on the card:
``run.py`` is the command, ``BENCHMARK.json`` at the repo root lists its
cells and metrics, and everything a cell needs is found by name here."""
