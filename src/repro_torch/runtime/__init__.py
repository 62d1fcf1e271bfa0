"""Training runtime (port of ``repro/runtime``, slice 2: the BSP train
step and loop)."""
