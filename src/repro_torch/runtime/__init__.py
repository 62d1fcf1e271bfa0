"""Training runtime (port of ``repro/runtime``): the BSP train step with
uneven shares, the loop with checkpoints, stragglers and heartbeats, the
fault plans, elastic recovery and the train soak."""
