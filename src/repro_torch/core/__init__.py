"""BSP core on one device (port of ``repro/core``): the Schedule IR
(``schedule_ir``, ``tree``) with its three consumers — the rank-stacked
collectives (``collectives``), the event simulator of the paper's Table 1
(``simulator``) and the α-β cost model (``cost_model``) with its autotuner
(``autotune``) — plus the area model, the simulator calibration, fsync
domains (``barrier``), the BSP config and the bucketed SuperstepEngine."""
