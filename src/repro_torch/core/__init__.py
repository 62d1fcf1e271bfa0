"""BSP core on one device (port of ``repro/core``, slice 2): the
rank-stacked FractalSync collectives, the BSP config and the bucketed
SuperstepEngine.  The Schedule IR, cost model, simulator and autotuner
come with ROADMAP A3."""
