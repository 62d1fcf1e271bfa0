"""Continuous-batching serve subsystem (port of ``repro/serve``).

A fixed pool of decode slots over one shared cache; per-layer decode state
goes through the SlotState protocol: contiguous KV rows, paged KV blocks
and recurrent state rows, composed per layer (hybrid stacks mix them).

  engine.ServeEngine       the continuous-batching core
  engine.serve_waves       wave-at-a-time loop: the token-identity oracle
  slot_state.StatePlan     per-layer backend resolution from an ArchConfig
  slot_state.RecurrentRows pooled recurrent-row allocator (row 0 sentinel)
  blocks.BlockAllocator    paged-KV host allocator (free list, refcounts,
                           prefix index, copy-on-write)
  slots.SlotTable          host-side slot bookkeeping mirroring device state
  queue.RequestQueue       arrival-time-gated admission heap + generators
  metrics.ServeMetrics     per-request TTFT, per-step throughput, occupancy,
                           preemption waste, block-pool gauges — on a wall
                           OR virtual step clock
  metrics.P2Quantile       O(1)-memory streaming quantile (P² algorithm)
  soak.run_soak            fault-injected sustained-load soak + SLO
                           recovery check (a runtime.chaos.FaultPlan)

The host modules (blocks, slots, queue, metrics, slot_state) are copies of
the reference's, whose results the tests hold equal.
"""

from .blocks import BlockAllocator, NoFreeBlocks, SENTINEL  # noqa: F401
from .engine import EngineConfig, ServeEngine, serve_waves  # noqa: F401
from .metrics import P2Quantile, ServeMetrics  # noqa: F401
from .queue import (Request, RequestQueue, burst_arrivals,  # noqa: F401
                    poisson_arrivals, parse_arrival_spec, trace_arrivals)
from .soak import (SoakConfig, SoakResult, check_recovery,  # noqa: F401
                   run_soak)
from .slot_state import (NoFreeRows, REC_SENTINEL,  # noqa: F401
                         RecurrentRows, StatePlan)
from .slots import SlotTable  # noqa: F401
