"""Continuous-batching serve subsystem (port of ``repro/serve``, slice 1:
the paged-KV path).

  engine.ServeEngine       the continuous-batching core over paged KV
  slot_state.StatePlan     per-layer backend resolution from an ArchConfig
  blocks.BlockAllocator    paged-KV host allocator (free list, refcounts,
                           prefix index, copy-on-write)
  slots.SlotTable          host-side slot bookkeeping mirroring device state
  queue.RequestQueue       arrival-time-gated admission heap + generators
  metrics.ServeMetrics     per-request TTFT, per-step throughput, occupancy,
                           preemption waste, block-pool gauges — on a wall
                           OR virtual step clock
  metrics.P2Quantile       O(1)-memory streaming quantile (P² algorithm)

The host modules (blocks, slots, queue, metrics, slot_state) are copies of
the reference's, whose results the tests hold equal.
"""

from .blocks import BlockAllocator, NoFreeBlocks, SENTINEL  # noqa: F401
from .engine import EngineConfig, ServeEngine  # noqa: F401
from .metrics import P2Quantile, ServeMetrics  # noqa: F401
from .queue import (Request, RequestQueue, burst_arrivals,  # noqa: F401
                    poisson_arrivals, parse_arrival_spec, trace_arrivals)
from .slot_state import (NoFreeRows, REC_SENTINEL,  # noqa: F401
                         RecurrentRows, StatePlan)
from .slots import SlotTable  # noqa: F401
