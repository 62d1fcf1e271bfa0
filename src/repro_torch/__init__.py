"""PyTorch + CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``src/repro/`` is the reference; this package mirrors its
layout and names module by module, runs eagerly, and replaces each Pallas
TPU kernel on a ported path with a kernel written by hand for Hopper
(``kernels/<name>/csrc/*.cu``, built by ``kernels/build.py``).

Ported so far, slice by slice:
  1. paged-KV serving of dense GQA models such as gemma2-2b — ``configs``,
     ``models.registry``, ``models.layers``, ``models.transformer``,
     ``kernels.paged_attention`` (B7), ``serve`` and ``launch.serve``;
  2. the BSP training superstep — ``core`` (rank-stacked collectives,
     ``bsp``, ``superstep``), ``optim``, ``data``, ``runtime``,
     ``launch.train`` and the codec decode-add kernels of
     ``kernels.tree_reduce`` (B1, B2);
  3. paged MLA + MoE serving of DeepSeek-V3 — MLA and MoE layers and the
     absorbed-MLA decode kernel of ``kernels.paged_attention`` (B8);
  4. the public kernel ops — ``kernels.tree_reduce`` (``tree_reduce``,
     ``encode_rows``, ``coded_tree_reduce``: B3, B4), ``kernels.gemm``
     (B6) and ``kernels.flash_attention`` (B5 forward, backward by
     recompute);
  8. the Schedule IR, its simulator, cost model and autotuner — the rest
     of ``core`` and ``launch.table1``;
  9. qwen2.5-3b, phi4-mini-3.8b, granite-34b and qwen3-moe-235b-a22b
     (``configs``), uneven micro-batch shares (``runtime.trainer``,
     ``data``), checkpoints (``checkpoint``, with its own msgpack codec)
     and fault tolerance (``runtime.chaos``, ``fault_tolerance``,
     ``elastic``, ``loop``, ``soak``);
  13. the sharding surface — ``launch.mesh`` (meshes of virtual devices
     on one torch device), ``models.sharding``, ``models.act_sharding``,
     the GSPMD tier of ``runtime.trainer`` (``--schedule xla``) with the
     pytree AdamW, ``elastic.reshard_state`` and mesh-sharded serving
     (``launch.serve --devices N``).
Every Pallas kernel of the reference now has a counterpart here.  Whatever
else is not ported raises ``NotImplementedError``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; a CUDA request on a machine without CUDA raises.
"""

from .device import resolve_device  # noqa: F401
