"""PyTorch + CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``src/repro/`` is the reference; this package mirrors its
layout and names module by module, runs eagerly, and replaces each Pallas
TPU kernel on a ported path with a kernel written by hand for Hopper
(``kernels/<name>/csrc/*.cu``, built by ``kernels/build.py``).

Ported so far (slice 1): paged-KV serving of dense GQA models such as
gemma2-2b — ``configs``, ``models.registry``, ``models.layers``,
``models.transformer``, ``kernels.paged_attention``, ``serve`` and
``launch.serve``.  Everything else raises ``NotImplementedError`` naming the
slice that brings it.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; a CUDA request on a machine without CUDA raises.
"""

from .device import resolve_device  # noqa: F401
