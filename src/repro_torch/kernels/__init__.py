"""Hand-written Hopper kernels that replace the reference's Pallas TPU
kernels, one package per kernel family (mirroring ``repro/kernels/``).

Each ``<name>/`` holds ``ref.py`` (the plain PyTorch version, which the CPU
tests run and ``chip_smoke.py`` holds the kernel against), ``csrc/*.cu``
(the CUDA C++ kernel for ``sm_90a``, built by ``build.py``) and ``ops.py``
(the public op).  Dispatch follows the tensor's device: a CPU tensor takes
``ref.py``; a CUDA tensor launches the kernel or raises.  Nothing falls
back from the kernel to the plain version.
"""

