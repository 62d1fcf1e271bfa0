"""The benchmark of the PyTorch and CUDA port on the card.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Run from the root of a checkout.  Builds the cell's program from the seed,
warms it up (its first steps, which the correctness check reads), times it
for ``--seconds`` and prints the cell's end-to-end metrics (``--trace 0``)
or its per-layer metrics (``--trace 1``) as the last line of standard
output, a JSON object, after checking what the timed path produced against
the plain reference; the compared numbers and their limits are also the
last lines of standard error.  Exits 2, printing no result, without enough
CUDA devices for the cell, and 3 if a module of JAX or of the JAX package
was loaded.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache in fixed directories of the checkout
CACHE = ROOT / "build" / "portbench-cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    from portbench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = harness.driver(cell.kind).run(cell, args, torch.device("cuda", 0),
                                        T0)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(harness.checks_text(res["checks"]), file=sys.stderr)
    print(res["line"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
