"""The readings a cell's correctness limits are set from (not part of a
benchmark run).

  python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
      [--variant-seeds 3]

For each seed, in one process: the program's first steps at the cell's
own size (the same call and feed as a run's set-up), then the plain
reference, then each variant of the reference put in the program's place
(``fp8``, the control: the matmul inputs through fp8; ``half_batch``;
``no_exchange``) on the first ``--variant-seeds`` seeds.  Prints one JSON
line per seed: every compared number of the program against the
reference, and of each variant against it.  The lower reading of a number
is the largest the program gives over the seeds, the upper the smallest a
variant gives; the limit goes between them.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
VARIANTS = ("fp8", "half_batch", "no_exchange")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    from portbench.drivers import bsp_train as D
    from portbench.reference import bsp as ref
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    model = ref.Model.of(cell.config)
    for i, seed in enumerate(args.seeds):
        t0 = time.monotonic()
        batches = ref.make_batches(model, cell.traffic, seed, D.FIRST_STEPS,
                                   dev)
        step_fn, state = D.build_step(cell, model, seed, dev)
        prog = D.first_steps(step_fn, state, model, cell, seed, batches, dev)
        del step_fn, state
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.monotonic()
        expect = ref.run(model, cell.traffic, seed, batches, dev)
        out = {"seed": seed, "program": ref.compare(prog, expect),
               "losses": {"program": prog.losses, "reference": expect.losses},
               "seconds": {"program": t1 - t0,
                           "reference": time.monotonic() - t1}}
        if i < args.variant_seeds:
            for v in VARIANTS:
                got = ref.run(model, cell.traffic, seed, batches, dev,
                              variant=v)
                out[v] = dict(ref.compare(got, expect), losses=got.losses)
        print(json.dumps(out), flush=True)
        del expect, batches
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
