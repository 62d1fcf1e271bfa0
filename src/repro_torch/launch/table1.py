"""The paper's Table 1 from the port's event simulator.

  PYTHONPATH=src python -m repro_torch.launch.table1

Synchronization overhead of FSync / FSync+P / Naïve / XY on tile meshes
from Neighbor to 16×16: one row per (mesh × scheme) with the simulated
cycle count, the paper's number and their ratio, then the headline speedup
row of each mesh (FSync+P against the best AMO baseline).  The rows are
``benchmarks/table1.py``'s without its host-time column.  Needs no device.
"""

from typing import Dict

from repro_torch.core.simulator import PAPER_TABLE1, table1

SCHEMES = ("fsync", "fsync_p", "naive", "xy")


def rows(results: Dict[str, dict]):
    """The printed lines of ``table1()``'s results."""
    for name, row in results.items():
        fsync, fsync_p, naive, xy, speedup = PAPER_TABLE1[name]
        paper = {"fsync": fsync, "fsync_p": fsync_p, "naive": naive,
                 "xy": xy}
        for scheme in SCHEMES:
            got = row[scheme]
            yield (f"table1/{name}/{scheme},cycles={got:.0f};"
                   f"paper={paper[scheme]};ratio={got / paper[scheme]:.2f}")
        yield (f"table1/{name}/speedup,sim={row['speedup']:.1f}x;"
               f"paper={speedup}x")


def main(argv=None) -> Dict[str, dict]:
    del argv
    results = table1()
    for line in rows(results):
        print(line)
    return results


if __name__ == "__main__":
    main()
