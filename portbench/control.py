"""Read a cell's control: the reference put in the program's place and
computed in the next lower precision than the configuration states, at
the cell's own size, for each of ``--seeds``.

    python portbench/control.py --workload <cell> --seeds 1 2 3

Prints one JSON line per seed with the number the cell compares, as the
control gives it. The benchmark's runs never run this; its readings set
the upper end of each limit (``PERF.md``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import cells  # noqa: E402
from portbench.harness.main import Ctx  # noqa: E402


def control_ctx(name: str, seed: int, bench: Path, device: str) -> Ctx:
    cell = cells.workload(name, bench)
    return Ctx(bench, name, cell, cells.config(cell["config"], bench),
               cells.traffic(cell["traffic"], bench), seed, 0.0, False,
               device)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench", default=str(cells.BENCH_DIR),
                    help="the benchmark directory (a copy, in tests)")
    args = ap.parse_args()
    for seed in args.seeds:
        ctx = control_ctx(args.workload, seed, Path(args.bench), args.device)
        drv = cells.driver(ctx.cell["driver"], Path(args.bench))
        t = time.perf_counter()
        out = drv.control(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
