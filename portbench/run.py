"""Run one cell of the port's benchmark on the card it is started on.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and the numbers compared with the reference, each with its limit, as the
last lines of standard error. Exits non-zero, printing no result, when
there is no CUDA card (or fewer than the cell asks for), when the program
(``src/repro_torch`` beside this directory) is missing, or when JAX or the
JAX package were loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every build and kernel cache at a fixed place inside the checkout
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"portbench: the program is missing ({src / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(src)]
    from portbench.harness import cells, main as harness

    try:
        cell = cells.workload(args.workload)
    except (OSError, ValueError) as exc:
        print(f"portbench: no cell {args.workload!r}: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line, checks = harness.execute(cells.BENCH_DIR, args.workload, args.seed,
                                   args.seconds, bool(args.trace), T0)
    loaded = harness.banned_modules()
    if loaded:
        print(f"portbench: modules loaded that no run may load: {loaded}",
              file=sys.stderr)
        return 4
    prog = Path(sys.modules["repro_torch"].__file__).resolve()
    if src.resolve() not in prog.parents:
        print(f"portbench: repro_torch came from {prog}, not {src}",
              file=sys.stderr)
        return 5
    sys.stdout.flush()
    for text in checks:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
