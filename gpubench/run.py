"""Run one cell of the benchmark of ``metalrenderer_tpu_torch`` on one H100.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Builds the
cell's inputs from the seed, warms up the cell's own shapes, drives the
cell's entry in a closed loop for ``--seconds`` (``--trace 1``: under the
profiler, for the cell's ``trace_seconds`` at most, and reports the
per-layer metrics instead of the end-to-end ones), checks the window's
output against the plain reference and prints one JSON line last. It
exits with another code than 0, and prints no result, without a CUDA
device, or when JAX or the JAX package was loaded.
"""
import time

T_PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def finite(x):
    """JSON has no infinity: a number that is not finite reads as the
    largest float."""
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch
    from gpubench.harness import core

    cat = core.Catalog(ROOT / "BENCHMARK.json", HERE)
    chips = int(cat.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result, lines = core.run(ROOT / "BENCHMARK.json", HERE, args.workload,
                             args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_PROCESS_START)
    found = core.banned_modules()
    if found:
        print(f"gpubench: loaded {', '.join(found)} in the measuring "
              "process", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
