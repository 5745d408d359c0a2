"""Run one cell of the benchmark of ttcross_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells, configurations and metrics are
named in BENCHMARK.json; benchmark/core.py says what a run does.  The last
line of standard output is the run's result, one JSON object; the numbers
that decided "correct" are the last lines of standard error.  Exit codes: 0
with a result, 2 without the CUDA devices the cell needs, 3 where jax,
jaxlib, flax or ttcross_tpu was loaded; another non-zero code where the run
failed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a workload name of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="draws the lottery keys and the check's sample")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: report the per-layer metrics, with one profiled call")
    args = p.parse_args(argv)
    # the build caches at fixed places inside the checkout (the port's own
    # nvcc build lands in build/ttcross_tpu_torch/ there by itself)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
    # one host thread for torch's and numpy's CPU ops: the host paces these
    # calls, and threads that contend with the machine's other work spread
    # the runs (three family runs: 523-636 integrals/s with 8 threads,
    # 533-564 with one; NVIDIA H100 80GB HBM3 host, 8 cores)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))
    from benchmark import core

    return core.main(args, ROOT, T_START)


if __name__ == "__main__":
    sys.exit(main())
