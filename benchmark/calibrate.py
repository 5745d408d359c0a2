"""The readings that the check's limits are set from, in one process on the card.

    python3 benchmark/calibrate.py --workload <name> --seconds <s> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out FILE]

runs the cell as benchmark/run.py does (set-up, a window of the given
seconds, the check) once per seed, then once per control seed with the
port's float32 tier in place of the configuration's float64 (the control,
which the check has to find not correct), and prints one JSON line per run:
the seed, the tier, "correct", and each compared number.  The benchmark's
own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="", help="comma-separated seeds of the float64 runs")
    p.add_argument("--control-seeds", default="", help="comma-separated seeds of the control")
    p.add_argument("--out", help="also append the lines to this file")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import core

    if not torch.cuda.is_available():
        print("calibrate.py runs on the card", file=sys.stderr)
        return 2
    cell = core.load_cell(ROOT, args.workload)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), torch.float32) for s in args.control_seeds.split(",") if s]
    for seed, dtype in runs:
        out, notes = core.run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                                   dtype=dtype)
        line = json.dumps({"workload": cell.name, "seed": seed,
                           "tier": "float32" if dtype else cell.config["dtype"],
                           "correct": out["correct"], "failed": out["failed"],
                           "attempted": out["attempted"], "metrics": out["metrics"],
                           "checks": {k: c["value"] for k, c in out["checks"].items()},
                           "check_note": [n for n in notes if n.startswith("check:")]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
