"""Seconds that `python3 -u chip_smoke.py` spends in its phases, for one or
more checkouts in turns (e.g. the parent commit's, unpacked with `git
archive`, and this one), read from the host clock at each line it prints.

    python3 tools/phase_times.py [--until PHASE|end] [--out FILE] [--log DIR] DIR [DIR ...]

Each run is stopped (its whole process group) at the first line whose
"phase" is PHASE (default: headline, the first line after phase 3), so
only the phases before it run; with `--until end` it runs to its end and
its exit code and last line are kept.  One JSON line per run: the seconds
from the start to the first line of each phase, and `phase3_s`, from the
build line to the last line before the headline's (phase 3's last row).
`--log DIR` keeps each run's output and errors as DIR/<n>.out and
DIR/<n>.err.  Needs the card, as chip_smoke.py does."""

import json
import os
import signal
import subprocess
import sys
import time


def time_phases(root: str, until: str, log: str | None, n: int) -> dict:
    out = open(os.path.join(log, f"{n}.out"), "w") if log else None
    err = open(os.path.join(log, f"{n}.err"), "w") if log else subprocess.DEVNULL
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=root, text=True,
                            stdout=subprocess.PIPE, stderr=err, start_new_session=True)
    first, last, before_headline, last_line = {}, 0.0, None, ""
    try:
        for line in proc.stdout:
            if out:
                out.write(line)
            last_line = line.strip() or last_line
            if not line.startswith("{"):
                continue
            try:
                phase = json.loads(line).get("phase")
            except json.JSONDecodeError:
                continue
            now = time.perf_counter() - t0
            if phase == "headline" and before_headline is None:
                before_headline = last
            if phase is not None and phase not in first:
                first[phase] = now
            if phase == until:
                break
            last = now
    finally:
        if proc.poll() is None and until != "end":
            os.killpg(proc.pid, signal.SIGTERM)
        proc.wait()
        if out:
            out.close()
            err.close()
    row = {"dir": root, "until": until, "first_line_s": first}
    if until == "end":
        row.update(rc=proc.returncode, seconds=time.perf_counter() - t0, last_line=last_line)
    elif until not in first:
        raise SystemExit(f"{root}: chip_smoke.py ended (rc {proc.returncode}) before {until!r}")
    if before_headline is not None and "build" in first:
        row["phase3_s"] = before_headline - first["build"]
    return row


def main() -> int:
    args = sys.argv[1:]
    opts = {"--until": "headline", "--out": None, "--log": None}
    for name in opts:
        if name in args:
            i = args.index(name)
            opts[name] = args.pop(i + 1)
            args.pop(i)
    if opts["--log"]:
        os.makedirs(opts["--log"], exist_ok=True)
    for n, root in enumerate(args):
        row = json.dumps(time_phases(root, opts["--until"], opts["--log"], n))
        print(row, flush=True)
        if opts["--out"]:
            with open(opts["--out"], "a") as f:
                f.write(row + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
