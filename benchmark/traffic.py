"""The benchmark's one traffic generator: a closed loop of calls.

A traffic mix is the data file benchmark/traffic/<name>.json.  Its "loop"
is "closed": one caller sends a call, waits for its answer, and sends the
next.  Call i of a run draws its lottery key from (seed, i), and the
warm-up call its own from (seed); every other key of the file ("entry",
"sweep_mode", "lanes", ...) is for the configuration's drive module, and
"check" says how much of the answers the correctness check samples.  The seed changes the
keys and the sample only, never the sizes: every run of a cell does the
same work.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["load", "call_key", "warmup_key", "sample_rng"]

_LOOPS = ("closed",)


def load(path: Path) -> dict:
    traffic = json.loads(Path(path).read_text())
    if traffic.get("loop") not in _LOOPS:
        raise ValueError(f"{path}: loop must be one of {_LOOPS}, got {traffic.get('loop')!r}")
    return traffic


def _key(*words: int) -> int:
    """63 bits of numpy's SeedSequence over the words."""
    state = np.random.SeedSequence([int(w) % 2 ** 64 for w in words]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def call_key(seed: int, index: int) -> int:
    """The lottery key of call ``index`` of a run."""
    return _key(seed, 1, index)


def warmup_key(seed: int) -> int:
    """The key of the warm-up call, which no measured call repeats."""
    return _key(seed, 0)


def sample_rng(seed: int) -> np.random.Generator:
    """The stream that draws which answers the check reads."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2 ** 64, 2]))
