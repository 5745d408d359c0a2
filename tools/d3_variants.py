"""Time D3's alternative designs (tools/d3_variants.cu) and D4's thread
regime against the kernels that ship, and against a parent checkout's, on
one H100.

    python3 tools/d3_variants.py [--parent DIR] [--tag TEXT] [--out FILE]

D3 runs at chip_smoke.DD_GATHER_TABLE_SHAPES and RANK1_SHAPES (the defect's
C_6 level-2 train and the stdnorm rank-1 train at their batch sizes): the shipped
dd_gather_tt_fused in its rule's plan, the parent's, and each variant of
tools/d3_variants.cu in a few plans; D4 at chip_smoke.DD_DOT_TABLE_SHAPES:
the shipped dd_dot in its rule's regime, the thread regime in blocks of 256,
128 and 64, the first D4 kernel (a thread per output) built here from
tools/d3_variants.cu, and the parent's.  Every launch is held bit for bit (hi and lo)
to the shipped kernel's result; a plan whose shared memory does not fit is
reported as refused.  Each reading is device µs per call
(chip_smoke.device_us_idle), taken twice in turns: the candidates in order,
then in reverse.  Lines are JSON, printed and written to FILE
(default chiprun_out/d3_variants.jsonl); the first names the card and its
power limit, and TEXT (a commit or tree hash) where given.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCE = ROOT / "tools" / "d3_variants.cu"
VARIANTS = {"col": 0, "lanes": 1, "turns": 2, "pipe": 3, "shipped": 4}
# the stdnorm defect's rank-1 train at its other batch sizes
RANK1_SHAPES = [(B, 65, 1, 1, 1, 1, 1) for B in (142, 260, 520)]
_OUT = []


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    _OUT.append(line)


def build() -> ctypes.CDLL:
    """nvcc the variants (with dd_kernels.cu, which the source includes) into
    build/d3_variants/<hash>/ and load them."""
    from ttcross_tpu_torch.ops import _build

    deps = (SOURCE, ROOT / "ttcross_tpu_torch" / "csrc" / "dd_kernels.cu")
    key = hashlib.sha256(b"".join(p.read_bytes() for p in deps) + " ".join(_build.NVCC_FLAGS)
                         .encode()).hexdigest()[:16]
    lib = ROOT / "build" / "d3_variants" / key / "libd3_variants.so"
    if not lib.is_file():
        lib.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                               str(SOURCE)], capture_output=True, text=True)
        emit({"phase": "build", "rc": proc.returncode,
              "ptxas": [ln for ln in (proc.stdout + proc.stderr).splitlines()
                        if "registers" in ln or "spill" in ln or "error" in ln]})
        if proc.returncode != 0:
            raise RuntimeError(proc.stdout + proc.stderr)
    so = ctypes.CDLL(str(lib))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so.d3v_gather_tt.argtypes = [I, I, I, P, P, I, I, I, P, LL, I, I, I, P, P, P]
    so.d3v_gather_tt.restype = I
    so.d4v_dot_first.argtypes = [P, P, P, P, LL, LL, I] + [LL] * 6 + [P, P, P]
    so.d4v_dot_first.restype = I
    return so


def first_dot_fn(so, x, y):
    """A call of the first D4 kernel as built here (tools/d3_variants.cu)."""
    import torch

    M, N, T = x[0].shape
    out = torch.empty((2, M, N), dtype=torch.float64, device=x[0].device)

    def call():
        rc = so.d4v_dot_first(x[0].data_ptr(), x[1].data_ptr(), y[0].data_ptr(), y[1].data_ptr(),
                            M, N, T, *x[0].stride(), *y[0].stride(), out[0].data_ptr(),
                            out[1].data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rc {rc}")
        return [out[0], out[1]]

    return call


def variant_fn(so, packed, ind, name, ahead, staged, P, threads, C):
    """A call of one variant, or None where it refuses the plan."""
    import torch

    d, R, N, _ = packed.cores.shape
    B = ind.shape[0]
    out = torch.empty((2, B), dtype=torch.float64, device=ind.device)

    def call():
        rc = so.d3v_gather_tt(VARIANTS[name], ahead, staged, packed.cores.data_ptr(),
                              packed.ranks_t.data_ptr(), d, R, N, ind.data_ptr(), B, P, threads, C,
                              out[0].data_ptr(), out[1].data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rc {rc}")
        return [out[0], out[1]]

    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError:
        return None
    return call


def d3_candidates(shape) -> list:
    """(label, variant, ahead, staged, P, threads, C) at one shape."""
    import torch

    from ttcross_tpu_torch.ops import kernels as K

    B, R = shape[0], max(shape[2:])
    W = 32 if R <= 32 else 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    spread = max(1, min(256 // W, -(-B // sms)))
    out = []
    plan = tuple(K.dd_gather_plan(B, len(shape) - 3, R, shape[1])[:2])
    for G in (1, 2, 4, 8):
        out.append((f"shipped/G{G}", "shipped", G, 0, *plan, 0))
    for P in sorted({256 // W, spread}):
        for ahead in (0, 4, 8):
            out.append((f"col/P{P}/ahead{ahead}", "col", ahead, 0, P, P * W, 0))
    for P in (2, 4, 8):
        out.append((f"lanes/P{P}", "lanes", 0, 1, P, 32 * P, 0))
        out.append((f"turns/P{P}", "turns", 0, 1, P, max(256, 32 * P), 0))
    for staged in (1, 0):
        for P, threads, C in ((2, 128, 8), (4, 256, 8), (8, 512, 8), (4, 256, 4), (8, 512, 4)):
            out.append((f"pipe/{'stage' if staged else 'global'}/P{P}/t{threads}/C{C}", "pipe",
                        0, staged, P, threads, C))
    return out


def in_turns(fns: dict) -> dict:
    """Two device_us_idle readings of each fn: in order, then in reverse."""
    reads = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            reads[k].append(cs.device_us_idle(fns[k]))
    return reads


def main(argv) -> int:
    import importlib

    import torch

    from ttcross_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    parent = argv[argv.index("--parent") + 1] if "--parent" in argv else None
    out_path = Path(argv[argv.index("--out") + 1] if "--out" in argv
                    else ROOT / "chiprun_out" / "d3_variants.jsonl")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "tag": argv[argv.index("--tag") + 1] if "--tag" in argv else None, "parent": parent})
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    other = importlib.import_module(cs._package_of(parent) + ".ops.kernels") if parent else None
    so = build()
    try:
        for shape in cs.DD_GATHER_TABLE_SHAPES + RANK1_SHAPES:
            _, fn, _, (packed, ind) = cs._dd_cases(dev, gen, "dd_gather_tt_fused", shape)[0]
            want = [t.clone() for t in fn()]
            fns = {"rule": lambda f=fn: list(f())}
            if other is not None:
                fns["parent"] = functools.partial(other.dd_gather_tt_fused, packed, ind)
            refused = []
            for label, name, ahead, staged, P, threads, C in d3_candidates(shape):
                call = variant_fn(so, packed, ind, name, ahead, staged, P, threads, C)
                if call is None:
                    refused.append(label)
                    continue
                fns[label] = call
            for label, f in fns.items():
                if not cs._bit_equal(list(f()), want):
                    raise AssertionError(f"D3 {shape} {label}: not bit-equal to the shipped kernel")
            emit({"phase": "d3_variants", "shape": list(shape),
                  "rule": list(K.dd_gather_plan(shape[0], len(shape) - 3, max(shape[2:]),
                                                shape[1])),
                  "refused": refused, "device_us": in_turns(fns)})
        for shape in cs.DD_DOT_TABLE_SHAPES:
            for label, fn, _, args in cs._dd_cases(dev, gen, "dd_dot", shape):
                want = list(fn())
                fns = {"rule": lambda f=fn: list(f())}
                if other is not None:
                    fns["parent"] = functools.partial(other.dd_dot, *args)
                for b in (256, 128, 64):
                    fns[f"thread/{b}"] = functools.partial(K.dd_dot_planned, *args,
                                                           ("thread", b, 0))
                fns["first_d4/256"] = first_dot_fn(so, *args)
                for k, f in fns.items():
                    if not cs._bit_equal(list(f()), want):
                        raise AssertionError(f"D4 {shape} {label} {k}: not bit-equal to the rule")
                emit({"phase": "d4_thread", "shape": list(shape), "layout": label,
                      "rule": list(K.dd_dot_plan(*shape)), "device_us": in_turns(fns)})
    finally:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text("\n".join(_OUT) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
