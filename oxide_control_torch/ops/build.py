"""Build the rollout kernel with nvcc into a plain-C shared library.

The hopper-kernels route (b): ``ops/csrc/rollout.cu`` (hand-written shell)
plus the model's emitted header is compiled by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/rollout-<hash>/librollout.so`` at the repository root, keyed
by the hash of every source byte and flag, and loaded with ``ctypes``.
Nothing is built when a module is imported: the first CUDA call builds.
``-Xptxas -v`` is always on, so every build reports its registers, stack
and spills.  ``--use_fast_math`` is never passed (IEEE division and square
root), and by default ``-fmad=false`` turns off nvcc's contraction of
``a * b + c`` into one FMA: each statement then rounds as the plain
PyTorch version's op does, and the kernel agrees with it bit for bit
through a chaotic contact rollout.  With contraction on, differences of
one rounding per step grow past the parity bars within 24 steps of the
policy rollout; ``fmad=True`` builds that faster variant, which
``chip_smoke.py`` times to price the choice (see PERF.md).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_LOCK = threading.Lock()
_SOURCE_LOCKS: dict[str, threading.Lock] = {}


@dataclasses.dataclass
class Built:
    """A loaded kernel library and what its build reported."""

    so_path: str
    launch: object        # ctypes function oxc_rollout_launch
    error_string: object  # int -> str
    seconds: float        # nvcc wall time (0.0 when loaded from build/)
    cached: bool
    emitted_lines: int
    registers: int | None
    stack_bytes: int | None
    spill_stores: int | None
    spill_loads: int | None
    ptxas_log: str
    step_ops: int         # per lane: a team's lanes each issue them
    step_sfu_ops: int
    reset_ops: int
    env_ops: int
    team: int             # lanes per env
    work_step_ops: int    # the G = 1 step's: the work the bound counts
    work_step_sfu_ops: int
    occupancy: object     # (policy, n_params) -> blocks of one warp
                          # that one SM holds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the rollout kernel is built from "
                       "source with the CUDA toolkit")


def _parse_ptxas(log: str, kernel: str = "oxc_rollout_kernel"):
    """(registers, stack bytes, spill stores, spill loads) of ``kernel``
    from ``-Xptxas -v`` output."""
    regs = stack = st = ld = None
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for nxt in lines[i + 1:i + 4]:
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", nxt)
                if m:
                    stack, st, ld = (int(x) for x in m.groups())
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    regs = int(m.group(1))
            break
    return regs, stack, st, ld


def _compile(src, flags, out: Path, so: Path, log_path: Path):
    """nvcc into ``out`` unless a finished build is there; returns
    (nvcc seconds, whether the build was already there)."""
    if so.exists() and log_path.exists():
        return 0.0, True
    out.mkdir(parents=True, exist_ok=True)
    # written whole under another name and renamed, so that processes
    # building one source never read another's half-written header
    header = out / f"oxc_model.{os.getpid()}.h"
    header.write_text(src.text)
    os.replace(header, out / "oxc_model.h")
    tmp = out / f"librollout.{os.getpid()}.so"
    cmd = [_nvcc(), *flags, "-I", str(out), "-I", str(CSRC),
           "-o", str(tmp), str(CSRC / "rollout.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    log_path.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return seconds, False


def build_rollout_library(src, fmad: bool = False) -> Built:
    """Compile (or load from ``build/``) the rollout kernel for one
    model's emitted source ``src`` (``megakernel.KernelSource``);
    ``fmad`` lets nvcc contract multiply-adds into FMAs."""
    flags = NVCC_FLAGS + (f"-fmad={'true' if fmad else 'false'}",)
    shell = (CSRC / "rollout.cu").read_text()
    helpers = (CSRC / "rollout.cuh").read_text()
    digest = hashlib.sha256("\0".join(
        (shell, helpers, src.text) + flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"rollout-{digest}"
    so = out / "librollout.so"
    log_path = out / "ptxas.txt"
    with _LOCK:
        lock = _SOURCE_LOCKS.setdefault(digest, threading.Lock())
    with lock:  # threads building one source share one nvcc run
        seconds, cached = _compile(src, flags, out, so, log_path)
    log = log_path.read_text()
    lib = ctypes.CDLL(str(so))
    fn = lib.oxc_rollout_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([vp] * 8 + [vp, ci] + [vp] * 4
                   + [ci, ctypes.POINTER(ci), cf]
                   + [vp] * 8 + [vp] * 4 + [ci, ci, vp])
    fn.restype = ci
    es = lib.oxc_error_string
    es.argtypes = [ci]
    es.restype = ctypes.c_char_p
    occ = lib.oxc_rollout_occupancy
    occ.argtypes = [ci, ci, ctypes.POINTER(ci)]
    occ.restype = ci

    def occupancy(policy: bool, n_params: int) -> int:
        blocks = ci(0)
        err = occ(int(policy), n_params, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"occupancy query failed: CUDA error {err} "
                               f"({es(err).decode()})")
        return blocks.value

    regs, stack, st, ld = _parse_ptxas(log)
    return Built(
        so_path=str(so), launch=fn,
        error_string=lambda e: es(e).decode(),
        seconds=seconds, cached=cached,
        emitted_lines=src.text.count("\n"),
        registers=regs, stack_bytes=stack, spill_stores=st, spill_loads=ld,
        ptxas_log=log, step_ops=src.step_ops, step_sfu_ops=src.step_sfu_ops,
        reset_ops=src.reset_ops, env_ops=src.env_ops, team=src.team,
        work_step_ops=src.work_step_ops,
        work_step_sfu_ops=src.work_step_sfu_ops, occupancy=occupancy,
    )
