"""Build the CUDA kernels at first use and bind them with ctypes.

Counterpart of the JAX package's ``utils/jit_cache.py`` (its persisted
compile cache): each ``csrc/<name>.cu`` is compiled by nvcc for
``sm_90a`` into a shared library with a plain C interface, under
``drand_tpu_torch/_build/<source hash>/`` (a directory git ignores), so a
fresh checkout builds everything the first time a kernel is launched and
reuses the library while the sources are unchanged.

Every launching C entry point returns ``cudaGetLastError()``; the
wrappers in ``ops/pairing.py``, ``ops/msm.py`` and ``ops/eval.py`` raise
when it is not zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry points of each library and their arguments: "p" a pointer or
# the stream (void*), "i" an int (see the .cu sources)
_ENTRY_POINTS = {
    "pairing": {
        "miller_loop_launch": ["p", "i", "p", "p", "p", "p", "i", "p"],
        "final_exp_verdict_launch": ["p", "i", "p", "p", "p", "i", "p"],
    },
    "msm": {
        "msm_scratch_words": ["i"],
        "msm_launch": ["p", "i", "p", "p", "p", "i", "p", "i", "p", "i", "p"],
    },
    "eval": {
        "eval_horner_launch": ["p", "i", "p", "i", "p", "i", "i", "p", "p",
                               "i", "p"],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def parse_ptxas(log: str) -> dict:
    """Per entry function: registers, stack frame, spill stores/loads
    (bytes) from ``nvcc -Xptxas -v`` output."""
    out: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            out.setdefault(current, {})
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            current = m.group(1) if m.group(1) in out else None
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[current].update(stack_bytes=int(m.group(1)),
                                spill_store_bytes=int(m.group(2)),
                                spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


def _paths(name: str) -> tuple[Path, Path]:
    out_dir = BUILD_DIR / _source_hash(name)
    return out_dir / f"lib{name}.so", out_dir / f"{name}.ptxas.log"


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library is built;
    returns (process, temp path, its output file, start time) or None."""
    lib, _ = _paths(name)
    if lib.exists():
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f".lib{name}.{os.getpid()}.so"
    err = open(lib.parent / f".{name}.{os.getpid()}.err", "w+")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=err, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, err, time.perf_counter()


def _finish(name: str, started) -> dict:
    """Wait for a build started by ``_start``; returns its info."""
    lib, log = _paths(name)
    if started is not None:
        proc, tmp, err_file, t0 = started
        proc.wait()
        seconds = time.perf_counter() - t0
        with err_file:
            err_file.seek(0)
            err = err_file.read()
        os.unlink(err_file.name)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{err}")
        log.write_text(f"# build_seconds {seconds:.3f}\n{err}")
        os.replace(tmp, lib)
    text = log.read_text()
    m = re.match(r"# build_seconds ([0-9.]+)", text)
    return {"library": str(lib),
            "build_seconds": float(m.group(1)) if m else None,
            "kernels": parse_ptxas(text)}


def _load(name: str, info: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(info["library"])
    for fn, args in _ENTRY_POINTS[name].items():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p if a == "p" else ctypes.c_int
                      for a in args]
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    _INFO[name] = info
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    return _load(name, _finish(name, _start(name)))


def build_all() -> dict:
    """Build every library, one nvcc per source, all started together;
    returns {name: info} with the build time and ptxas's registers and
    spills per kernel."""
    todo = [n for n in _ENTRY_POINTS if n not in _LIBS]
    started = {n: _start(n) for n in todo}
    for n in todo:
        _load(n, _finish(n, started[n]))
    return dict(_INFO)
