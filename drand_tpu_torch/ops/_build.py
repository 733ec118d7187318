"""Build the CUDA kernels at first use and bind them with ctypes.

Counterpart of the JAX package's ``utils/jit_cache.py`` (its persisted
compile cache): each ``csrc/<name>.cu`` is compiled by nvcc for
``sm_90a`` into a shared library with a plain C interface, under
``drand_tpu_torch/_build/<source hash>/`` (a directory git ignores), so a
fresh checkout builds everything the first time a kernel is launched and
reuses the library while the sources are unchanged.

Every launching C entry point returns ``cudaGetLastError()``; the
wrappers in ``ops/pairing.py``, ``ops/msm.py``, ``ops/eval.py``,
``ops/wire.py`` and the probes of ``tools/`` raise when it is not zero.
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
        "miller_step_launch": ["p", "i", "p", "p", "p", "p", "p", "p", "i",
                               "i", "i", "i", "p"],
    },
    "msm": {
        "msm_scratch_words": ["i", "i"],
        "msm_launch": ["p", "i", "p", "p", "p", "i", "p", "i", "p", "i", "i",
                       "p"],
    },
    "eval": {
        "eval_horner_launch": ["p", "i", "p", "i", "p", "i", "i", "p", "p",
                               "i", "p"],
    },
    "h2c": {
        "hash_to_g2_group": [],
        "decompress_g2_group": [],
        "hash_to_g2_launch": ["p", "i", "p", "i", "p", "p", "p", "i", "p"],
        "decompress_g2_launch": ["p", "i", "p", "i", "p", "p", "p", "p", "i",
                                 "p"],
    },
    "microbench": {
        "vpu_chain_launch": ["i", "p", "p", "p", "p", "i", "i", "p"],
        "mma_chain_launch": ["i", "p", "p", "p", "i", "i", "p"],
    },
    "mxu_redc": {
        "mont_chain_launch": ["p", "i", "i", "p", "p", "p", "p", "p", "i", "i",
                              "p"],
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


def parse_ptxas_functions(log: str) -> dict:
    """Per device function that is not an entry (an out-of-line callee):
    its stack frame and spill stores/loads (bytes) from ``nvcc -Xptxas
    -v`` output. A kernel's own line leaves these out."""
    out: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = None
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current is not None:
            out[current] = {"stack_bytes": int(m.group(1)),
                            "spill_store_bytes": int(m.group(2)),
                            "spill_load_bytes": int(m.group(3))}
            current = None
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
    kernels = parse_ptxas(text)
    return {"library": str(lib),
            "build_seconds": float(m.group(1)) if m else None,
            "kernels": kernels,
            "functions": {f: v for f, v in parse_ptxas_functions(text).items()
                          if f not in kernels}}


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


def info(name: str) -> dict | None:
    """Build time and ptxas's registers and spills of a loaded library,
    or None before it is built."""
    return _INFO.get(name)


def _cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    return str(cand) if cand.exists() else None


def sass_count(counts: dict, kernel: str, prefix: str, part: str = "") -> int:
    """Instructions of ``kernel`` (a substring of the mangled name) whose
    opcode starts with ``prefix`` and contains ``part``."""
    return sum(n for fn, ops in counts.items() if kernel in fn
               for op, n in ops.items()
               if op.startswith(prefix) and part in op)


def sass_counts(name: str) -> dict | None:
    """{kernel function (mangled): {opcode with its modifiers: count}} of
    the built library's SASS (``cuobjdump -sass``), or None where the
    toolkit has no cuobjdump."""
    tool = _cuobjdump()
    if tool is None:
        return None
    library(name)
    text = subprocess.run([tool, "-sass", _INFO[name]["library"]],
                          capture_output=True,
                          text=True, check=True).stdout
    out: dict[str, dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and current is not None:
            current[m.group(1)] = current.get(m.group(1), 0) + 1
    return out


def build_all() -> dict:
    """Build every library, one nvcc per source, all started together;
    returns {name: info} with the build time and ptxas's registers and
    spills per kernel. If a build fails, the others are waited for (nvcc
    runs children of its own) before the error is raised."""
    todo = [n for n in _ENTRY_POINTS if n not in _LIBS]
    started = {}
    try:
        for n in todo:
            started[n] = _start(n)
        for n in todo:
            _load(n, _finish(n, started[n]))
            del started[n]
    finally:
        for s in started.values():
            if s is not None:
                s[0].wait()
                s[2].close()
    return dict(_INFO)
