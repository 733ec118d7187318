"""The port stands alone: no file of drand_tpu_torch/ and not chip_smoke.py
imports jax or the JAX package, importing the port adds neither to
sys.modules, and its engine refuses to run without CUDA instead of
moving to the CPU on its own."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "drand_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


# the modules of the threshold round (slice 2), and chip_smoke.py's
# functions that drive it
SLICE_TWO_MODULES = ["drand_tpu_torch.crypto.endo", "drand_tpu_torch.ops.curve",
                     "drand_tpu_torch.ops.msm", "drand_tpu_torch.ops.eval"]
SLICE_TWO_PHASES = ["_point_products", "_msm_case", "_dealers", "_horner_case",
                    "_curve_kernels", "_partials", "_threshold_rounds",
                    "phase_live_round", "phase_threshold_round",
                    "phase_deal_check"]
# the modules of the wire path (slice 3), and chip_smoke.py's functions
# that drive it
SLICE_THREE_MODULES = ["drand_tpu_torch.ops.h2c", "drand_tpu_torch.ops.wire",
                       "drand_tpu_torch.crypto.batch_verify"]
SLICE_THREE_PHASES = ["_chain", "_corrupt", "_f2_of", "_products", "_k5_case",
                      "_k6_case", "_wire_kernels", "_group_key",
                      "phase_catchup", "phase_catchup_wire", "_launches"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "drand_tpu" or name.startswith("drand_tpu."))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


_PROBE = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import drand_tpu_torch
names = [m.name for m in pkgutil.walk_packages(drand_tpu_torch.__path__,
                                                 "drand_tpu_torch.")]
for n in names:
    importlib.import_module(n)
added = sorted(set(sys.modules) - before)
print(json.dumps({"imported": names, "added": added}))
"""


def test_import_adds_no_jax_or_reference_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "drand_tpu_torch.ops.engine" in got["imported"]
    assert set(SLICE_TWO_MODULES) <= set(got["imported"])
    assert set(SLICE_THREE_MODULES) <= set(got["imported"])
    leaked = [m for m in got["added"] if _forbidden(m)]
    assert not leaked, leaked


def test_engine_refuses_without_cuda(monkeypatch):
    from drand_tpu_torch.ops.engine import BatchedEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedEngine(device="cuda")


@pytest.mark.parametrize("name", SLICE_TWO_PHASES + SLICE_THREE_PHASES)
def test_chip_smoke_phase_imports_only_the_port(name):
    """Each function of chip_smoke.py that drives the threshold round or
    the wire path imports only the port, torch and numpy (and the
    standard library at the top of the file)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == name)
    mods = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module)
    assert all(m.split(".")[0] in {"drand_tpu_torch", "torch", "numpy"}
               for m in mods), mods


@pytest.mark.parametrize("wrapper", ["msm", "horner", "hash_to_g2",
                                     "decompress_g2"])
def test_kernel_wrappers_refuse_other_devices(wrapper):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is refused, never computed by the plain version."""
    from drand_tpu_torch.ops import eval as ev, msm, wire

    meta = {"device": "meta", "dtype": torch.int32}
    with pytest.raises(ValueError, match="unsupported device"):
        if wrapper == "msm":
            msm.msm(torch.empty((4, 2, 2, 12), **meta),
                    torch.empty((4,), **meta), torch.empty((4, 64), **meta))
        elif wrapper == "horner":
            ev.horner(torch.empty((3, 4, 2, 12), **meta),
                      torch.empty((4, 11), **meta))
        elif wrapper == "hash_to_g2":
            wire.hash_to_g2(torch.empty((4, 2, 2, 12), **meta))
        else:
            wire.decompress_g2(torch.empty((4, 2, 12), **meta),
                               torch.empty((4,), **meta))


@pytest.mark.parametrize("wrapper", ["hash_to_g2", "decompress_g2"])
def test_wire_wrappers_check_their_inputs(wrapper):
    """The wire wrappers refuse a wrong dtype, shape or layout before any
    launch."""
    from drand_tpu_torch.ops import wire

    if wrapper == "hash_to_g2":
        good = torch.zeros((4, 2, 2, 12), dtype=torch.int32)
        call = wire.hash_to_g2
        with pytest.raises(TypeError, match="dtype"):
            call(good.to(torch.int64))
        with pytest.raises(ValueError, match="shape"):
            call(good[:, :, :, :6])
        with pytest.raises(ValueError, match="contiguous"):
            call(good.transpose(1, 2))
    else:
        good = torch.zeros((4, 2, 12), dtype=torch.int32)
        sign = torch.zeros(4, dtype=torch.int32)
        call = wire.decompress_g2
        with pytest.raises(TypeError, match="dtype"):
            call(good, sign.to(torch.bool))
        with pytest.raises(ValueError, match="shape"):
            call(good, sign[:3])
        with pytest.raises(ValueError, match="contiguous"):
            call(good.transpose(0, 1).contiguous().transpose(0, 1), sign)
