"""The port's probes (drand_tpu_torch/tools), which hold the CUDA kernels
of csrc/microbench.cu, csrc/mxu_redc.cu and pairing.cu's Miller step:
here their plain versions, held against the JAX package's tools — the
kernel bodies of tools/microbench.py run through Pallas in interpret
mode, tools/proto_mxu.mont_mul_mxu and ops/bl.mont_mul as plain jnp —
and against the host field code. Small cases only: the plain versions
build nothing and these tests stay within a few seconds on one worker."""

import ast
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.microbench as jmb
import tools.proto_mxu as jpm
from drand_tpu.crypto.fields import P as JP
from drand_tpu.ops import bl
from drand_tpu_torch.crypto.fields import P
from drand_tpu_torch.ops import field as fd
from drand_tpu_torch.ops import pairing as pp
from drand_tpu_torch.ops.limb import (fp_from_words, fp_words,
                                      halves_to_words, words_to_halves)
from drand_tpu_torch.tools import _common
from drand_tpu_torch.tools import microbench as mb
from drand_tpu_torch.tools import proto_miller_grid as mg
from drand_tpu_torch.tools import proto_mxu as pm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ITERS = 8                 # steps of the chains held against JAX
TILE = (16, 128)          # the VPU tile held against JAX
SEED = 5
LANES = 8                 # REDC lanes held against JAX (p - 1 and 0 among them)

# ---------------------------------------------------------------------------
# microbench: the plain chains against the JAX tool's kernel bodies
# ---------------------------------------------------------------------------

_JAX_DTYPES = {"int32": jnp.int32, "f32": jnp.float32, "bf16": jnp.bfloat16}
# Tolerances against JAX, 8 steps. int32 and int8 -> int32 are exact,
# wrapping included. The elementwise float chains: the port's own bounds
# (one fma against two roundings, a contracting chain). The matrix
# chains: float64 against float32 sums of the same bf16 inputs part by at
# most one bf16 unit in the last place a step, 8 · 2^-8 = 2^-5 of the
# largest magnitude; f32 through TF32 against JAX's full f32 rounds acc
# and a to 10 mantissa bits, 8 · 2^-11 < 2^-6 of it.
_JAX_REL_TOL = {"bf16_f32": 2.0 ** -5, "tf32_f32": 2.0 ** -6}


@pytest.fixture
def short_jax_chains(monkeypatch):
    """The JAX tool's kernel bodies read N_ITERS when they are traced."""
    monkeypatch.setattr(jmb, "N_ITERS", ITERS)


@pytest.mark.parametrize("name", ["int32", "f32", "bf16"])
def test_vpu_chain_matches_jax_kernel(short_jax_chains, name):
    x, y = mb.chain_inputs(name, TILE, seed=SEED)
    dt = _JAX_DTYPES[name]
    host = [t.numpy() if name == "int32" else t.float().numpy()
            for t in (x, y)]
    want = pl.pallas_call(jmb.vpu_kernel,
                          out_shape=jax.ShapeDtypeStruct(TILE, dt),
                          interpret=True)(*(jnp.asarray(h, dt) for h in host))
    got = mb.chain(x, y, ITERS)          # CPU tensors: the plain version
    assert got.dtype == x.dtype and tuple(got.shape) == TILE
    want = np.asarray(want.astype(jnp.float32) if name != "int32" else want)
    err = np.abs(got.double().numpy() - want.astype(np.float64)).max()
    if name == "int32":
        assert err == 0
        assert np.abs(want).max() > 2 ** 30        # the chain wrapped
    else:
        assert err <= mb.ABS_TOL[name]


@pytest.mark.parametrize("name", ["bf16_f32", "int8_i32", "tf32_f32"])
def test_mma_chain_matches_jax_kernel(short_jax_chains, name):
    in_dt, out_dt, _ = mb.MMAS[name]
    a, b = mb.mma_inputs(name, mb.MMA_DIM, seed=SEED)
    jin = {"bf16_f32": jnp.bfloat16, "int8_i32": jnp.int8,
           "tf32_f32": jnp.float32}[name]
    jout = jnp.int32 if name == "int8_i32" else jnp.float32
    host = [t.numpy() if name == "int8_i32" else t.float().numpy()
            for t in (a, b)]
    want = np.asarray(pl.pallas_call(
        jmb.mxu_kernel,
        out_shape=jax.ShapeDtypeStruct((mb.MMA_DIM, mb.MMA_DIM), jout),
        interpret=True)(*(jnp.asarray(h, jin) for h in host)))
    got = mb.mma_chain(a, b, ITERS)
    assert got.dtype == out_dt
    err = np.abs(got.double().numpy() - want.astype(np.float64)).max()
    if name == "int8_i32":
        assert err == 0
        assert np.abs(want).max() > 127            # the int8 casts wrapped
    else:
        assert err <= _JAX_REL_TOL[name] * np.abs(want).max()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_wide_chain_is_multiply_with_carry(seed):
    """(c, x) <- x·y + c on 32-bit words, against Python integers."""
    x, y = mb.chain_inputs("wide", (3, 5), seed=seed)
    gx, gc = mb.wide_chain(x, y, 6)
    for xi, yi, ox, oc in zip(*(t.reshape(-1).tolist()
                                for t in (x, y, gx, gc))):
        a, b, c = xi & 0xFFFFFFFF, yi & 0xFFFFFFFF, 0
        for _ in range(6):
            a, c = (a * b + c) & 0xFFFFFFFF, (a * b + c) >> 32
        assert (ox & 0xFFFFFFFF, oc & 0xFFFFFFFF) == (a, c)


def test_int32_chain_wraps_like_python():
    x, y = mb.chain_inputs("int32", (4, 4), seed=9)
    got = mb.chain(x, y, 5)
    for xi, yi, g in zip(*(t.reshape(-1).tolist() for t in (x, y, got))):
        for _ in range(5):
            xi = (xi * yi + yi) & 0xFFFFFFFF
        assert g & 0xFFFFFFFF == xi


@pytest.mark.parametrize("value,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),            # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                          # below half: down
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),          # a tie, odd: up
    (1.5, 1.5)])
def test_tf32_rounding(value, want):
    got = mb.tf32_round(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want


@pytest.mark.parametrize("name", ["bf16_f32", "int8_i32", "tf32_f32"])
def test_permutation_chain_is_exact(name):
    """With a scaled signed permutation every sum has one term: the chain
    is the same with float32 sums in another order, and the rounding of
    acc to the input type at every step shapes it."""
    a, b = mb.mma_inputs(name, mb.MMA_DIM, seed=SEED, permutation=True)
    assert a.float().abs().max().item() == mb.PERM_SCALE[name]
    got = mb.mma_chain(a, b, 3)
    cast = {"bf16_f32": lambda v: v.to(torch.bfloat16).float(),
            "int8_i32": lambda v: v.int().to(torch.int8).float(),  # wraps
            "tf32_f32": mb.tf32_round}[name]
    a32, want = cast(a.float()), b.float()
    for _ in range(3):
        want = cast(want) @ a32
    assert torch.equal(got.double(), want.double())
    if name != "int8_i32":
        unrounded = b.double() @ torch.linalg.matrix_power(a.double(), 3)
        assert not torch.equal(got.double(), unrounded)


def _block_sum_chain(a, b, iters, name, acc_dtype):
    """The float tensor-core chain as the card runs it: acc rounded to the
    input type, then sums of exact products in blocks of the mma's K,
    accumulated in ``acc_dtype``."""
    cast = (lambda v: v.to(torch.bfloat16).double()) if name == "bf16_f32" \
        else (lambda v: mb.tf32_round(v).double())
    k = 16 if name == "bf16_f32" else 8
    a64, acc = cast(a.float()), b.float()
    for _ in range(iters):
        x, c = cast(acc), torch.zeros(acc.shape, dtype=acc_dtype)
        for j in range(0, mb.MMA_DIM, k):
            c = (c.double() + x[:, j:j + k] @ a64[j:j + k]).to(acc_dtype)
        acc = c.float()
    return acc


@pytest.mark.parametrize("iters", mb.CHECK_ITERS)
@pytest.mark.parametrize("name", ["bf16_f32", "tf32_f32"])
def test_check_bounds_hold_f32_block_sums(name, iters):
    """f32 sums in the mma's blocks of K stay within the checks' bounds."""
    a, b = mb.mma_inputs(name, mb.MMA_DIM, seed=SEED)
    want = mb.mma_chain_plain(a, b, iters)
    got = _block_sum_chain(a, b, iters, name, torch.float32)
    assert mb.within(name, _common.max_abs_err(got, want), want, iters)


@pytest.mark.parametrize("acc_dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("name", ["bf16_f32", "tf32_f32"])
def test_one_step_bound_rejects_half_precision_sums(name, acc_dtype):
    """An accumulator narrower than f32 leaves the one-step bound."""
    a, b = mb.mma_inputs(name, mb.MMA_DIM, seed=SEED)
    want = mb.mma_chain_plain(a, b, 1)
    got = _block_sum_chain(a, b, 1, name, acc_dtype)
    assert not mb.within(name, _common.max_abs_err(got, want), want, 1)


def test_tolerances_accept_only_what_they_state():
    ref = torch.tensor([4.0])
    assert mb.within("int32", 0, ref) and not mb.within("int32", 1, ref)
    assert mb.within("bf16_f32", 0.0625, ref, 8)
    assert not mb.within("bf16_f32", 0.07, ref, 8)
    assert not mb.within("tf32_f32", 0.001, ref, 1)
    assert mb.within("f32", 1e-6, ref) and not mb.within("f32", 1e-4, ref)
    with pytest.raises(KeyError):     # the timed chain has no float bound
        mb.within("bf16_f32", 0.0, ref)


# ---------------------------------------------------------------------------
# proto_mxu: the tensor-core REDC split against the JAX tool and the host
# ---------------------------------------------------------------------------

def _redc_values():
    rnd = random.Random(SEED)
    va = [rnd.randrange(P) for _ in range(LANES)]
    vb = [rnd.randrange(P) for _ in range(LANES)]
    va[0], vb[0], va[1], vb[2] = P - 1, P - 1, 0, 0
    va[3], vb[3] = 1, P - 1
    return va, vb


@pytest.fixture(scope="module")
def jax_redc():
    """bl.mont_mul and proto_mxu.mont_mul_mxu on the same lanes, as plain
    jnp under bl.const_context; canonical products."""
    va, vb = _redc_values()
    a, b = (jnp.asarray(bl.pack_fp(v)) for v in (va, vb))
    out = {}
    with bl.const_context(jnp.asarray(bl.CONST_BUFFER)):
        jpm._G2, jpm._G3 = jnp.asarray(jpm.G_NPRIME), jnp.asarray(jpm.G_P)
        out["mxu"] = bl.unpack_fp(np.asarray(jax.jit(jpm.mont_mul_mxu)(a, b)))
        out["vpu"] = bl.unpack_fp(np.asarray(jax.jit(bl.mont_mul)(a, b)))
    return va, vb, out


@pytest.fixture(scope="module")
def port_redc():
    va, vb = _redc_values()
    a, b = (torch.from_numpy(np.stack([fp_words(v) for v in vals]))
            for vals in (va, vb))
    tc = pm.mont_mul_tc_plain(a, b)
    cuda = pm.mont_chain_plain(a, b, 1, tensor_cores=False)
    return ([fp_from_words(w) for w in tc.numpy()],
            [fp_from_words(w) for w in cuda.numpy()])


@pytest.mark.parametrize("lane", range(LANES))
@pytest.mark.parametrize("ref", ["mxu", "vpu"])
def test_tc_redc_product_matches_jax(jax_redc, port_redc, lane, ref):
    """The port's split (byte Toeplitz matrices) and the JAX tool's
    (12-bit limbs, 6/7-bit int8 pieces) give the same product mod p."""
    va, vb, jout = jax_redc
    assert JP == P
    assert port_redc[0][lane] == jout[ref][lane] % P


@pytest.mark.parametrize("lane", range(LANES))
def test_redc_products_are_the_ordinary_product(jax_redc, port_redc, lane):
    """Both packages' Montgomery products of Montgomery forms are a·b in
    the ordinary domain: the JAX tool's check (proto_mxu.py:155-160)
    expects a·b·R^-1 and reads right outputs as wrong."""
    va, vb, jout = jax_redc
    tc, cuda = port_redc
    want = va[lane] * vb[lane] % P
    assert tc[lane] == cuda[lane] == jout["mxu"][lane] == want


@pytest.mark.parametrize("tensor_cores", [False, True])
def test_redc_chain_equals_host_power(tensor_cores):
    """A short chain through the wrapper on CPU tensors (the plain
    versions) is a·b^iters mod p, with p − 1 and 0 among the lanes, in
    the tool's stacked shape."""
    va, vb, (a, b) = pm.chain_inputs(4)
    got = pm.mont_chain(a, b, 5, tensor_cores)
    assert tuple(got.shape) == (pm.STACK, 4, 12)
    assert [fp_from_words(w) for w in got.reshape(-1, 12).numpy()] == [
        x * pow(y, 5, P) % P for x, y in zip(va, vb)]
    assert va[0] == vb[0] == P - 1 and va[1] == 0


@pytest.mark.parametrize("const,rows", [("nprime", 48), ("p", 96)])
def test_toeplitz_bytes_hold_the_product(const, rows):
    """G @ bytes(x) holds the column sums of c·x, each below 2^22: the
    kernel's s32 sums are exact."""
    g = {"nprime": pm.G_NPRIME, "p": pm.G_P}[const]
    c = {"nprime": pm.NPRIME, "p": P}[const]
    assert g.shape == (rows, pm.K_BYTES)
    assert int(g.astype(np.int64).sum(axis=1).max()) * 255 < 1 << 22
    x = random.Random(rows).randrange(1 << 384)
    xb = np.frombuffer(x.to_bytes(pm.K_BYTES, "little"), np.uint8)
    cols = g.astype(np.int64) @ xb.astype(np.int64)
    got = sum(int(s) << (8 * k) for k, s in enumerate(cols))
    assert got % (1 << (8 * rows)) == (c * x) % (1 << (8 * rows))


def test_tc_redc_counts_one_product_per_lane():
    fd.N_FP_PRODUCTS = 0
    a = torch.from_numpy(np.stack([fp_words(v) for v in (3, 4, 5)]))
    pm.mont_mul_tc_plain(a, a)
    assert fd.N_FP_PRODUCTS == 3


# ---------------------------------------------------------------------------
# proto_miller_grid: the plain step, stepped from a saved state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def miller_inputs():
    return mg.tool_inputs(2, "cpu")


def test_miller_steps_from_saved_state_equal_k1(miller_inputs):
    """63 plain steps, the state saved to host arrays and restored between
    steps (as the kernel keeps it in device memory), equal
    ops/pairing.miller_loop_plain word for word on 2 lanes."""
    xp, yp, q = miller_inputs
    f, t = mg.miller_state_init(q)
    for i in range(pp.N_MILLER):
        saved = (f.numpy().copy(), t.numpy().copy())
        f, t = (torch.from_numpy(s) for s in saved)
        f, t = mg.miller_step_plain(f, t, xp, yp, q, bool(pp.MILLER_FLAGS[i]))
    got = halves_to_words(fd.f12_conj(words_to_halves(f)))
    assert torch.equal(got, pp.miller_loop_plain(xp, yp, q))


def test_miller_state_init_is_q_and_one(miller_inputs):
    _, _, q = miller_inputs
    f, t = mg.miller_state_init(q)
    assert tuple(t.shape) == (2, 2, 3, 2, 12)
    assert torch.equal(t[:, :, 0], q[:, :, 0])
    assert torch.equal(t[:, :, 1], q[:, :, 1])
    assert fp_from_words(t[0, 0, 2, 0].numpy()) == 1
    assert fp_from_words(t[0, 0, 2, 1].numpy()) == 0
    assert fp_from_words(f[0, 0, 0, 0].numpy()) == 1
    assert int(f.reshape(2, -1)[:, 12:].abs().sum()) == 0


def test_miller_tool_inputs_are_the_tools_messages(miller_inputs):
    """8 messages broadcast over the lanes: lanes i and i + 8 agree."""
    xp, yp, q = mg.tool_inputs(10, "cpu")
    assert torch.equal(q[0], q[8]) and not torch.equal(q[0], q[1])
    assert torch.equal(xp[0], xp[9])
    assert torch.equal(q[:2], miller_inputs[2])


# ---------------------------------------------------------------------------
# entry points and wrappers: no CUDA, no fallback
# ---------------------------------------------------------------------------

_TOOLS = {"microbench": mb, "proto_mxu": pm, "proto_miller_grid": mg}


@pytest.mark.parametrize("tool", sorted(_TOOLS))
def test_tool_raises_without_cuda(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _TOOLS[tool].main([])


@pytest.mark.parametrize("tool", sorted(_TOOLS))
def test_tool_takes_the_cpu_only_when_asked(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = []
    monkeypatch.setattr(_TOOLS[tool], "run",
                        lambda *a, **k: seen.append((a, k)))
    assert _TOOLS[tool].main(["--device", "cpu"]) == 0
    (args, kwargs), = seen
    assert torch.device("cpu") in args + tuple(kwargs.values())


def test_tool_arguments_keep_the_jax_defaults(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _common.parse_args(["--device", "cpu"], "t",
                              [("B", 128), ("iters", 64)])[0] == [128, 64]
    assert _common.parse_args(["7", "--device", "cpu"], "t",
                              [("reps", 5)])[0] == [7]
    with pytest.raises(ValueError):
        _common.resolve_device("meta")


_META = {"device": "meta"}


@pytest.mark.parametrize("wrapper", ["chain", "wide_chain", "mma_chain",
                                     "mont_chain", "miller_grid"])
def test_probe_wrappers_refuse_other_devices(wrapper):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is never computed by the plain version."""
    i32 = dict(_META, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        if wrapper == "chain":
            mb.chain(torch.empty(8, **i32), torch.empty(8, **i32))
        elif wrapper == "wide_chain":
            mb.wide_chain(torch.empty(8, **i32), torch.empty(8, **i32))
        elif wrapper == "mma_chain":
            f = dict(_META, dtype=torch.bfloat16)
            mb.mma_chain(torch.empty(128, 128, **f), torch.empty(128, 128, **f))
        elif wrapper == "mont_chain":
            pm.mont_chain(torch.empty(3, 12, **i32), torch.empty(3, 12, **i32),
                          2, True)
        else:
            mg.miller_grid(torch.empty(2, 2, 12, **i32),
                           torch.empty(2, 2, 12, **i32),
                           torch.empty(2, 2, 2, 2, 12, **i32))


@pytest.mark.parametrize("case", ["dtype", "shape", "mixed", "mma_rows"])
def test_probe_wrappers_check_their_inputs(case):
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        if case == "dtype":
            mb.chain(x.long(), x.long())
        elif case == "shape":
            pm.mont_chain(torch.zeros(3, 11, dtype=torch.int32),
                          torch.zeros(3, 11, dtype=torch.int32), 1, False)
        elif case == "mixed":
            mb.chain(x, x.float())
        else:
            a = torch.zeros(128, 128, dtype=torch.int8)
            mb.mma_chain(a, torch.zeros(100, 128, dtype=torch.int8))


@pytest.mark.parametrize("name", ["phase_probes", "_probe_library",
                                  "_library_chain_ms"])
def test_chip_smoke_probe_phase_imports_only_the_port(name):
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
