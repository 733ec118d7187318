"""A CPU model of K1 and K2 on the cooperative Fp12 code
(``csrc/f12_group.cuh``): the step tables that ``ops/pairing.py`` builds
and sends to the card with the constant buffer, run here step by step in
the kernels' order (the same loops over the bit tables), each half-group's
op on its own slots with Python ints. The results are held word for word
against the plain versions (``miller_loop_plain``, ``final_exp_plain``),
and the GT value and verdicts against the JAX package's host pairing
(``drand_tpu.crypto.pairing.multi_pairing(canonical=False)``). Static
checks of the tables: one op a step across the warp, no slot read before
it is written, no two half-groups writing one slot in one step, no slot
written in the step that another half-group reads it, slot numbers
within the header's count. And a model of the linear op's signed
addition (``fo_addsub_n``: two carry-lookahead rounds over a half-group's
four 96-bit slices, a carry put in below thread 0) at carry edges.
Tolerance zero."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from drand_tpu.crypto import bls as jbls
from drand_tpu.crypto.curves import PointG1 as JG1, PointG2 as JG2
from drand_tpu.crypto.hash_to_curve import hash_to_g2 as jhash
from drand_tpu.crypto.pairing import multi_pairing
from drand_tpu_torch.ops import f12_group as fg, limb as L
from drand_tpu_torch.ops import pairing as pp

torch.set_num_threads(1)

P = pp.P
RINV = pow(1 << 384, -1, P)
SK = 0x2B7E15


def _mont(x, y):
    return x * y * RINV % P


def _apply(op, mode, a, b):
    """One half-group's operation (f12_group.cuh fo_*), on (c0, c1) ints
    in Montgomery form."""
    if op in (fg.MUL, fg.SQR):
        if op == fg.SQR:
            b = a
        return ((_mont(a[0], b[0]) - _mont(a[1], b[1])) % P,
                (_mont(a[0], b[1]) + _mont(a[1], b[0])) % P)
    if op == fg.LIN:
        x0 = a[1] if mode & fg.X0_A1 else a[0]
        x1 = a[0] if mode & fg.X1_A0 else a[1]
        y0 = b[1] if mode & fg.Y0_B1 else b[0]
        y1 = b[0] if mode & fg.Y1_B0 else b[1]
        return ((x0 - y0 if mode & fg.NEG0 else x0 + y0) % P,
                (x1 - y1 if mode & fg.NEG1 else x1 + y1) % P)
    if op == fg.FMUL:
        return (_mont(a[0], b[0]), 0)
    if op == fg.NORM:
        return ((_mont(a[0], a[0]) + _mont(a[1], a[1])) % P, 0)
    if op == fg.SCLC:
        return (_mont(a[0], b[0]), -_mont(a[1], b[0]) % P)
    raise AssertionError(f"unknown op {op}")


M96 = (1 << 96) - 1


def _slices96(x: int) -> list:
    return [(x >> (96 * k)) & M96 for k in range(4)]


def _lookahead(a, b, c0):
    """One round of fo_addsub_n: slice sums, the generate and propagate
    ballots, s = ((G << 1) | c0) + P, each slice's carry in from s ^ P;
    the carry out of the value is bit 4 of s."""
    s = [x + y for x, y in zip(a, b)]
    g = [v >> 96 for v in s]
    t = [v & M96 for v in s]
    prop = [int(v == M96) for v in t]
    assert not any(x & y for x, y in zip(g, prop))
    G = sum(x << k for k, x in enumerate(g))
    Pr = sum(x << k for k, x in enumerate(prop))
    S = ((G << 1) | c0) + Pr
    cin = [((S ^ Pr) >> k) & 1 for k in range(4)]
    return [(v + c) & M96 for v, c in zip(t, cin)], (S >> 4) & 1


def _addsub(x: int, y: int, neg: int) -> int:
    """fo_addsub_n for one value: t = x + (y ^ M) + neg, u = t + (p or
    ~p + 1), u where a sum reached p or a difference went negative."""
    m = M96 if neg else 0
    t, top = _lookahead(_slices96(x), [v ^ m for v in _slices96(y)], neg)
    u, top2 = _lookahead(t, [v ^ (M96 ^ m) for v in _slices96(P)], neg ^ 1)
    take = (neg & (top ^ 1)) | ((neg ^ 1) & top2)
    return sum(v << (96 * k) for k, v in enumerate(u if take else t))


def test_linear_op_signed_addition_model():
    """The linear op's signed addition, as f12_group.cuh fo_addsub_n
    computes it slice by slice, equals x + y and x - y mod p on values
    whose slices are all ones or zero, on 0, 1, p - 1, p - 2 and random
    values, every pair both ways."""
    rng = np.random.default_rng(9)
    edge = [0, 1, 2, P - 1, P - 2, P >> 1, (P + 1) >> 1]
    edge += [(1 << (96 * k)) - 1 for k in (1, 2, 3)]
    edge += [(1 << (96 * k)) for k in (1, 2, 3)]
    edge += [P - (1 << (96 * k)) for k in (1, 2, 3)]
    edge += [int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)]
    for x in edge:
        for y in edge:
            assert _addsub(x, y, 0) == (x + y) % P
            assert _addsub(x, y, 1) == (x - y) % P


def _reads(op, a, b):
    return {a} if op in (fg.SQR, fg.NORM) else {a, b}


class Machine:
    """One check's slots; run() executes a program's steps as the warp
    does, checking each step's slot use."""

    def __init__(self, tables, values: dict):
        self.t = tables
        self.mem = dict(values)

    def run(self, name: str) -> None:
        for op, hw in self.t["progs"][pp.PROGRAMS.index(name)]:
            ds = [w[0] for w in hw]
            assert len(set(ds)) == len(ds), f"{name}: two writes of a slot"
            new = []
            for h, (d, a, b, mode) in enumerate(hw):
                r = _reads(op, a, b)
                assert all(x in self.mem for x in r), f"{name}: read {r}"
                assert not r & (set(ds) - {d}), f"{name}: read-write race"
                assert max(d, a, b) < self.t["n_slots"]
                new.append((d, _apply(op, mode, self.mem[a], self.mem[b])))
            self.mem.update(new)

    def rows(self, name: str) -> list:
        s = self.t["named"][name]
        return [self.mem[s + i] for i in range(6)]


def _consts_slots(tables) -> dict:
    """The slots the kernels fill before their first program: zero, one
    and the Frobenius coefficients (from the constant buffer)."""
    c = pp.kernel_consts()
    n = tables["named"]
    one = L.words_to_int(c[20:32])
    vals = {n["zero"]: (0, 0), n["one"]: (one, 0)}
    for j, name in enumerate(("gamma1", "gamma2")):
        for k in range(6):
            base = 32 + (j * 6 + k) * 24
            vals[n[name] + k] = (L.words_to_int(c[base:base + 12]),
                                 L.words_to_int(c[base + 12:base + 24]))
    return vals


def _words(t: torch.Tensor) -> list:
    return [L.words_to_int(w) for w in t.reshape(-1, 12).numpy()]


def k1_model(tables, xp, yp, q) -> list:
    """miller_loop_kernel for one check: (2, 12), (2, 12), (2, 2, 2, 12)
    words -> the 72 words of f, as ints."""
    n = tables["named"]
    vals = _consts_slots(tables)
    xs, ys, qs = _words(xp), _words(yp), _words(q)
    for j in range(2):
        vals[n["p"] + j] = (xs[j], 0)
        vals[n["p"] + 2 + j] = (ys[j], 0)
    for i in range(4):
        vals[n["q"] + i] = (qs[2 * i], qs[2 * i + 1])
    m = Machine(tables, vals)
    m.run("k1_init")
    for i in range(pp.N_MILLER):
        m.run("k1_dbl_add" if pp.MILLER_FLAGS[i] else "k1_dbl")
    m.run("k1_fin")
    return [c for row in m.rows("out") for c in row]


def k2_model(tables, f) -> tuple:
    """final_exp_verdict_kernel for one check: (2, 3, 2, 12) words ->
    (the 12 Fp values of gt as ints, the verdict)."""
    n = tables["named"]
    vals = _consts_slots(tables)
    fw = _words(f)
    for r in range(6):
        vals[n["f"] + r] = (fw[2 * r], fw[2 * r + 1])
    m = Machine(tables, vals)

    def pow_neg(bits, nbits):
        for i in range(nbits):
            m.run("k2_cyc_sqr")
            if bits[i]:
                m.run("k2_cyc_mul")

    m.run("k2_easy_head")
    m.run("k2_recip_one")
    for i in range(pp.N_PM2):
        m.run("k2_recip_sqr")
        if pp.PM2[i]:
            m.run("k2_recip_mul")
    m.run("k2_easy_tail")
    pow_neg(pp.BITS_XM1, pp.N_XM1)
    m.run("k2_next")
    pow_neg(pp.BITS_XM1, pp.N_XM1)
    m.run("k2_keep")
    pow_neg(pp.BITS_X, pp.N_X)
    m.run("k2_frob1")
    pow_neg(pp.BITS_X, pp.N_X)
    m.run("k2_next")
    pow_neg(pp.BITS_X, pp.N_X)
    m.run("k2_close")
    out = m.rows("out")
    one = vals[n["one"]]
    return [c for row in out for c in row], out == [one] + [(0, 0)] * 5


@pytest.fixture(scope="module")
def tables():
    return fg.unpack_tables(pp.f12_tables())


@pytest.fixture(scope="module")
def checks():
    """Three checks packed as the engine packs them (affine words of the
    JAX package's host points, ``pack_verify_inputs``), pair 0 = (-g1, sig):
    a valid signature, a signature over another message, and pub = g1
    with sig = msg = g2 (the negated generator against the generator)."""
    pub = JG1.generator().mul(SK)
    h = jhash(b"torch-pairing-group")
    sig_ok = JG2.from_bytes(jbls.sign(SK, b"torch-pairing-group"))
    sig_bad = JG2.from_bytes(jbls.sign(SK, b"torch-pairing-other"))
    g1, g2 = JG1.generator(), JG2.generator()
    rows = [(pub, sig_ok, h), (pub, sig_bad, h), (g1, g2, g2)]

    def g1_words(p):
        x, y = p.to_affine()
        return np.stack([L.fp_words(x.v), L.fp_words(y.v)])

    def g2_words(p):
        x, y = p.to_affine()
        return np.stack([np.stack([L.fp_words(c.c0), L.fp_words(c.c1)])
                         for c in (x, y)])

    xp, yp, q = pp.pack_verify_inputs(*(
        torch.from_numpy(np.stack([conv(r[i]) for r in rows]))
        for i, conv in ((0, g1_words), (1, g2_words), (2, g2_words))))
    f = pp.miller_loop_plain(xp, yp, q)
    gt, ok = pp.final_exp_plain(f)
    return {"rows": rows, "in": (xp, yp, q), "f": f, "gt": gt, "ok": ok}


def test_tables_ride_in_the_constant_buffer(tables):
    """K1 and K2 get kernel_consts() and then the tables, FoSched's
    size; the header names the warp's half-groups and a slot count
    within F12_SLOTS."""
    buf = pp.pairing_consts()
    head = pp.kernel_consts().size
    assert buf.size == head + fg.table_words()
    assert np.array_equal(buf[head:], pp.f12_tables())
    assert tables["nhg"] == fg.NHG == 8
    assert fg.NAMED_END + fg.NHG <= tables["n_slots"] <= fg.MAX_SLOTS
    assert len(tables["progs"]) == len(pp.PROGRAMS)


def test_tables_match_the_headers():
    """The table layout and the names of ops/f12_group.py and
    ops/pairing.py are those of csrc/f12_group.cuh and csrc/pairing.cu:
    FoSched's sizes, the slot count, the named slots' order, the op
    codes and the programs' order."""
    csrc = Path(pp.__file__).resolve().parent.parent / "csrc"
    head = (csrc / "f12_group.cuh").read_text()
    body = (csrc / "pairing.cu").read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", head).group(1))

    assert define("FO_MAX_STEPS") == fg.MAX_STEPS
    assert define("FO_MAX_PROGS") == fg.MAX_PROGS
    assert define("FO_NAMED") == fg.N_NAMED
    assert define("F12_SLOTS") == fg.MAX_SLOTS
    assert define("FO_HG") == fg.NHG

    names = re.findall(r"NM_([A-Z0-9]+)", head.split("enum : int {")[1]
                       .split("};")[0])
    assert [x.lower() for x in names] == list(fg.NAMED_ORDER)
    ops = re.findall(r"FO_([A-Z]+)", head.split("enum : uint32_t {")[1]
                     .split("};")[0])
    assert [x.lower() for x in ops] == list(fg.OP_NAMES)
    progs = re.findall(r"F12P_([A-Z0-9_]+)", body.split("enum : uint32_t {")[1]
                       .split("};")[0])
    assert [x.lower() for x in progs] == list(pp.PROGRAMS) + ["count"]


def test_tables_one_op_a_step_within_slots(tables):
    """Every step is one op code of the warp with one slot word per
    half-group, every slot number below the header's count, and a
    half-group without work writing only its own scratch slot."""
    n = tables["named"]
    assert tables["n_slots"] <= fg.MAX_SLOTS
    for prog in tables["progs"]:
        assert prog
        for op, hw in prog:
            assert 0 <= op < len(fg.OP_NAMES) and len(hw) == tables["nhg"]
            for h, (d, a, b, mode) in enumerate(hw):
                assert max(d, a, b) < tables["n_slots"]
                assert op == fg.LIN or mode == 0
                if n["scratch"] <= d < n["scratch"] + tables["nhg"]:
                    assert d == n["scratch"] + h


def test_tables_slot_use(tables):
    """Run every program in the kernels' order on symbolic slots: no
    slot is read before it is written, no two half-groups write one slot
    in one step, and no half-group writes a slot that another reads in
    the same step."""
    n = tables["named"]
    k1_in = {n["zero"], n["one"]} | {n["p"] + i for i in range(4)} | \
        {n["q"] + i for i in range(4)}
    k2_in = {n["zero"], n["one"]} | {n[k] + i for k in ("f", "gamma1",
                                                        "gamma2")
                                     for i in range(6)}
    order = {"k1": ("k1_init", "k1_dbl", "k1_dbl_add", "k1_fin"),
             "k2": ("k2_easy_head", "k2_recip_one", "k2_recip_sqr",
                    "k2_recip_mul", "k2_easy_tail", "k2_cyc_sqr",
                    "k2_cyc_mul", "k2_next", "k2_keep", "k2_frob1",
                    "k2_close")}
    for kernel, written in (("k1", set(k1_in)), ("k2", set(k2_in))):
        for name in order[kernel]:
            for op, hw in tables["progs"][pp.PROGRAMS.index(name)]:
                ds = [w[0] for w in hw]
                assert len(set(ds)) == tables["nhg"], name
                for d, a, b, _ in hw:
                    r = _reads(op, a, b)
                    assert r <= written, (name, r - written)
                    assert not r & (set(ds) - {d}), name
                written |= set(ds)
        out = {n["out"] + i for i in range(6)}
        assert out <= written


def test_k1_model_matches_plain(tables, checks):
    """K1's tables, run as the card runs them, give miller_loop_plain's
    f word for word on every check."""
    xp, yp, q = checks["in"]
    for i in range(xp.shape[0]):
        assert k1_model(tables, xp[i], yp[i], q[i]) == _words(checks["f"][i])


def test_k2_model_matches_plain_and_host_pairing(tables, checks):
    """K2's tables give final_exp_plain's GT value and verdict word for
    word, and the GT value is the JAX host pairing's multi_pairing(...,
    canonical=False) (the cube of the pairing product)."""
    neg_g1 = -JG1.generator()
    for i, (pub, sig, h) in enumerate(checks["rows"]):
        gt, ok = k2_model(tables, checks["f"][i])
        assert gt == _words(checks["gt"][i])
        assert ok == bool(checks["ok"][i])
        assert ok == (i != 1)
        want = multi_pairing([(neg_g1, sig), (pub, h)], canonical=False)
        host = [c for c6 in (want.c0, want.c1)
                for c2 in (c6.c0, c6.c1, c6.c2) for c in (c2.c0, c2.c1)]
        assert [L.from_mont(x) for x in gt] == host
