"""Step tables of the cooperative Fp12 code (``csrc/f12_group.cuh``): one
check's Fp2, Fp6 and Fp12 work written as a schedule over the eight
half-groups of a warp, for K1 and K2 (``csrc/pairing.cu``).

A program is a straight-line computation on Fp2 values, recorded by
``Prog`` from the tower's formulas below (those of ``ops/field.py``, with
Karatsuba splits that expose independent products). ``compile_prog``
cuts it into steps: at each step every half-group of the warp runs the
same Fp2 operation, each on its own slot numbers, and a half-group with
nothing to do writes its own scratch slot. The steps are chosen by list
scheduling on the longest remaining chain of Fp products; the values get
shared-memory slots by a linear scan that never lets a step write a
slot that the same step reads, and never lets two half-groups write one
slot in one step. The card runs these tables as they are
(``pairing.pairing_consts`` appends them to the constant buffer), and
the CPU tests run the same tables step by step.

Operations (``FO_*`` in ``f12_group.cuh``), on slots of Fp2 values in
Montgomery form, every result fully reduced below p:

    MUL   d = a·b                 (Karatsuba, three Fp products)
    SQR   d = a²                  (two Fp products)
    LIN   d = (x0 ± y0, x1 ± y1)  x from a's words, y from b's, the
                                  signs and sources set by a mode per
                                  half-group: add, sub, ξ·a, conj, copy
    FMUL  d = (a0·b0, 0)          the Fermat inversion's steps
    NORM  d = (a0² + a1², 0)      an Fp2 inversion's norm
    SCLC  d = (a0·t, -(a1·t))     t = b0, its inverse: the Fp2 inverse

A step whose half-groups mix products and squarings runs as MUL with
b = a where a square was asked for (the same value).

Table layout (struct FoSched, the same order): counts, the named slots
(``NAMED``), each program's first step and step count, one op code a
step, then for each step and half-group a word d | a << 8 | b << 16 |
mode << 24.
"""

from __future__ import annotations

import numpy as np

NHG = 8                  # half-groups of a check: one warp (FO_HG)
MAX_SLOTS = 176          # F12_SLOTS: slots of a check's shared memory
MAX_STEPS = 480           # FO_MAX_STEPS
MAX_PROGS = 24           # FO_MAX_PROGS
N_NAMED = 24             # FO_NAMED

MUL, SQR, LIN, FMUL, NORM, SCLC = range(6)
OP_NAMES = ("mul", "sqr", "lin", "fmul", "norm", "sclc")
# the scheduler's weights: Fp products of an op, a linear op's share
COST = {MUL: 3.0, SQR: 2.0, LIN: 0.3, FMUL: 1.0, NORM: 2.0, SCLC: 2.0}
_GROUP = {MUL: "p", SQR: "p", LIN: "l", FMUL: "f", NORM: "n", SCLC: "s"}

# LIN mode bits (FO_NEG0 ... in f12_group.cuh): c0 = x0 ± y0, c1 = x1 ± y1
NEG0, NEG1, X0_A1, X1_A0, Y0_B1, Y1_B0 = (1 << i for i in range(6))
M_ADD, M_SUB = 0, NEG0 | NEG1
M_XI = NEG0 | X1_A0 | Y0_B1          # (a0 - a1, a0 + a1), b = a
M_CONJ = NEG1                        # (0 + b0, 0 - b1), a = zero

# Named slots (FoSched.named, index -> first slot). Slots below
# NAMED_END are fixed; then one scratch slot a half-group, then the
# programs' temporaries.
NAMED = {
    "zero": 0, "one": 1,
    "scratch": 70,           # NHG slots, one a half-group
    "p": 2,                  # K1: xp0, xp1, yp0, yp1 as (x, 0)
    "q": 6,                  # K1: qx0, qy0, qx1, qy1
    "t": 10,                 # K1: T of pair 0 (x, y, z), then of pair 1
    "f": 16,                 # K1: f; K2: its input f (6 rows)
    "out": 22,               # K1: conj(f); K2: the GT value (6 rows)
    "gamma1": 28, "gamma2": 34,   # K2: Frobenius coefficients (w-basis)
    "m": 40, "a": 46, "acc": 52, "base": 58,   # K2's Fp12 registers
    "inv": 64,               # K2: d, the three Fp6 inverse terms
    "norm": 68, "recip": 69,  # K2: d's norm and its Fermat inverse
}
NAMED_END = 70
NAMED_ORDER = tuple(NAMED)           # FoSched.named's order
assert len(NAMED_ORDER) <= N_NAMED


class Val:
    """An Fp2 value of a program: the node that makes it, or the slot an
    input lies in."""
    __slots__ = ("node", "slot")

    def __init__(self, node=None, slot=None):
        self.node, self.slot = node, slot


class Node:
    __slots__ = ("op", "mode", "args", "out", "idx", "succ", "prio", "step")

    def __init__(self, op, mode, args, idx):
        self.op, self.mode, self.args, self.idx = op, mode, args, idx
        self.out = Val(self)
        self.succ, self.prio, self.step = [], 0.0, -1


class Prog:
    """A straight-line program on Fp2 values; outputs are pinned to
    slots."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: list[Node] = []
        self.pins: list[tuple[Val, int]] = []
        self._inputs: dict[int, Val] = {}
        self.zero = self.slot("zero")
        self.one = self.slot("one")

    # -- values ------------------------------------------------------------
    def slot(self, name: str, i: int = 0) -> Val:
        s = NAMED[name] + i
        if s not in self._inputs:
            self._inputs[s] = Val(slot=s)
        return self._inputs[s]

    def slots(self, name: str, n: int) -> list:
        return [self.slot(name, i) for i in range(n)]

    def output(self, v: Val, slot: int) -> None:
        if v.node is None and v.slot == slot:
            return                      # already there
        if v.node is None or any(p is v for p, _ in self.pins):
            v = self.copy(v)
        self.pins.append((v, slot))

    def outputs(self, vals, name: str) -> None:
        for i, v in enumerate(vals):
            self.output(v, NAMED[name] + i)

    def _op(self, op, args, mode=0) -> Val:
        n = Node(op, mode, list(args), len(self.nodes))
        self.nodes.append(n)
        return n.out

    # -- Fp2 operations ----------------------------------------------------
    def mul(self, a, b):
        if a is self.zero or b is self.zero:
            return self.zero
        return self._op(SQR, (a, a)) if a is b else self._op(MUL, (a, b))

    def sqr(self, a):
        return self._op(SQR, (a, a))

    def lin(self, a, b, mode):
        return self._op(LIN, (a, b), mode)

    # a zero operand folds away (the same value with fewer operations)
    def add(self, a, b):
        if b is self.zero:
            return a
        return b if a is self.zero else self.lin(a, b, M_ADD)

    def sub(self, a, b):
        if b is self.zero:
            return a
        return self.neg(b) if a is self.zero else self.lin(a, b, M_SUB)

    def dbl(self, a):
        return self.add(a, a)

    def mul3(self, a):
        return self.add(self.dbl(a), a)

    def xi(self, a):
        return a if a is self.zero else self.lin(a, a, M_XI)

    def conj(self, a):
        return a if a is self.zero else self.lin(self.zero, a, M_CONJ)

    def neg(self, a):
        return a if a is self.zero else self.lin(self.zero, a, M_SUB)

    def copy(self, a):
        return self.lin(a, self.zero, M_ADD)

    def fmul(self, a, b):
        return self._op(FMUL, (a, b))

    def norm(self, a):
        return self._op(NORM, (a, a))

    def scale_conj(self, a, t):
        return self._op(SCLC, (a, t))


# ---------------------------------------------------------------------------
# The tower (ops/field.py's formulas; an Fp6 is 3 values, an Fp12 6 in the
# row order of the (2, 3) layout: c0.c0, c0.c1, c0.c2, c1.c0, c1.c1, c1.c2)
# ---------------------------------------------------------------------------

def w_at(a, k: int):
    """The coefficient of w^k of an Fp12 (rows (k % 2)·3 + k // 2)."""
    return a[(k % 2) * 3 + k // 2]


def from_w(w) -> list:
    """Rows of the Fp12 whose w^k coefficient is w[k]."""
    return [w[0], w[2], w[4], w[1], w[3], w[5]]


def f6_add(g: Prog, a, b):
    return [g.add(x, y) for x, y in zip(a, b)]


def f6_sub(g: Prog, a, b):
    return [g.sub(x, y) for x, y in zip(a, b)]


def f6_mul_by_v(g: Prog, a):
    return [g.xi(a[2]), a[0], a[1]]


def f6_mul(g: Prog, a, b):
    """Karatsuba over Fp2: six products (squares where a is b)."""
    v0, v1, v2 = (g.mul(a[i], b[i]) for i in range(3))
    same = a is b

    def pair(i, j):
        s = g.add(a[i], a[j])
        return g.mul(s, s if same else g.add(b[i], b[j]))

    m12, m01, m02 = pair(1, 2), pair(0, 1), pair(0, 2)
    c0 = g.add(v0, g.xi(g.sub(m12, g.add(v1, v2))))
    c1 = g.add(g.sub(m01, g.add(v0, v1)), g.xi(v2))
    c2 = g.add(g.sub(m02, g.add(v0, v2)), v1)
    return [c0, c1, c2]


def f12_mul(g: Prog, a, b):
    """Karatsuba over Fp6: three Fp6 products, 18 Fp2 products."""
    a0, a1, b0, b1 = a[:3], a[3:], b[:3], b[3:]
    v0 = f6_mul(g, a0, b0)
    v1 = f6_mul(g, a1, b1)
    v2 = f6_mul(g, f6_add(g, a0, a1), f6_add(g, b0, b1))
    c0 = f6_add(g, v0, f6_mul_by_v(g, v1))
    c1 = f6_sub(g, v2, f6_add(g, v0, v1))
    return c0 + c1


def f12_sqr(g: Prog, a):
    """c0 = (a0+a1)(a0+v·a1) - v0 - v·v0, c1 = 2·v0 with v0 = a0·a1."""
    a0, a1 = a[:3], a[3:]
    v0 = f6_mul(g, a0, a1)
    w = f6_mul(g, f6_add(g, a0, a1), f6_add(g, a0, f6_mul_by_v(g, a1)))
    t = f6_add(g, v0, f6_mul_by_v(g, v0))
    return f6_sub(g, w, t) + f6_add(g, v0, v0)


def f12_conj(g: Prog, a):
    return list(a[:3]) + [g.neg(x) for x in a[3:]]


def f12_frobenius(g: Prog, a, power: int):
    """a^(p^power): w^k coefficient (conj if power is odd) times γ_k."""
    gam = g.slots("gamma1" if power == 1 else "gamma2", 6)
    w = []
    for k in range(6):
        x = w_at(a, k)
        if power & 1:
            x = g.conj(x)
        w.append(g.mul(x, gam[k]))
    return from_w(w)


def f12_cyclotomic_sqr(g: Prog, a):
    """Granger-Scott, as field.py f12_cyclotomic_sqr: three Fp4 squarings
    x² + ξy² and 2xy of the pairs (w^k, w^(k+3)), each by two products,
    (x + y)(x + ξy) - xy - ξ·xy and 2·xy (the six products are one step
    of the warp), then 3t - 2g and 3t + 2g."""
    lo, hi = [], []
    for k in range(3):
        x, y = w_at(a, k), w_at(a, k + 3)
        m1 = g.mul(x, y)
        m2 = g.mul(g.add(x, y), g.add(x, g.xi(y)))
        lo.append(g.sub(g.sub(m2, m1), g.xi(m1)))
        hi.append(g.dbl(m1))
    tv = [lo[0], g.xi(hi[2]), lo[1], hi[0], lo[2], hi[1]]
    out = []
    for k in range(6):
        gk = w_at(a, k)
        s = g.sub(tv[k], gk) if k % 2 == 0 else g.add(tv[k], gk)
        out.append(g.add(g.dbl(s), tv[k]))
    return from_w(out)


def f12_inv_head(g: Prog, a):
    """field.py f12_inv up to the Fermat inversion: t = a0² - v·a1², its
    f6_inv terms T0, T1, T2, d = a0·T0 + ξ(a2·T1) + ξ(a1·T2) of t, and
    d's norm. Returns (d, [T0, T1, T2], norm)."""
    a0, a1 = a[:3], a[3:]
    t = f6_sub(g, f6_mul(g, a0, a0), f6_mul_by_v(g, f6_mul(g, a1, a1)))
    c0, c1, c2 = t
    t0 = g.sub(g.sqr(c0), g.xi(g.mul(c1, c2)))
    t1 = g.sub(g.xi(g.sqr(c2)), g.mul(c0, c1))
    t2 = g.sub(g.sqr(c1), g.mul(c0, c2))
    s = g.add(g.xi(g.mul(c2, t1)), g.xi(g.mul(c1, t2)))
    d = g.add(g.mul(c0, t0), s)
    return d, [t0, t1, t2], g.norm(d)


def f12_inv_tail(g: Prog, a, d, terms, recip):
    """The rest of f12_inv once recip = 1/norm(d) (c0 of its slot): d^-1
    = conj(d)·recip, t^-1 = T_i·d^-1, a^-1 = (a0·t^-1, -(a1·t^-1))."""
    dinv = g.scale_conj(d, recip)
    tinv = [g.mul(x, dinv) for x in terms]
    return f6_mul(g, a[:3], tinv) + [g.neg(x) for x in f6_mul(g, a[3:], tinv)]


# ---------------------------------------------------------------------------
# Compilation: steps, slots, the table
# ---------------------------------------------------------------------------

class Compiled:
    """A program cut into steps: per step its op and, per half-group,
    (d, a, b, mode)."""

    def __init__(self, name, steps):
        self.name, self.steps = name, steps


def _schedule(prog: Prog):
    nodes = prog.nodes
    need = {}
    for n in nodes:
        n.succ, n.step = [], -1
        preds = {id(a.node): a.node for a in n.args if a.node is not None}
        need[id(n)] = len(preds)
        for a in preds.values():
            a.succ.append(n)
    for n in reversed(nodes):
        n.prio = COST[n.op] + max((s.prio for s in n.succ), default=0.0)
    ready = [n for n in nodes if need[id(n)] == 0]
    steps = []
    while ready:
        ready.sort(key=lambda n: (-n.prio, n.idx))
        group = _GROUP[ready[0].op]
        n_prod = sum(1 for n in ready if _GROUP[n.op] == "p")
        if group == "p" and n_prod < NHG and any(n.op == LIN for n in ready):
            group = "l"     # a cheap linear step first may fill the products
        take = [n for n in ready if _GROUP[n.op] == group][:NHG]
        op = take[0].op
        if group == "p":
            op = MUL if any(n.op == MUL for n in take) else SQR
        taken = set(map(id, take))
        ready = [n for n in ready if id(n) not in taken]
        for n in take:
            n.step = len(steps)
            for m in n.succ:
                need[id(m)] -= 1
                if need[id(m)] == 0:
                    ready.append(m)
        steps.append((op, take))
    assert all(n.step >= 0 for n in nodes)
    return steps


def compile_prog(prog: Prog) -> Compiled:
    """List-schedule PROG on NHG half-groups and give its values slots:
    temporaries after the scratch slots, outputs their pinned slots
    (through a copy at the end where the pinned slot is still read when
    the output is made)."""
    steps = _schedule(prog)
    inf = len(steps) + 1
    last = {}
    for n in prog.nodes:
        for a in n.args:
            last[id(a)] = max(last.get(id(a), -1), n.step)
    pinned = {id(v): s for v, s in prog.pins}
    for v, _ in prog.pins:
        last[id(v)] = inf
    slot = {id(v): v.slot for v in prog._inputs.values()}
    holder = {v.slot: v for v in prog._inputs.values()}   # pinned slots
    free = list(range(NAMED_END + NHG, MAX_SLOTS))
    live_tmp = []                     # (value, slot)
    copies = []                       # (temp slot, pinned slot)
    for s, (_, take) in enumerate(steps):
        still = []
        for v, sl in live_tmp:
            if last.get(id(v), -1) < s:
                free.append(sl)
            else:
                still.append((v, sl))
        live_tmp = still
        free.sort()
        written = []                  # never-read results of this step
        for n in take:
            v = n.out
            want = pinned.get(id(v))
            if want is not None:
                old = holder.get(want)
                if old is None or last.get(id(old), -1) < s:
                    slot[id(v)] = want
                    holder[want] = v
                    continue
            if not free:
                raise RuntimeError(f"{prog.name}: more than {MAX_SLOTS} slots")
            sl = free.pop(0)
            slot[id(v)] = sl
            if want is not None:
                copies.append((sl, want))
                last[id(v)] = inf
            if last.get(id(v), -1) >= 0:
                live_tmp.append((v, sl))
            else:
                written.append(sl)
        free.extend(written)          # never read: free after this step
    out = []
    for op, take in steps:
        words = [(slot[id(n.out)], slot[id(n.args[0])], slot[id(n.args[1])],
                  n.mode) for n in take]
        out.append((op, _pad(words)))
    for i in range(0, len(copies), NHG):
        words = [(d, a, NAMED["zero"], M_ADD) for a, d in copies[i:i + NHG]]
        out.append((LIN, _pad(words)))
    return Compiled(prog.name, out)


def _pad(words):
    """Half-groups past the step's ops write their own scratch slot from
    zero."""
    z = NAMED["zero"]
    return words + [(NAMED["scratch"] + h, z, z, M_ADD)
                    for h in range(len(words), NHG)]


def raw_prog(name: str, op: int, d: int, a: int, b: int) -> Compiled:
    """One step of one op on half-group 0, the others idle: the Fermat
    inversion's square and multiply (in place on half-group 0)."""
    return Compiled(name, [(op, _pad([(d, a, b, 0)]))])


def pack_tables(progs: list) -> np.ndarray:
    """struct FoSched as int32 words: n_steps, n_progs, n_slots, NHG, the
    named slots, (first, count) per program, the op codes and the slot
    words, zero-padded to the struct's size."""
    ops, words, heads = [], [], []
    used = NAMED_END + NHG
    for p in progs:
        heads.append((len(ops), len(p.steps)))
        for op, hw in p.steps:
            ops.append(op)
            for d, a, b, mode in hw:
                used = max(used, d + 1, a + 1, b + 1)
                words.append(d | a << 8 | b << 16 | mode << 24)
    if len(ops) > MAX_STEPS or len(progs) > MAX_PROGS or used > MAX_SLOTS:
        raise RuntimeError(f"tables too large: {len(ops)} steps, "
                           f"{len(progs)} programs, {used} slots")
    head = np.zeros(4 + N_NAMED + 2 * MAX_PROGS, dtype=np.uint32)
    head[:4] = (len(ops), len(progs), used, NHG)
    head[4:4 + len(NAMED_ORDER)] = [NAMED[k] for k in NAMED_ORDER]
    for i, (first, n) in enumerate(heads):
        head[4 + N_NAMED + 2 * i:4 + N_NAMED + 2 * i + 2] = (first, n)
    op_arr = np.zeros(MAX_STEPS, dtype=np.uint32)
    op_arr[:len(ops)] = ops
    w_arr = np.zeros(MAX_STEPS * NHG, dtype=np.uint32)
    w_arr[:len(words)] = words
    return np.concatenate([head, op_arr, w_arr]).view(np.int32)


def unpack_tables(buf: np.ndarray) -> dict:
    """The programs of a packed FoSched, as the card reads them: name
    index -> list of (op, [(d, a, b, mode)] per half-group)."""
    u = np.asarray(buf).view(np.uint32)
    n_steps, n_progs = int(u[0]), int(u[1])
    heads = u[4 + N_NAMED:4 + N_NAMED + 2 * n_progs].reshape(-1, 2)
    ops = u[4 + N_NAMED + 2 * MAX_PROGS:][:MAX_STEPS]
    words = u[4 + N_NAMED + 2 * MAX_PROGS + MAX_STEPS:].reshape(-1, NHG)
    progs = []
    for first, n in heads:
        progs.append([(int(ops[s]), [(int(w) & 0xFF, int(w) >> 8 & 0xFF,
                                      int(w) >> 16 & 0xFF, int(w) >> 24)
                                     for w in words[s]])
                      for s in range(first, first + n)])
    assert sum(len(p) for p in progs) == n_steps
    return {"progs": progs, "n_slots": int(u[2]), "nhg": int(u[3]),
            "named": dict(zip(NAMED_ORDER,
                              (int(x) for x in u[4:4 + len(NAMED_ORDER)])))}


def table_words() -> int:
    """The size of struct FoSched in words."""
    return 4 + N_NAMED + 2 * MAX_PROGS + MAX_STEPS * (1 + NHG)
