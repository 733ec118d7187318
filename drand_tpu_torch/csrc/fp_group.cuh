// Cooperative BLS12-381 Fp and Fp2 arithmetic for K5 (csrc/h2c.cu
// hash_to_g2_kernel): the 12 words of an Fp value are spread over a
// half-group of GT = 4 threads of one warp, GW = 3 words each (thread k of
// the half-group holds words 3k .. 3k+2), and the four compute every
// operation together, exchanging words and carries by warp shuffles and
// ballots. The eight half-groups of a warp run in lockstep: every shuffle
// and ballot is executed by the whole converged warp (FG_WARP).
//
// The arithmetic is fp.cuh's, value for value: Montgomery form with R =
// 2^384, every result fully reduced below p, the CIOS product, Karatsuba
// Fp2 products and the (a0+a1)(a0-a1) squaring. Only where the words live
// changes, so a value computed here is the same integer as the one-thread
// tower computes.
//
// The product (fg_mul_n) is CIOS over the 12 words of b: word i of b is
// broadcast from its owner, every thread adds a·b_i and m·p to its own
// three words (m from the lowest word, which thread 0 holds exactly),
// and the one-word shift takes each thread's lowest word down to the
// thread below. The carry out of each thread's top word is kept beside it
// (hi, at most a few units after the shift) instead of being rippled up
// every step; the 12 steps end with one resolution of those carries and
// the conditional subtraction of p. A carry or borrow between slices is
// resolved at once by carry lookahead over the half-group's lanes: a
// ballot of the slices that generate (carried out) and one of those that
// propagate (all ones, or all zeros for a borrow), and the bits that
// (G << 1) + P flips are the carries in (fg_carry_in_n). Independent
// products, additions and subtractions run N side by side (the _n
// templates), their steps interleaved word by word.
//
// Every operand is a register: the functions are force-inlined and every
// array index is a constant after unrolling (the loop over the source
// thread of b's words stays rolled, to keep the code small, and indexes
// nothing). Nothing here reads local memory. A choice that depends on the
// thread's place (its index k, a flag from its own words) is a mask, never
// a condition: the compiler unswitches a loop on a loop-invariant
// condition, and threads of one half-group would then run different copies
// of the loop, every shuffle synchronising the split warp (several times
// slower).
//
// Compiles as plain C++ too, where the includer supplies __shfl_sync,
// __shfl_up_sync, __shfl_down_sync, __ballot_sync and __any_sync (a host
// emulation of a warp).
#pragma once
#include "fp.cuh"

#define GT 4            // threads holding one Fp value: a half-group
#define GW (NW / GT)    // words of a value held by one thread

#if defined(__CUDACC__)
#define FG_INL __device__ __forceinline__
#else
#define FG_INL static inline
#endif

struct Fg { uint32_t w[GW]; };   // this thread's words of an Fp value
struct F2g { Fg c0, c1; };       // and of an Fp2 value

// The calling thread's place in its half-group: its lane in the warp, its
// index k in the half-group, the half-group's lanes, its words of p, and
// the masks of the product's shift: all ones unless the thread is the top
// one (above: no word comes down to it) or thread 0 (below: no carry
// comes up). The includer loads them from memory, where the compiler
// cannot see that they depend on k and so cannot split a loop on them.
struct Half {
  uint32_t lane, k, mask;
  uint32_t p[GW];
  uint32_t above, below;
};

FG_INL uint32_t fg_lead(const Half& h) { return h.lane - h.k; }

// all ones where b is 1, zero where it is 0
FG_INL uint32_t fg_mask(uint32_t b) { return 0u - b; }

// Every shuffle and ballot is over the whole warp, which must be converged
// at each of them (a mask that differs between the warp's threads makes
// the hardware synchronise each mask group apart, several times slower);
// the half-group's own lanes are picked out by the shuffle width and by
// masking the ballot.
#define FG_WARP 0xFFFFFFFFu

FG_INL void fg_zero(Fg& r) {
#pragma unroll
  for (int v = 0; v < GW; ++v) r.w[v] = 0u;
}

// this thread's words of a full Fp value
FG_INL void fg_slice(Fg& r, const Fp& a, const Half& h) {
#pragma unroll
  for (int v = 0; v < GW; ++v) r.w[v] = a.w[GW * h.k + v];
}

FG_INL uint32_t fg_all_ones(const Fg& a) {
  uint32_t x = 0xFFFFFFFFu;
#pragma unroll
  for (int v = 0; v < GW; ++v) x &= a.w[v];
  return x == 0xFFFFFFFFu ? 1u : 0u;
}

FG_INL uint32_t fg_slice_zero(const Fg& a) {
  uint32_t x = 0u;
#pragma unroll
  for (int v = 0; v < GW; ++v) x |= a.w[v];
  return x == 0u ? 1u : 0u;
}

// the half-group's bits of a ballot
FG_INL uint32_t fg_ballot(uint32_t pred, const Half& h) {
  return __ballot_sync(FG_WARP, pred ? 1 : 0) & h.mask;
}

// 1 iff the whole value is zero (the same answer on the four threads)
FG_INL uint32_t fg_is_zero(const Fg& a, const Half& h) {
  return fg_ballot(fg_slice_zero(a) ? 0u : 1u, h) ? 0u : 1u;
}

// The carries into this thread's slices from the slices below, for N
// values at once, resolved by lookahead: g = 1 on the threads whose slice
// carried out of its top word, prop = 1 on those whose slice passes an
// incoming carry on (never both on one thread). The carries in are the
// bits that the addition (G << 1) + P flips at the four lanes; top gets
// the carry out of the whole value. For a borrow, g is the borrow and
// prop "slice all zeros". The N values' steps interleave.
template <int N>
FG_INL void fg_carry_in_n(uint32_t* cin, uint32_t* top, const uint32_t* g,
                          const uint32_t* prop, const Half& h) {
  uint64_t G[N], P[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    G[q] = fg_ballot(g[q], h);
    P[q] = fg_ballot(prop[q], h);
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const uint64_t s = (G[q] << 1) + P[q];
    top[q] = (uint32_t)(s >> (fg_lead(h) + GT)) & 1u;
    cin[q] = (uint32_t)((s ^ P[q]) >> h.lane) & 1u;
  }
}

// slice + c, c in {0, 1}; the carry out is accounted for by fg_carry_in_n
FG_INL void fg_inc(Fg& x, uint32_t c) {
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    const uint64_t s = (uint64_t)x.w[v] + c;
    x.w[v] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
}

// slice - b, b in {0, 1}
FG_INL void fg_dec(Fg& x, uint32_t b) {
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    const uint32_t o = x.w[v];
    x.w[v] = o - b;
    b &= o == 0u ? 1u : 0u;
  }
}

// r[q] = s[q] - p if s[q] >= p, else s[q] (s[q] < 2p)
template <int N>
FG_INL void fg_reduce_once_n(Fg* r, const Fg* s, const Half& h) {
  Fg d[N];
  uint32_t br[N], zero[N], bin[N], lt[N];
#pragma unroll
  for (int q = 0; q < N; ++q) br[q] = 0u;
#pragma unroll
  for (int v = 0; v < GW; ++v)
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const uint64_t t = (uint64_t)s[q].w[v] - h.p[v] - br[q];
      d[q].w[v] = (uint32_t)t;
      br[q] = (uint32_t)(t >> 63);
    }
#pragma unroll
  for (int q = 0; q < N; ++q) zero[q] = fg_slice_zero(d[q]);
  fg_carry_in_n<N>(bin, lt, br, zero, h);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    fg_dec(d[q], bin[q]);
    const uint32_t keep = fg_mask(lt[q]);
#pragma unroll
    for (int v = 0; v < GW; ++v)
      r[q].w[v] = (s[q].w[v] & keep) | (d[q].w[v] & ~keep);
  }
}

// r[q] = a[q] + b[q] for N values at once
template <int N>
FG_INL void fg_add_n(Fg* r, const Fg* a, const Fg* b, const Half& h) {
  Fg s[N];
  uint64_t c[N];
  uint32_t g[N], ones[N], cin[N], top[N];
#pragma unroll
  for (int q = 0; q < N; ++q) c[q] = 0;
#pragma unroll
  for (int v = 0; v < GW; ++v)
#pragma unroll
    for (int q = 0; q < N; ++q) {
      c[q] += (uint64_t)a[q].w[v] + b[q].w[v];
      s[q].w[v] = (uint32_t)c[q];
      c[q] >>= 32;
    }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    g[q] = (uint32_t)c[q];
    ones[q] = fg_all_ones(s[q]);
  }
  fg_carry_in_n<N>(cin, top, g, ones, h);  // a + b < 2p: no carry out
#pragma unroll
  for (int q = 0; q < N; ++q) fg_inc(s[q], cin[q]);
  fg_reduce_once_n<N>(r, s, h);
}

// r[q] = a[q] - b[q], plus p where it is negative (p masked to zero
// otherwise); the carry out of the top word is the 2^384 wrap
template <int N>
FG_INL void fg_sub_n(Fg* r, const Fg* a, const Fg* b, const Half& h) {
  Fg d[N];
  uint32_t br[N], zero[N], bin[N], neg[N], g[N], ones[N], cin[N], wrap[N];
#pragma unroll
  for (int q = 0; q < N; ++q) br[q] = 0u;
#pragma unroll
  for (int v = 0; v < GW; ++v)
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const uint64_t t = (uint64_t)a[q].w[v] - b[q].w[v] - br[q];
      d[q].w[v] = (uint32_t)t;
      br[q] = (uint32_t)(t >> 63);
    }
#pragma unroll
  for (int q = 0; q < N; ++q) zero[q] = fg_slice_zero(d[q]);
  fg_carry_in_n<N>(bin, neg, br, zero, h);
  uint64_t c[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    fg_dec(d[q], bin[q]);
    c[q] = 0;
  }
#pragma unroll
  for (int v = 0; v < GW; ++v)
#pragma unroll
    for (int q = 0; q < N; ++q) {
      c[q] += (uint64_t)d[q].w[v] + (h.p[v] & fg_mask(neg[q]));
      r[q].w[v] = (uint32_t)c[q];
      c[q] >>= 32;
    }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    g[q] = (uint32_t)c[q];
    ones[q] = fg_all_ones(r[q]);
  }
  fg_carry_in_n<N>(cin, wrap, g, ones, h);
#pragma unroll
  for (int q = 0; q < N; ++q) fg_inc(r[q], cin[q]);
}

FG_INL void fg_add(Fg& r, const Fg& a, const Fg& b, const Half& h) {
  fg_add_n<1>(&r, &a, &b, h);
}

FG_INL void fg_sub(Fg& r, const Fg& a, const Fg& b, const Half& h) {
  fg_sub_n<1>(&r, &a, &b, h);
}

FG_INL void fg_neg(Fg& r, const Fg& a, const Half& h) {
  Fg z;
  fg_zero(z);
  fg_sub(r, z, a, h);
}

// N Montgomery products r[q] = a[q]·b[q]·2^-384 mod p side by side, their
// steps interleaved word by word (r may alias a or b: they are read in
// the loop, r is written after it).
template <int N>
FG_INL void fg_mul_n(Fg* r, const Fg* a, const Fg* b, const Half& h) {
  uint32_t t[N][GW];
  uint64_t hi[N];  // the word above this thread's slice (overlaps the next)
#pragma unroll
  for (int q = 0; q < N; ++q) {
    hi[q] = 0;
#pragma unroll
    for (int v = 0; v < GW; ++v) t[q][v] = 0u;
  }
  const uint32_t n0 = C.n0;
#pragma unroll 1
  for (int j = 0; j < GT; ++j) {         // b's words 3j .. 3j+2, of thread j
#pragma unroll
    for (int w = 0; w < GW; ++w) {
      uint32_t bi[N], m[N];
      uint64_t c[N];
#pragma unroll
      for (int q = 0; q < N; ++q) {
        bi[q] = __shfl_sync(FG_WARP, b[q].w[w], j, GT);
        c[q] = 0;
      }
#pragma unroll
      for (int v = 0; v < GW; ++v)       // t += a·b_i
#pragma unroll
        for (int q = 0; q < N; ++q) {
          c[q] += (uint64_t)a[q].w[v] * bi[q] + t[q][v];
          t[q][v] = (uint32_t)c[q];
          c[q] >>= 32;
        }
#pragma unroll
      for (int q = 0; q < N; ++q) {      // m from the exact lowest word
        hi[q] += c[q];
        m[q] = __shfl_sync(FG_WARP, t[q][0] * n0, 0, GT);
        c[q] = 0;
      }
#pragma unroll
      for (int v = 0; v < GW; ++v)       // t += m·p: the lowest word is 0
#pragma unroll
        for (int q = 0; q < N; ++q) {
          c[q] += (uint64_t)m[q] * h.p[v] + t[q][v];
          t[q][v] = (uint32_t)c[q];
          c[q] >>= 32;
        }
#pragma unroll
      for (int q = 0; q < N; ++q) {      // t /= 2^32
        hi[q] += c[q];
        const uint32_t up = __shfl_down_sync(FG_WARP, t[q][0], 1, GT);
        const uint64_t s = hi[q] + (up & h.above);
#pragma unroll
        for (int v = 0; v + 1 < GW; ++v) t[q][v] = t[q][v + 1];
        t[q][GW - 1] = (uint32_t)s;
        hi[q] = s >> 32;
      }
    }
  }
  // t + the carries kept beside it is below 2p: resolve them, reduce once
  Fg s[N];
  uint64_t c[N];
  uint32_t g[N], ones[N], cin[N], top[N];
#pragma unroll
  for (int q = 0; q < N; ++q)
    c[q] = __shfl_up_sync(FG_WARP, (uint32_t)hi[q], 1, GT) & h.below;
#pragma unroll
  for (int v = 0; v < GW; ++v)
#pragma unroll
    for (int q = 0; q < N; ++q) {
      c[q] += t[q][v];
      s[q].w[v] = (uint32_t)c[q];
      c[q] >>= 32;
    }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    g[q] = (uint32_t)c[q];
    ones[q] = fg_all_ones(s[q]);
  }
  fg_carry_in_n<N>(cin, top, g, ones, h);
#pragma unroll
  for (int q = 0; q < N; ++q) fg_inc(s[q], cin[q]);
  fg_reduce_once_n<N>(r, s, h);
}

FG_INL void fg_mul(Fg& r, const Fg& a, const Fg& b, const Half& h) {
  fg_mul_n<1>(&r, &a, &b, h);
}

// ---------------------------------------------------------------------------
// Fp2 (fp.cuh's formulas)
// ---------------------------------------------------------------------------

FG_INL void f2g_add(F2g& r, const F2g& a, const F2g& b, const Half& h) {
  fg_add(r.c0, a.c0, b.c0, h);
  fg_add(r.c1, a.c1, b.c1, h);
}

FG_INL void f2g_sub(F2g& r, const F2g& a, const F2g& b, const Half& h) {
  fg_sub(r.c0, a.c0, b.c0, h);
  fg_sub(r.c1, a.c1, b.c1, h);
}

FG_INL void f2g_neg(F2g& r, const F2g& a, const Half& h) {
  fg_neg(r.c0, a.c0, h);
  fg_neg(r.c1, a.c1, h);
}

FG_INL void f2g_conj(F2g& r, const F2g& a, const Half& h) {
  r.c0 = a.c0;
  fg_neg(r.c1, a.c1, h);
}

FG_INL uint32_t f2g_is_zero(const F2g& a, const Half& h) {
  Fg o;
#pragma unroll
  for (int v = 0; v < GW; ++v) o.w[v] = a.c0.w[v] | a.c1.w[v];
  return fg_is_zero(o, h);
}

FG_INL uint32_t f2g_eq(const F2g& a, const F2g& b, const Half& h) {
  Fg d;
#pragma unroll
  for (int v = 0; v < GW; ++v)
    d.w[v] = (a.c0.w[v] ^ b.c0.w[v]) | (a.c1.w[v] ^ b.c1.w[v]);
  return fg_is_zero(d, h);
}

// N Karatsuba products side by side: their 3N Fp products and their
// additions interleave
template <int N>
FG_INL void f2g_mul_n(F2g* r, const F2g* a, const F2g* b, const Half& h) {
  Fg x[3 * N], y[3 * N], v[3 * N], lo[2 * N], hi2[2 * N], sum[2 * N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    x[3 * q] = a[q].c0;
    x[3 * q + 1] = a[q].c1;
    y[3 * q] = b[q].c0;
    y[3 * q + 1] = b[q].c1;
    lo[q] = a[q].c0;
    hi2[q] = a[q].c1;
    lo[N + q] = b[q].c0;
    hi2[N + q] = b[q].c1;
  }
  fg_add_n<2 * N>(sum, lo, hi2, h);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    x[3 * q + 2] = sum[q];
    y[3 * q + 2] = sum[N + q];
  }
  fg_mul_n<3 * N>(v, x, y, h);
  Fg v0[N], v1[N], v2[N], c0[N], s01[N], c1[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    v0[q] = v[3 * q];
    v1[q] = v[3 * q + 1];
    v2[q] = v[3 * q + 2];
  }
  fg_sub_n<N>(c0, v0, v1, h);
  fg_add_n<N>(s01, v0, v1, h);
  fg_sub_n<N>(c1, v2, s01, h);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    r[q].c0 = c0[q];
    r[q].c1 = c1[q];
  }
}

// N squarings (a0 + a1)(a0 - a1) + 2·a0·a1·u side by side
template <int N>
FG_INL void f2g_sqr_n(F2g* r, const F2g* a, const Half& h) {
  Fg x[2 * N], y[2 * N], v[2 * N], a0[N], a1[N], s[N], d[N], v1[N], c1[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    a0[q] = a[q].c0;
    a1[q] = a[q].c1;
  }
  fg_add_n<N>(s, a0, a1, h);
  fg_sub_n<N>(d, a0, a1, h);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    x[2 * q] = s[q];
    y[2 * q] = d[q];
    x[2 * q + 1] = a0[q];
    y[2 * q + 1] = a1[q];
  }
  fg_mul_n<2 * N>(v, x, y, h);
#pragma unroll
  for (int q = 0; q < N; ++q) v1[q] = v[2 * q + 1];
  fg_add_n<N>(c1, v1, v1, h);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    r[q].c0 = v[2 * q];
    r[q].c1 = c1[q];
  }
}

// Karatsuba: the three Fp products side by side
FG_INL void f2g_mul(F2g& r, const F2g& a, const F2g& b, const Half& h) {
  f2g_mul_n<1>(&r, &a, &b, h);
}

// (a0 + a1)(a0 - a1) + 2·a0·a1·u: the two Fp products side by side
FG_INL void f2g_sqr(F2g& r, const F2g& a, const Half& h) {
  f2g_sqr_n<1>(&r, &a, h);
}
