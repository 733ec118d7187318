// Cooperative Fp12 code for K1 and K2 (csrc/pairing.cu): one check's Fp2,
// Fp6 and Fp12 work spread over the eight half-groups of a warp.
//
// A check is one warp (FO_HG = 8 half-groups). Its Fp2 values live in
// shared-memory slots that every half-group of the check reads: slot s
// holds, for each
// of the four threads k of a half-group, its three words of c0 and of c1
// (fp_group.cuh's split, words 3k .. 3k+2), word (c·GW + v) of thread k
// at offset (c·GW + v)·GT + k, so the four threads of a half-group read
// four consecutive banks. A slot takes FO_SLOT_WORDS = 28 words (24 and
// 4 of padding): the eight half-groups fall on the eight groups of four
// banks whenever their slot numbers differ modulo 8.
//
// The work is a table of steps (ops/f12_group.py builds it from the
// tower's formulas and ops/pairing.py from K1's and K2's; the launch
// copies it beside the constant buffer into FS). At a step every
// half-group runs the same Fp2 operation (the step's op code, the same
// for the whole warp), each on its own slot numbers (its word of the
// step: d | a << 8 | b << 16 | mode << 24); a half-group with nothing to
// do writes its own scratch slot. A __syncwarp() separates the steps,
// so a slot written at one step is read at the next. The
// tables never let two half-groups write one slot in one step, nor a
// step write a slot that another half-group reads in it.
//
// Each operation is one small out-of-line function with its operands in
// registers (fo_mul, fo_sqr, fo_lin, ...), as g2_group.cuh's gg_* are; the
// loop over a program's steps (fo_run) and the loops over the exponents'
// bits (uniform: the same on every thread) stay in the kernels, between
// calls. The rules of g2_group.cuh hold here too: every shuffle and
// ballot is over the whole converged warp; no branch inside a function
// before a shuffle; a choice that depends on the thread's place (its slot
// numbers, a linear op's mode) is an address or a mask, never a
// condition. A product step costs about 2.0 µs on an H100, a linear step
// about 0.41 (PERF.md §6): the warp is issue-bound, so the linear op
// computes one signed addition a component
// (fo_addsub_n), not a sum and a difference to choose from, and no op
// computes a whole value in each thread (its carry chains cost more than
// the ballots they save).
//
// The arithmetic is fp_group.cuh's (Montgomery, R = 2^384, every result
// fully reduced below p), so every slot holds the same integer as the
// plain version (ops/field.py) computes for the same value.
//
// The includer defines F12_CHECKS (checks a block) before including this
// header. Compiles as plain C++ with GG_WARP_EMULATION, where the
// includer supplies gg_emulated_tid(), __syncwarp() and the warp
// intrinsics of fp_group.cuh (a host emulation of one warp).
#pragma once
#include "fp_group.cuh"

#define FO_HG 8                   // half-groups of a check: one warp
#define F12_SLOTS 176             // Fp2 slots of a check (ops/f12_group.py)
#define FO_SLOT_WORDS 28          // 24 words of a slot and 4 of padding
#define FO_MAX_STEPS 480
#define FO_MAX_PROGS 24
#define FO_NAMED 24
#define F12_BLOCK (32 * F12_CHECKS)

#if defined(__CUDACC__)
#define FO_OP __device__ __noinline__
#define FO_SHARED __shared__
#define FO_TID ((uint32_t)threadIdx.x)
#else  // a host emulation of one warp supplies gg_emulated_tid()
#define FO_OP static
#define FO_SHARED static
#define FO_TID gg_emulated_tid()
#endif

// Op codes (ops/f12_group.py MUL ... SCLC)
enum : uint32_t { FO_MUL = 0, FO_SQR, FO_LIN, FO_FMUL, FO_NORM, FO_SCLC };

// The named slots' order in FoSched.named (ops/f12_group.py NAMED)
enum : int {
  NM_ZERO = 0, NM_ONE, NM_SCRATCH, NM_P, NM_Q, NM_T, NM_F, NM_OUT, NM_GAMMA1,
  NM_GAMMA2, NM_M, NM_A, NM_ACC, NM_BASE, NM_INV, NM_NORM, NM_RECIP
};

// The step tables (ops/f12_group.py pack_tables, the same order)
struct FoSched {
  uint32_t n_steps, n_progs, n_slots, nhg;
  uint32_t named[FO_NAMED];               // first slot of each name
  uint32_t prog[FO_MAX_PROGS][2];         // first step, steps
  uint32_t op[FO_MAX_STEPS];
  uint32_t slot[FO_MAX_STEPS][FO_HG];     // d | a << 8 | b << 16 | mode << 24
};

FP_CONST FoSched FS;

FO_SHARED uint32_t fo_mem[F12_CHECKS * F12_SLOTS * FO_SLOT_WORDS];
// each thread's words of p, then its masks Half::above and Half::below
FO_SHARED uint32_t fo_p[(GW + 2) * F12_BLOCK];

FG_INL uint32_t fo_hg() { return FO_TID % 32u / GT; }

// The calling thread's words of p and shift masks, written once before
// its first operation (fo_half reads them back, see Half)
FG_INL void fo_init() {
  const uint32_t tid = FO_TID, k = tid % GT;
#pragma unroll
  for (int v = 0; v < GW; ++v) fo_p[v * F12_BLOCK + tid] = C.p.w[GW * k + v];
  fo_p[GW * F12_BLOCK + tid] = k == GT - 1 ? 0u : 0xFFFFFFFFu;
  fo_p[(GW + 1) * F12_BLOCK + tid] = k == 0 ? 0u : 0xFFFFFFFFu;
}

FG_INL Half fo_half() {
  Half h;
  const uint32_t tid = FO_TID;
  h.lane = tid % 32u;
  h.k = h.lane % GT;
  h.mask = ((1u << GT) - 1u) << (h.lane - h.k);
#pragma unroll
  for (int v = 0; v < GW; ++v) h.p[v] = fo_p[v * F12_BLOCK + tid];
  h.above = fo_p[GW * F12_BLOCK + tid];
  h.below = fo_p[(GW + 1) * F12_BLOCK + tid];
  return h;
}

// this thread's column of slot s of its warp's check
FG_INL uint32_t* fo_col(uint32_t s) {
  const uint32_t tid = FO_TID;
  return fo_mem + ((tid / 32u) * F12_SLOTS + s) * FO_SLOT_WORDS +
         tid % GT;
}

FG_INL void fo_ld(F2g& r, uint32_t s) {
  const uint32_t* c = fo_col(s);
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    r.c0.w[v] = c[v * GT];
    r.c1.w[v] = c[(GW + v) * GT];
  }
}

FG_INL void fo_st(uint32_t s, const F2g& a) {
  uint32_t* c = fo_col(s);
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    c[v * GT] = a.c0.w[v];
    c[(GW + v) * GT] = a.c1.w[v];
  }
}

// Slot S := the Fp2 value of 24 words at SRC (c0 then c1; c1 zero when
// SRC1 is null), this thread's words
FG_INL void fo_put(uint32_t s, const uint32_t* src0, const uint32_t* src1) {
  const uint32_t k = FO_TID % GT;
  F2g x;
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    x.c0.w[v] = src0[GW * k + v];
    x.c1.w[v] = src1 ? src1[GW * k + v] : 0u;
  }
  fo_st(s, x);
}

// 24 words at DST (c0 then c1) := slot S, this thread's words
FG_INL void fo_get(uint32_t* dst, uint32_t s) {
  const uint32_t k = FO_TID % GT;
  F2g x;
  fo_ld(x, s);
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    dst[GW * k + v] = x.c0.w[v];
    dst[NW + GW * k + v] = x.c1.w[v];
  }
}

FG_INL uint32_t fo_d(uint32_t w) { return w & 0xFFu; }
FG_INL uint32_t fo_a(uint32_t w) { return w >> 8 & 0xFFu; }
FG_INL uint32_t fo_b(uint32_t w) { return w >> 16 & 0xFFu; }

// ---------------------------------------------------------------------------
// One step's operation, out of line; W is this half-group's word
// ---------------------------------------------------------------------------

FO_OP void fo_mul(uint32_t w) {
  const Half h = fo_half();
  F2g x, y;
  fo_ld(x, fo_a(w));
  fo_ld(y, fo_b(w));
  f2g_mul(x, x, y, h);
  fo_st(fo_d(w), x);
}

FO_OP void fo_sqr(uint32_t w) {
  const Half h = fo_half();
  F2g x;
  fo_ld(x, fo_a(w));
  f2g_sqr(x, x, h);
  fo_st(fo_d(w), x);
}

// fg_carry_in_n with a carry C0[q] into the value's lowest slice: it
// takes the place of the generate bit below thread 0
template <int N>
FG_INL void fo_carry_in_n(uint32_t* cin, uint32_t* top, const uint32_t* g,
                          const uint32_t* prop, const uint32_t* c0,
                          const Half& h) {
  uint64_t G[N], P[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    G[q] = fg_ballot(g[q], h);
    P[q] = fg_ballot(prop[q], h);
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const uint64_t s =
        ((G[q] << 1) | ((uint64_t)c0[q] << fg_lead(h))) + P[q];
    top[q] = (uint32_t)(s >> (fg_lead(h) + GT)) & 1u;
    cin[q] = (uint32_t)((s ^ P[q]) >> h.lane) & 1u;
  }
}

// r[q] = x[q] + y[q] or, where neg[q] = 1, x[q] - y[q], mod p, for
// canonical x, y, in two carry-lookahead rounds: t = x + (y ^ M) + neg
// (M all ones where neg: x - y mod 2^384, the carry out 1 iff x >= y),
// then u = t - p (a sum) or t + p (a difference), and u is taken where
// the sum is at least p or the difference was negative
template <int N>
FG_INL void fo_addsub_n(Fg* r, const Fg* x, const Fg* y,
                        const uint32_t* neg, const Half& h) {
  Fg t[N], u[N];
  uint32_t g[N], ones[N], c0[N], cin[N], top[N], top2[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const uint32_t m = fg_mask(neg[q]);
    uint64_t c = 0;
#pragma unroll
    for (int v = 0; v < GW; ++v) {
      c += (uint64_t)x[q].w[v] + (y[q].w[v] ^ m);
      t[q].w[v] = (uint32_t)c;
      c >>= 32;
    }
    g[q] = (uint32_t)c;
    ones[q] = fg_all_ones(t[q]);
    c0[q] = neg[q];
  }
  fo_carry_in_n<N>(cin, top, g, ones, c0, h);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    fg_inc(t[q], cin[q]);
    const uint32_t m = fg_mask(neg[q]);
    uint64_t c = 0;
#pragma unroll
    for (int v = 0; v < GW; ++v) {   // + p, or + (2^384 - p) = ~p + 1
      c += (uint64_t)t[q].w[v] + (h.p[v] ^ ~m);
      u[q].w[v] = (uint32_t)c;
      c >>= 32;
    }
    g[q] = (uint32_t)c;
    ones[q] = fg_all_ones(u[q]);
    c0[q] = neg[q] ^ 1u;
  }
  fo_carry_in_n<N>(cin, top2, g, ones, c0, h);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    fg_inc(u[q], cin[q]);
    const uint32_t take = fg_mask((neg[q] & (top[q] ^ 1u)) |
                                  ((neg[q] ^ 1u) & top2[q]));
#pragma unroll
    for (int v = 0; v < GW; ++v)
      r[q].w[v] = (u[q].w[v] & take) | (t[q].w[v] & ~take);
  }
}

// c0 = x0 ± y0, c1 = x1 ± y1: x0 = a0 or a1, x1 = a1 or a0, y0 = b0 or
// b1, y1 = b1 or b0, the signs and sources from the mode's bits
// (ops/f12_group.py NEG0 ... Y1_B0), the sources picked by masks, both
// components' signed additions side by side
FO_OP void fo_lin(uint32_t w) {
  const Half h = fo_half();
  F2g x, y;
  fo_ld(x, fo_a(w));
  fo_ld(y, fo_b(w));
  const uint32_t mode = w >> 24;
  const uint32_t mx0 = fg_mask(mode >> 2 & 1u), mx1 = fg_mask(mode >> 3 & 1u);
  const uint32_t my0 = fg_mask(mode >> 4 & 1u), my1 = fg_mask(mode >> 5 & 1u);
  Fg u[2], t[2], r[2];
  const uint32_t neg[2] = {mode & 1u, mode >> 1 & 1u};
#pragma unroll
  for (int v = 0; v < GW; ++v) {
    u[0].w[v] = (x.c1.w[v] & mx0) | (x.c0.w[v] & ~mx0);
    u[1].w[v] = (x.c0.w[v] & mx1) | (x.c1.w[v] & ~mx1);
    t[0].w[v] = (y.c1.w[v] & my0) | (y.c0.w[v] & ~my0);
    t[1].w[v] = (y.c0.w[v] & my1) | (y.c1.w[v] & ~my1);
  }
  fo_addsub_n<2>(r, u, t, neg, h);
  x.c0 = r[0];
  x.c1 = r[1];
  fo_st(fo_d(w), x);
}

// (a0·b0, 0): the Fermat inversion's square and multiply
FO_OP void fo_fmul(uint32_t w) {
  const Half h = fo_half();
  F2g x, y;
  fo_ld(x, fo_a(w));
  fo_ld(y, fo_b(w));
  fg_mul(x.c0, x.c0, y.c0, h);
  fg_zero(x.c1);
  fo_st(fo_d(w), x);
}

// (a0² + a1², 0), the norm of a
FO_OP void fo_norm(uint32_t w) {
  const Half h = fo_half();
  F2g x;
  fo_ld(x, fo_a(w));
  Fg p[2] = {x.c0, x.c1}, n[2];
  fg_mul_n<2>(n, p, p, h);
  fg_add(x.c0, n[0], n[1], h);
  fg_zero(x.c1);
  fo_st(fo_d(w), x);
}

// (a0·t, -(a1·t)) with t = b0: conj(a) scaled, a^-1 when t = 1/norm(a)
FO_OP void fo_sclc(uint32_t w) {
  const Half h = fo_half();
  F2g x, y;
  fo_ld(x, fo_a(w));
  fo_ld(y, fo_b(w));
  Fg p[2] = {x.c0, x.c1}, q[2] = {y.c0, y.c0}, n[2];
  fg_mul_n<2>(n, p, q, h);
  x.c0 = n[0];
  fg_neg(x.c1, n[1], h);
  fo_st(fo_d(w), x);
}

// 1 iff the six slots from S hold the Fp12 one (the same answer on every
// half-group of the check): each thread compares its words of all six,
// one ballot, the half-group's bits
FO_OP uint32_t fo_is_one(uint32_t s) {
  const Half h = fo_half();
  const uint32_t k = h.k;
  uint32_t diff = 0u;
#pragma unroll 1
  for (uint32_t r = 0; r < 6; ++r) {
    F2g x;
    fo_ld(x, s + r);
    const uint32_t first = fg_mask(r == 0 ? 1u : 0u);
#pragma unroll
    for (int v = 0; v < GW; ++v)
      diff |= (x.c0.w[v] ^ (C.one.w[GW * k + v] & first)) | x.c1.w[v];
  }
  return fg_ballot(diff != 0u ? 1u : 0u, h) == 0u ? 1u : 0u;
}

// Run program PROG's steps: each half-group its own word of the step,
// the op the same for the warp, __syncwarp() after each step
FG_INL void fo_run(uint32_t prog) {
  const uint32_t hg = fo_hg();
  const uint32_t first = FS.prog[prog][0], end = first + FS.prog[prog][1];
#pragma unroll 1
  for (uint32_t s = first; s < end; ++s) {
    const uint32_t w = FS.slot[s][hg];
    switch (FS.op[s]) {
      case FO_MUL: fo_mul(w); break;
      case FO_SQR: fo_sqr(w); break;
      case FO_LIN: fo_lin(w); break;
      case FO_FMUL: fo_fmul(w); break;
      case FO_NORM: fo_norm(w); break;
      default: fo_sclc(w); break;
    }
    __syncwarp();
  }
}

// The zero and one slots (half-groups 0 and 1 write them)
FG_INL void fo_put_consts() {
  const uint32_t hg = fo_hg();
  F2g x;
  fg_zero(x.c0);
  fg_zero(x.c1);
  if (hg == 1) fg_slice(x.c0, C.one, fo_half());
  if (hg < 2) fo_st(FS.named[hg == 0 ? NM_ZERO : NM_ONE], x);
}
