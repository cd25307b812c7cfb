// Goldilocks field (p = 2^64 - 2^32 + 1) device arithmetic on uint64_t.
//
// Range discipline: every function states the range of its inputs and of its
// result.  "canonical" means [0, p); "lazy" means any word in [0, 2^64),
// congruent mod p to the value it stands for.  gl_add, gl_sub, gl_mul,
// gl_sqr and gl_pow7 return canonical results, so the add/sub carry chains
// (exact only below p) never see a residue in [p, 2^64).  The *_lazy
// helpers at the end return lazy words; they feed only functions whose
// stated input range is any word (gl_mul, the *_lazy helpers themselves,
// gl_canon), never gl_add or gl_sub.
#pragma once
#include <stdint.h>

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL  // 2^64 mod p

// in: any word in [0, 2^64).  out: canonical.  2^64 - p < p, so one
// conditional subtract is enough.
__device__ __forceinline__ uint64_t gl_canon(uint64_t x) {
    return x >= GL_P ? x - GL_P : x;
}

// in: a, b canonical.  out: canonical.
// a + b < 2p; on carry the wrapped sum is < 2^64 - 2^33 + 2, so adding
// EPS (= 2^64 mod p) cannot wrap again.
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a) s += GL_EPS;
    return gl_canon(s);
}

// in: a, b canonical.  out: canonical.
// On borrow the true value is wrapped - 2^64 + p = wrapped - EPS; the
// wrapped word is >= 2^64 - p + 1 > EPS there, so no second borrow, and the
// result a - b + p lies in (0, p).
__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
    uint64_t d = a - b;
    if (a < b) d -= GL_EPS;
    return d;
}

// in: (lo, hi) any 128-bit value lo + 2^64 * hi.  out: canonical.
// 2^64 = EPS and 2^96 = -1 (mod p):
//   x = lo - hi_hi + hi_lo * EPS,   hi = hi_hi * 2^32 + hi_lo.
__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
    uint64_t hi_hi = hi >> 32;
    uint64_t hi_lo = hi & 0xFFFFFFFFULL;
    uint64_t t0 = lo - hi_hi;
    // borrow: add p = 2^64 - EPS, i.e. subtract EPS from the wrapped word,
    // which is >= 2^64 - 2^32 + 1 > EPS: no second borrow
    if (lo < hi_hi) t0 -= GL_EPS;
    uint64_t t1 = (hi_lo << 32) - hi_lo;  // hi_lo * EPS <= (2^32-1)^2
    uint64_t s = t0 + t1;
    // carry: the wrapped sum is < t1 <= 2^64 - 2^33 + 1, so + EPS fits
    if (s < t0) s += GL_EPS;
    return gl_canon(s);
}

// in: a, b any words in [0, 2^64).  out: canonical.
__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
    return gl_reduce128(a * b, __umul64hi(a, b));
}

// in: any word.  out: canonical.
__device__ __forceinline__ uint64_t gl_sqr(uint64_t a) { return gl_mul(a, a); }

// in: any word.  out: canonical a^7.
__device__ __forceinline__ uint64_t gl_pow7(uint64_t a) {
    uint64_t a2 = gl_sqr(a);
    uint64_t a3 = gl_mul(a2, a);
    uint64_t a4 = gl_sqr(a2);
    return gl_mul(a3, a4);
}

// ---------------------------------------------------------------------------
// Lazy helpers (the Poseidon body keeps words lazy between rounds and
// canonicalises once at the end; the NTT's decimation-in-time butterflies
// keep the sums lazy and canonicalise on the way out).
// ---------------------------------------------------------------------------

// in: (lo, hi) any 128-bit value.  out: lazy.
// gl_reduce128 without its final gl_canon; its comments prove that t0 and s
// neither borrow nor carry twice, so s is a word congruent to lo + 2^64 hi.
__device__ __forceinline__ uint64_t gl_reduce128_lazy(uint64_t lo, uint64_t hi) {
    uint64_t hi_hi = hi >> 32;
    uint64_t hi_lo = hi & 0xFFFFFFFFULL;
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= GL_EPS;
    uint64_t t1 = (hi_lo << 32) - hi_lo;
    uint64_t s = t0 + t1;
    if (s < t0) s += GL_EPS;
    return s;
}

// in: lo any word, hi < 2^32.  out: lazy, congruent to lo + 2^64 hi.
// gl_reduce128_lazy with hi_hi = 0: t1 = hi * EPS <= (2^32-1)^2 =
// 2^64 - 2^33 + 1; on carry the wrapped sum is < t1, so adding EPS cannot
// carry again.
__device__ __forceinline__ uint64_t gl_reduce96_lazy(uint64_t lo, uint32_t hi) {
    uint64_t t1 = ((uint64_t)hi << 32) - hi;
    uint64_t s = lo + t1;
    if (s < t1) s += GL_EPS;
    return s;
}

// in: a any word, c canonical.  out: lazy, congruent to a + c.
// On carry the wrapped sum is a + c - 2^64 <= c - 1 < p - 1, and
// p - 1 + EPS = 2^64 - 1, so adding EPS cannot carry again.
__device__ __forceinline__ uint64_t gl_add_lazy(uint64_t a, uint64_t c) {
    uint64_t s = a + c;
    if (s < c) s += GL_EPS;
    return s;
}

// in: a any word, c canonical.  out: lazy, congruent to a - c.
// On borrow the wrapped difference is a - c + 2^64 >= 2^64 - c > 2^64 - p
// = EPS, and a - c + 2^64 - EPS is congruent to a - c, so subtracting EPS
// cannot borrow again.
__device__ __forceinline__ uint64_t gl_sub_lazy(uint64_t a, uint64_t c) {
    uint64_t d = a - c;
    if (a < c) d -= GL_EPS;
    return d;
}

// in: a, b any words.  out: lazy a * b.  (A 128-bit product from one chain
// of 32 x 32 -> 64 bit partial products, three for a square, compiles to
// more SASS instructions than a * b with __umul64hi and runs slower on the
// card: tools/sass_count.py, PERF.md.)
__device__ __forceinline__ uint64_t gl_mul_lazy(uint64_t a, uint64_t b) {
    return gl_reduce128_lazy(a * b, __umul64hi(a, b));
}

// in: a any word.  out: lazy a^2.
__device__ __forceinline__ uint64_t gl_sqr_lazy(uint64_t a) {
    return gl_mul_lazy(a, a);
}

// in: a any word.  out: lazy a^7 = a^3 * a^4.
__device__ __forceinline__ uint64_t gl_pow7_lazy(uint64_t a) {
    uint64_t a2 = gl_sqr_lazy(a);
    uint64_t a3 = gl_mul_lazy(a2, a);
    uint64_t a4 = gl_sqr_lazy(a2);
    return gl_mul_lazy(a3, a4);
}

// ---------------------------------------------------------------------------
// Canonical negation and the cubic extension GF(p^3) = GF(p)[x] / (x^3 - x - 1)
// (the port's ops/goldilocks3.py).  Every input and every result canonical.
// ---------------------------------------------------------------------------

// in: a canonical.  out: canonical -a.
__device__ __forceinline__ uint64_t gl_neg(uint64_t a) { return a ? GL_P - a : 0; }

struct gl3_t {
    uint64_t c0, c1, c2;
};

__device__ __forceinline__ gl3_t gl3_add(gl3_t a, gl3_t b) {
    return {gl_add(a.c0, b.c0), gl_add(a.c1, b.c1), gl_add(a.c2, b.c2)};
}

__device__ __forceinline__ gl3_t gl3_sub(gl3_t a, gl3_t b) {
    return {gl_sub(a.c0, b.c0), gl_sub(a.c1, b.c1), gl_sub(a.c2, b.c2)};
}

__device__ __forceinline__ gl3_t gl3_neg(gl3_t a) {
    return {gl_neg(a.c0), gl_neg(a.c1), gl_neg(a.c2)};
}

// The six-product Karatsuba form of ops/goldilocks3.py mul (the reference's
// mulAddElement_adim3): with x^3 = x + 1,
//   c0 = C + (D - E) - F,  c1 = A + C - 2E - D,  c2 = B - (D - E).
__device__ __forceinline__ gl3_t gl3_mul(gl3_t a, gl3_t b) {
    const uint64_t A = gl_mul(gl_add(a.c0, a.c1), gl_add(b.c0, b.c1));
    const uint64_t B = gl_mul(gl_add(a.c0, a.c2), gl_add(b.c0, b.c2));
    const uint64_t C = gl_mul(gl_add(a.c1, a.c2), gl_add(b.c1, b.c2));
    const uint64_t D = gl_mul(a.c0, b.c0);
    const uint64_t E = gl_mul(a.c1, b.c1);
    const uint64_t F = gl_mul(a.c2, b.c2);
    const uint64_t G = gl_sub(D, E);
    return {gl_sub(gl_add(C, G), F),
            gl_sub(gl_sub(gl_sub(gl_add(A, C), E), E), D),
            gl_sub(B, G)};
}

// A base value times an extension value: three products, the Karatsuba form
// above with a = (s, 0, 0).
__device__ __forceinline__ gl3_t gl3_scale(uint64_t s, gl3_t b) {
    return {gl_mul(s, b.c0), gl_mul(s, b.c1), gl_mul(s, b.c2)};
}
