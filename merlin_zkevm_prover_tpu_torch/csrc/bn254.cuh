// BN254 (alt_bn128) Fq and Fr Montgomery arithmetic on four 64-bit limbs,
// Fq2 = Fq[u]/(u^2 + 1), and Jacobian points over Fq (G1) and Fq2 (G2).
//
// An element is uint64_t[4], little-endian, in Montgomery form with
// R = 2^256 (the port's (..., 4) int64 tensors hold the same words).
// "canonical" means [0, m).  Every function returns a canonical result and
// states the range of its inputs:
//   mont_mul<P>(r, a, b): a any value in [0, 2^256), b canonical.  CIOS:
//     each of the 4 rounds adds a_i * b and m * mod (m = t_0 * -mod^-1
//     mod 2^64) and drops a word; the sum stays below 2 * mod, so one
//     conditional subtract ends it.  36 64 x 64-bit products.
//   add_mod<P>, sub_mod<P>: a, b canonical.
// The 128-bit products and the carry chains are PTX (mad.lo.cc / madc.hi,
// add.cc / addc, sub.cc / subc), each chain inside one asm statement, where
// the carry flag is defined.
//
// Lazy reduction (B1's mixes): bn_mul_wide gives the 512-bit product of two
// 256-bit values, bn_add9 adds one into a 9-word sum, bn_redc9 reduces such
// a sum (below 2^514) once: (T + m * mod) / 2^256 for the m that clears the
// low words, then bn_reduce_256 brings any value below 2^256 into [0, mod)
// by conditional subtractions of 4 mod, 2 mod and mod (2^256 < 8 mod).
//
// bn_load / bn_store move an element by two 16-byte accesses;
// fr_pow_from_table starts a run of powers from a table of squarings.
//
// Points: Jacobian (X, Y, Z), Z = 0 is infinity (written (1, 1, 0) by
// pt_inf).  pt_add is complete as the reference's select form
// (snark/curve.py:184-212): infinity on either side, equal points (the
// doubling), opposite points (infinity).  pt_madd (B4) adds an affine point
// to a Jacobian one, inline: 11 products against pt_add's 16, complete but
// for infinity on the Jacobian side, which its caller keeps apart.
#pragma once
#include <stdint.h>

struct FqP {  // q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
    static constexpr uint64_t M0 = 0x3c208c16d87cfd47ull, M1 = 0x97816a916871ca8dull,
                              M2 = 0xb85045b68181585dull, M3 = 0x30644e72e131a029ull;
    static constexpr uint64_t NINV = 0x87d20782e4866389ull;  // -q^-1 mod 2^64
    static constexpr uint64_t R2_0 = 0xf32cfc5b538afa89ull, R2_1 = 0xb5e71911d44501fbull,
                              R2_2 = 0x47ab1eff0a417ff6ull, R2_3 = 0x06d89f71cab8351full;
    static constexpr uint64_t ONE0 = 0xd35d438dc58f0d9dull, ONE1 = 0x0a78eb28f5c70b3dull,
                              ONE2 = 0x666ea36f7879462cull, ONE3 = 0x0e0a77c19a07df2full;
};

struct FrP {  // r = 21888242871839275222246405745257275088548364400416034343698204186575808495617
    static constexpr uint64_t M0 = 0x43e1f593f0000001ull, M1 = 0x2833e84879b97091ull,
                              M2 = 0xb85045b68181585dull, M3 = 0x30644e72e131a029ull;
    static constexpr uint64_t NINV = 0xc2e1f593efffffffull;  // -r^-1 mod 2^64
    static constexpr uint64_t R2_0 = 0x1bb8e645ae216da7ull, R2_1 = 0x53fe3ab1e35c59e3ull,
                              R2_2 = 0x8c49833d53bb8085ull, R2_3 = 0x0216d0b17f4e44a5ull;
    static constexpr uint64_t ONE0 = 0xac96341c4ffffffbull, ONE1 = 0x36fc76959f60cd29ull,
                              ONE2 = 0x666ea36f7879462eull, ONE3 = 0x0e0a77c19a07df2full;
};

// a * b + c + d as (hi, lo); below 2^128 for any 64-bit a, b, c, d.
__device__ __forceinline__ uint64_t bn_madd(uint64_t a, uint64_t b, uint64_t c,
                                            uint64_t d, uint64_t& hi) {
    uint64_t lo, h;
    asm("{\n\t"
        "mad.lo.cc.u64 %0, %2, %3, %4;\n\t"
        "madc.hi.u64 %1, %2, %3, 0;\n\t"
        "add.cc.u64 %0, %0, %5;\n\t"
        "addc.u64 %1, %1, 0;\n\t"
        "}"
        : "=&l"(lo), "=&l"(h)
        : "l"(a), "l"(b), "l"(c), "l"(d));
    hi = h;
    return lo;
}

// r = a + b over 4 words; returns the carry out (0 or 1).
__device__ __forceinline__ uint64_t bn_add4(uint64_t* r, const uint64_t* a,
                                            const uint64_t* b) {
    uint64_t r0, r1, r2, r3, c;
    asm("{\n\t"
        "add.cc.u64 %0, %5, %9;\n\t"
        "addc.cc.u64 %1, %6, %10;\n\t"
        "addc.cc.u64 %2, %7, %11;\n\t"
        "addc.cc.u64 %3, %8, %12;\n\t"
        "addc.u64 %4, 0, 0;\n\t"
        "}"
        : "=&l"(r0), "=&l"(r1), "=&l"(r2), "=&l"(r3), "=&l"(c)
        : "l"(a[0]), "l"(a[1]), "l"(a[2]), "l"(a[3]),
          "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]));
    r[0] = r0; r[1] = r1; r[2] = r2; r[3] = r3;
    return c;
}

// r = a - b over 4 words; returns 0, or all ones after a borrow.
__device__ __forceinline__ uint64_t bn_sub4(uint64_t* r, const uint64_t* a,
                                            const uint64_t* b) {
    uint64_t r0, r1, r2, r3, br;
    asm("{\n\t"
        "sub.cc.u64 %0, %5, %9;\n\t"
        "subc.cc.u64 %1, %6, %10;\n\t"
        "subc.cc.u64 %2, %7, %11;\n\t"
        "subc.cc.u64 %3, %8, %12;\n\t"
        "subc.u64 %4, 0, 0;\n\t"
        "}"
        : "=&l"(r0), "=&l"(r1), "=&l"(r2), "=&l"(r3), "=&l"(br)
        : "l"(a[0]), "l"(a[1]), "l"(a[2]), "l"(a[3]),
          "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]));
    r[0] = r0; r[1] = r1; r[2] = r2; r[3] = r3;
    return br;
}

template <class P>
__device__ __forceinline__ void bn_mod(uint64_t* m) {
    m[0] = P::M0; m[1] = P::M1; m[2] = P::M2; m[3] = P::M3;
}

template <class P>
__device__ __forceinline__ void bn_one(uint64_t* r) {
    r[0] = P::ONE0; r[1] = P::ONE1; r[2] = P::ONE2; r[3] = P::ONE3;
}

template <class P>
__device__ __forceinline__ void bn_r2(uint64_t* r) {
    r[0] = P::R2_0; r[1] = P::R2_1; r[2] = P::R2_2; r[3] = P::R2_3;
}

__device__ __forceinline__ void bn_copy(uint64_t* r, const uint64_t* a) {
    r[0] = a[0]; r[1] = a[1]; r[2] = a[2]; r[3] = a[3];
}

__device__ __forceinline__ void bn_zero(uint64_t* r) {
    r[0] = 0; r[1] = 0; r[2] = 0; r[3] = 0;
}

__device__ __forceinline__ bool bn_is_zero(const uint64_t* a) {
    return (a[0] | a[1] | a[2] | a[3]) == 0;
}

__device__ __forceinline__ bool bn_eq(const uint64_t* a, const uint64_t* b) {
    return ((a[0] ^ b[0]) | (a[1] ^ b[1]) | (a[2] ^ b[2]) | (a[3] ^ b[3])) == 0;
}

// in: t = (t4, t3..t0) below 2 * mod.  out: canonical.
template <class P>
__device__ __forceinline__ void bn_reduce_once(uint64_t* r, const uint64_t* t,
                                               uint64_t t4) {
    uint64_t m[4], d[4];
    bn_mod<P>(m);
    uint64_t br = bn_sub4(d, t, m);
    if (t4 != 0 || br == 0) bn_copy(r, d);
    else bn_copy(r, t);
}

// in: a any value in [0, 2^256), b canonical.  out: a * b / 2^256 mod m,
// canonical.  r may alias a or b.
template <class P>
__device__ __forceinline__ void mont_mul(uint64_t* r, const uint64_t* a,
                                         const uint64_t* b) {
    const uint64_t b0 = b[0], b1 = b[1], b2 = b[2], b3 = b[3];
    uint64_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint64_t ai = a[i];
        uint64_t c;
        t0 = bn_madd(ai, b0, t0, 0, c);
        t1 = bn_madd(ai, b1, t1, c, c);
        t2 = bn_madd(ai, b2, t2, c, c);
        t3 = bn_madd(ai, b3, t3, c, c);
        uint64_t s = t4 + c;
        const uint64_t t5 = s < c;
        t4 = s;
        const uint64_t m = t0 * P::NINV;
        (void)bn_madd(m, P::M0, t0, 0, c);  // the low word is 0 by m's choice
        t0 = bn_madd(m, P::M1, t1, c, c);
        t1 = bn_madd(m, P::M2, t2, c, c);
        t2 = bn_madd(m, P::M3, t3, c, c);
        s = t4 + c;
        t3 = s;
        t4 = t5 + (s < c);
    }
    const uint64_t t[4] = {t0, t1, t2, t3};
    bn_reduce_once<P>(r, t, t4);
}

// in: a, b canonical.  out: a + b mod m.
template <class P>
__device__ __forceinline__ void add_mod(uint64_t* r, const uint64_t* a,
                                        const uint64_t* b) {
    uint64_t s[4];
    uint64_t c = bn_add4(s, a, b);
    bn_reduce_once<P>(r, s, c);
}

// in: a, b canonical.  out: a - b mod m.
template <class P>
__device__ __forceinline__ void sub_mod(uint64_t* r, const uint64_t* a,
                                        const uint64_t* b) {
    uint64_t d[4];
    uint64_t br = bn_sub4(d, a, b);
    if (br != 0) {
        uint64_t m[4];
        bn_mod<P>(m);
        (void)bn_add4(d, d, m);  // wraps back into [0, m)
    }
    bn_copy(r, d);
}

// r -= k * mod if r >= k * mod, for k * mod < 2^256 (k = 1, 2, 4)
template <class P, int K>
__device__ __forceinline__ void bn_csub_mod(uint64_t* r) {
    constexpr int s = K == 4 ? 2 : K == 2 ? 1 : 0;
    uint64_t m[4], d[4];
    m[0] = P::M0 << s;
    m[1] = s ? (P::M1 << s) | (P::M0 >> (64 - s)) : P::M1;
    m[2] = s ? (P::M2 << s) | (P::M1 >> (64 - s)) : P::M2;
    m[3] = s ? (P::M3 << s) | (P::M2 >> (64 - s)) : P::M3;
    if (bn_sub4(d, r, m) == 0) bn_copy(r, d);
}

// in: any value in [0, 2^256).  out: the value mod m, without branches that
// depend on how many subtractions a value needs.
template <class P>
__device__ __forceinline__ void bn_reduce_256(uint64_t* r) {
    bn_csub_mod<P, 4>(r);
    bn_csub_mod<P, 2>(r);
    bn_csub_mod<P, 1>(r);
}

// p (8 words) = a * b, a and b any values below 2^256
__device__ __forceinline__ void bn_mul_wide(uint64_t* p, const uint64_t* a,
                                            const uint64_t* b) {
    uint64_t c;
    p[0] = bn_madd(a[0], b[0], 0, 0, c);
    p[1] = bn_madd(a[0], b[1], c, 0, c);
    p[2] = bn_madd(a[0], b[2], c, 0, c);
    p[3] = bn_madd(a[0], b[3], c, 0, c);
    p[4] = c;
#pragma unroll
    for (int i = 1; i < 4; ++i) {
        p[i] = bn_madd(a[i], b[0], p[i], 0, c);
        p[i + 1] = bn_madd(a[i], b[1], p[i + 1], c, c);
        p[i + 2] = bn_madd(a[i], b[2], p[i + 2], c, c);
        p[i + 3] = bn_madd(a[i], b[3], p[i + 3], c, c);
        p[i + 4] = c;
    }
}

// acc (9 words) += p (8 words)
__device__ __forceinline__ void bn_add9(uint64_t* acc, const uint64_t* p) {
    asm("{\n\t"
        "add.cc.u64 %0, %0, %9;\n\t"
        "addc.cc.u64 %1, %1, %10;\n\t"
        "addc.cc.u64 %2, %2, %11;\n\t"
        "addc.cc.u64 %3, %3, %12;\n\t"
        "addc.cc.u64 %4, %4, %13;\n\t"
        "addc.cc.u64 %5, %5, %14;\n\t"
        "addc.cc.u64 %6, %6, %15;\n\t"
        "addc.cc.u64 %7, %7, %16;\n\t"
        "addc.u64 %8, %8, 0;\n\t"
        "}"
        : "+l"(acc[0]), "+l"(acc[1]), "+l"(acc[2]), "+l"(acc[3]),
          "+l"(acc[4]), "+l"(acc[5]), "+l"(acc[6]), "+l"(acc[7]),
          "+l"(acc[8])
        : "l"(p[0]), "l"(p[1]), "l"(p[2]), "l"(p[3]), "l"(p[4]), "l"(p[5]),
          "l"(p[6]), "l"(p[7]));
}

// in: t (9 words, clobbered) with t / 2^256 + mod < 2^256 (a sum of up to
// 17 products of canonical values: t / 2^256 + mod < 4.2 mod).  out:
// t / 2^256 mod m, canonical.  20 64-bit products, once for a whole sum.
template <class P>
__device__ __forceinline__ void bn_redc9(uint64_t* r, uint64_t* t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint64_t m = t[i] * P::NINV;
        uint64_t c;
        (void)bn_madd(m, P::M0, t[i], 0, c);  // the low word is 0 by m's choice
        t[i + 1] = bn_madd(m, P::M1, t[i + 1], c, c);
        t[i + 2] = bn_madd(m, P::M2, t[i + 2], c, c);
        t[i + 3] = bn_madd(m, P::M3, t[i + 3], c, c);
#pragma unroll
        for (int k = i + 4; k < 9; ++k) {
            t[k] += c;
            c = t[k] < c;
        }
    }
    r[0] = t[4]; r[1] = t[5]; r[2] = t[6]; r[3] = t[7];  // t[8] is 0
    bn_reduce_256<P>(r);
}

// r = the element at p, by two 16-byte loads (p 16-byte aligned, read-only
// for the kernel's whole run)
__device__ __forceinline__ void bn_load(uint64_t* r, const uint64_t* p) {
    const ulonglong2 lo = __ldg(reinterpret_cast<const ulonglong2*>(p));
    const ulonglong2 hi = __ldg(reinterpret_cast<const ulonglong2*>(p) + 1);
    r[0] = lo.x; r[1] = lo.y; r[2] = hi.x; r[3] = hi.y;
}

// the element a at p, by two 16-byte stores (p 16-byte aligned)
__device__ __forceinline__ void bn_store(uint64_t* p, const uint64_t* a) {
    reinterpret_cast<ulonglong2*>(p)[0] = make_ulonglong2(a[0], a[1]);
    reinterpret_cast<ulonglong2*>(p)[1] = make_ulonglong2(a[2], a[3]);
}

// x = start * base^j0 from sq[i] = base^(2^i) (all Montgomery over Fr): the
// first power of a run, one product a set bit of j0 (B2's powers and
// poly_eval, F3's X)
__device__ __forceinline__ void fr_pow_from_table(uint64_t* x,
                                                  const uint64_t* start,
                                                  const uint64_t* sq,
                                                  long long j0) {
    bn_copy(x, start);
#pragma unroll 1
    for (int i = 0; (j0 >> i) != 0; ++i)
        if ((j0 >> i) & 1) mont_mul<FrP>(x, x, sq + 4 * i);
}

// ---------------------------------------------------------------------------
// Base fields of the curves: Fq (G1) and Fq2 (G2)
// ---------------------------------------------------------------------------

struct Fq {
    uint64_t v[4];
};

struct Fq2 {
    uint64_t c0[4], c1[4];
};

__device__ __forceinline__ void f_mul(Fq& r, const Fq& a, const Fq& b) { mont_mul<FqP>(r.v, a.v, b.v); }
__device__ __forceinline__ void f_add(Fq& r, const Fq& a, const Fq& b) { add_mod<FqP>(r.v, a.v, b.v); }
__device__ __forceinline__ void f_sub(Fq& r, const Fq& a, const Fq& b) { sub_mod<FqP>(r.v, a.v, b.v); }
__device__ __forceinline__ bool f_is_zero(const Fq& a) { return bn_is_zero(a.v); }
__device__ __forceinline__ void f_set_zero(Fq& r) { bn_zero(r.v); }
__device__ __forceinline__ void f_set_one(Fq& r) { bn_one<FqP>(r.v); }
__device__ __forceinline__ void f_neg(Fq& r, const Fq& a) {
    const uint64_t zero[4] = {0, 0, 0, 0};
    sub_mod<FqP>(r.v, zero, a.v);
}
__device__ __forceinline__ void f_load(Fq& r, const uint64_t* p) { bn_copy(r.v, p); }
__device__ __forceinline__ void f_store(uint64_t* p, const Fq& a) { bn_copy(p, a.v); }

// Karatsuba with u^2 = -1, as the reference's F2.mul.
__device__ __forceinline__ void f_mul(Fq2& r, const Fq2& a, const Fq2& b) {
    uint64_t t0[4], t1[4], sa[4], sb[4], t2[4];
    mont_mul<FqP>(t0, a.c0, b.c0);
    mont_mul<FqP>(t1, a.c1, b.c1);
    add_mod<FqP>(sa, a.c0, a.c1);
    add_mod<FqP>(sb, b.c0, b.c1);
    mont_mul<FqP>(t2, sa, sb);
    sub_mod<FqP>(r.c0, t0, t1);
    sub_mod<FqP>(t2, t2, t0);
    sub_mod<FqP>(r.c1, t2, t1);
}
__device__ __forceinline__ void f_add(Fq2& r, const Fq2& a, const Fq2& b) {
    add_mod<FqP>(r.c0, a.c0, b.c0);
    add_mod<FqP>(r.c1, a.c1, b.c1);
}
__device__ __forceinline__ void f_sub(Fq2& r, const Fq2& a, const Fq2& b) {
    sub_mod<FqP>(r.c0, a.c0, b.c0);
    sub_mod<FqP>(r.c1, a.c1, b.c1);
}
__device__ __forceinline__ bool f_is_zero(const Fq2& a) {
    return bn_is_zero(a.c0) && bn_is_zero(a.c1);
}
__device__ __forceinline__ void f_neg(Fq2& r, const Fq2& a) {
    const uint64_t zero[4] = {0, 0, 0, 0};
    sub_mod<FqP>(r.c0, zero, a.c0);
    sub_mod<FqP>(r.c1, zero, a.c1);
}
__device__ __forceinline__ void f_set_zero(Fq2& r) { bn_zero(r.c0); bn_zero(r.c1); }
__device__ __forceinline__ void f_set_one(Fq2& r) { bn_one<FqP>(r.c0); bn_zero(r.c1); }
__device__ __forceinline__ void f_load(Fq2& r, const uint64_t* p) {
    bn_copy(r.c0, p);
    bn_copy(r.c1, p + 4);
}
__device__ __forceinline__ void f_store(uint64_t* p, const Fq2& a) {
    bn_copy(p, a.c0);
    bn_copy(p + 4, a.c1);
}

template <class F>
struct Pt {
    F x, y, z;
};

// words of one point in memory: x, y, z one after the other
template <class F> struct PtWords;
template <> struct PtWords<Fq> { static constexpr int N = 12; };
template <> struct PtWords<Fq2> { static constexpr int N = 24; };

template <class F>
__device__ __forceinline__ void pt_load(Pt<F>& p, const uint64_t* src) {
    constexpr int W = PtWords<F>::N / 3;
    f_load(p.x, src);
    f_load(p.y, src + W);
    f_load(p.z, src + 2 * W);
}

template <class F>
__device__ __forceinline__ void pt_store(uint64_t* dst, const Pt<F>& p) {
    constexpr int W = PtWords<F>::N / 3;
    f_store(dst, p.x);
    f_store(dst + W, p.y);
    f_store(dst + 2 * W, p.z);
}

template <class F>
__device__ __forceinline__ void pt_inf(Pt<F>& p) {
    f_set_one(p.x);
    f_set_one(p.y);
    f_set_zero(p.z);
}

// -p: (X, -Y, Z)
template <class F>
__device__ __forceinline__ void pt_neg(Pt<F>& r, const Pt<F>& p) {
    F zero;
    f_set_zero(zero);
    r.x = p.x;
    f_sub(r.y, zero, p.y);
    r.z = p.z;
}

// dbl-2009-l, the reference's double (curve.py:166-181).  Not inlined: one
// copy a field keeps the point kernels small enough to compile in seconds.
template <class F>
__device__ __noinline__ void pt_dbl(Pt<F>& r, const Pt<F>& p) {
    if (f_is_zero(p.z)) {
        r = p;
        return;
    }
    F a, b, c, t, d, e, f, x3, y3, z3;
    f_mul(a, p.x, p.x);
    f_mul(b, p.y, p.y);
    f_mul(c, b, b);
    f_add(t, p.x, b);
    f_mul(t, t, t);
    f_sub(t, t, a);
    f_sub(t, t, c);
    f_add(d, t, t);
    f_add(e, a, a);
    f_add(e, e, a);
    f_mul(f, e, e);
    f_add(x3, d, d);
    f_sub(x3, f, x3);
    f_add(c, c, c);
    f_add(c, c, c);
    f_add(c, c, c);
    f_sub(t, d, x3);
    f_mul(y3, e, t);
    f_sub(y3, y3, c);
    f_mul(z3, p.y, p.z);
    f_add(z3, z3, z3);
    r.x = x3;
    r.y = y3;
    r.z = z3;
}

// add-2007-bl with the reference's case selects (curve.py:184-212).  Not
// inlined, as pt_dbl.
template <class F>
__device__ __noinline__ void pt_add(Pt<F>& r, const Pt<F>& p, const Pt<F>& q) {
    if (f_is_zero(p.z)) {
        r = q;
        return;
    }
    if (f_is_zero(q.z)) {
        r = p;
        return;
    }
    F z1z1, z2z2, u1, u2, s1, s2, h, rr;
    f_mul(z1z1, p.z, p.z);
    f_mul(z2z2, q.z, q.z);
    f_mul(u1, p.x, z2z2);
    f_mul(u2, q.x, z1z1);
    f_mul(s1, p.y, q.z);
    f_mul(s1, s1, z2z2);
    f_mul(s2, q.y, p.z);
    f_mul(s2, s2, z1z1);
    f_sub(h, u2, u1);
    f_sub(rr, s2, s1);
    if (f_is_zero(h)) {
        if (f_is_zero(rr)) pt_dbl(r, p);
        else pt_inf(r);
        return;
    }
    F hh, hhh, v, x3, y3, z3, t;
    f_mul(hh, h, h);
    f_mul(hhh, h, hh);
    f_mul(v, u1, hh);
    f_mul(x3, rr, rr);
    f_sub(x3, x3, hhh);
    f_sub(x3, x3, v);
    f_sub(x3, x3, v);
    f_sub(t, v, x3);
    f_mul(y3, rr, t);
    f_mul(t, s1, hhh);
    f_sub(y3, y3, t);
    f_mul(z3, p.z, q.z);
    f_mul(z3, z3, h);
    r.x = x3;
    r.y = y3;
    r.z = z3;
}

// The doubling of pt_dbl (dbl-2009-l), for B4's rare case of an
// accumulator equal to the point it adds: out of line and by value, so
// that its temporaries do not count against the walk's registers and the
// point needs no address (pt_dbl stays as it is for B3).  p is not
// infinity.
template <class F>
__device__ __noinline__ Pt<F> pt_dbl_value(Pt<F> p) {
    F a, b, c, t, d, e, f;
    f_mul(a, p.x, p.x);
    f_mul(b, p.y, p.y);
    f_mul(c, b, b);
    f_add(t, p.x, b);
    f_mul(t, t, t);
    f_sub(t, t, a);
    f_sub(t, t, c);
    f_add(d, t, t);
    f_add(e, a, a);
    f_add(e, e, a);
    f_mul(f, e, e);
    f_mul(p.z, p.y, p.z);
    f_add(p.z, p.z, p.z);
    f_add(p.x, d, d);
    f_sub(p.x, f, p.x);
    f_add(c, c, c);
    f_add(c, c, c);
    f_add(c, c, c);
    f_sub(t, d, p.x);
    f_mul(p.y, e, t);
    f_sub(p.y, p.y, c);
    return p;
}

// p += (x2, +-y2), the affine point at e (x2 then y2, Montgomery form),
// y2 negated where neg (madd-2004-hmv: 8 products and 3 squarings), in
// place and inline; x2 and y2 are read where they are first used, so that
// neither is live across the other's products.  p is not infinity.
// Complete: p equal to the point gives the doubling, p opposite to it
// infinity.  Returns true when the sum is infinity (p is then left as it
// was).
template <class F>
__device__ __forceinline__ bool pt_madd(Pt<F>& p, const uint64_t* e, bool neg) {
    constexpr int W = PtWords<F>::N / 3;
    F t1, t2;
    f_mul(t1, p.z, p.z);        // Z1^2
    f_mul(t2, t1, p.z);         // Z1^3
    {
        F x2;
        f_load(x2, e);
        f_mul(t1, t1, x2);      // U2 = x2 Z1^2
    }
    {
        F y2;
        f_load(y2, e + W);
        if (neg) f_neg(y2, y2);
        f_mul(t2, t2, y2);      // S2 = y2 Z1^3
    }
    f_sub(t1, t1, p.x);         // H = U2 - X1
    f_sub(t2, t2, p.y);         // R = S2 - Y1
    if (f_is_zero(t1)) {
        if (f_is_zero(t2)) {
            p = pt_dbl_value(p);
            return false;
        }
        return true;
    }
    F t3, t4;
    f_mul(p.z, p.z, t1);        // Z3 = Z1 H
    f_mul(t4, t1, t1);          // H^2
    f_mul(t3, t4, t1);          // H^3
    f_mul(t4, t4, p.x);         // V = X1 H^2
    f_mul(p.x, t2, t2);         // R^2
    f_sub(p.x, p.x, t3);
    f_sub(p.x, p.x, t4);
    f_sub(p.x, p.x, t4);        // X3 = R^2 - H^3 - 2 V
    f_sub(t4, t4, p.x);
    f_mul(t4, t2, t4);          // R (V - X3)
    f_mul(t3, p.y, t3);         // Y1 H^3
    f_sub(p.y, t4, t3);         // Y3
    return false;
}
