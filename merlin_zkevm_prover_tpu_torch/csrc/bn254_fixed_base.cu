// Kernel B4: fixed-base scalar multiplication over G1 (Fq) and G2 (Fq2),
// [e_i] P for one base P and many scalars e_i (snark/curve.py
// scalar_mul_words; the Groth16 setup's point tables, fflonk's SRS).
//
// Replaces no TPU kernel: the JAX package runs snark/curve.py:269-312 as
// jnp lax.scans over 16-bit limbs.  Bound: operations (a mixed addition is
// 11 Montgomery products of 36 64-bit products in G1, three times that in
// G2); a scalar is 32 bytes, a point 96 or 192.
//
// bn_fixed_base: one thread per scalar over a table of affine points
// d 2^(w j) P that the wrapper builds once per base on the host
// (snark/curve.py fixed_base_table): signed w-bit digits, one inline mixed
// addition (pt_madd, 11 products) per nonzero digit, about 256 / w + 1 of
// them for a full scalar, against one complete addition (16 products, out
// of line) per set bit for the double-and-add scan.  The table (13,312
// points at w = 10: 852 KB in G1, 1.7 MB in G2) stays in L2.  Two threads
// a scalar, each half of the windows, were slower (PERF.md).  A
// source of its own so that it compiles beside B3.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define BN_FB_THREADS 128

// A signed-digit walk over a table of affine points tab[j * 2^(w-1) + d - 1]
// = d 2^(w j) P (d = 1 .. 2^(w-1), j < 256 / w + 1; x then y, Montgomery
// form; an x of all ones, which no canonical element has, marks infinity).
// Each thread recodes its scalar from the low window up: v = bits + carry,
// a digit v - 2^w with a carry of one where v > 2^(w-1), else v; then adds
// the table point of |digit|, y negated for a negative digit, by pt_madd.
// The accumulator starts as infinity (a flag) and takes the first point as
// it is; pt_madd's equal and opposite cases cover an accumulator that
// meets +-the point (a top window with the scalar near a multiple of the
// order).
template <class F>
__global__ void __launch_bounds__(BN_FB_THREADS)
bn_fixed_base_kernel(const uint64_t* __restrict__ table,
                     const uint64_t* __restrict__ scalars, long long n, int w,
                     uint64_t* __restrict__ out) {
    constexpr int N = PtWords<F>::N;
    constexpr int A = 2 * (N / 3);              // words of an affine entry
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint64_t s0 = scalars[4 * i], s1 = scalars[4 * i + 1],
             s2 = scalars[4 * i + 2], s3 = scalars[4 * i + 3];
    const uint64_t mask = (1ull << w) - 1;
    const uint64_t half = 1ull << (w - 1);
    const int n_win = 256 / w + 1;
    Pt<F> acc;
    bool inf = true;
    uint64_t carry = 0;
#pragma unroll 1
    for (int j = 0; j < n_win; ++j) {
        uint64_t v = (s0 & mask) + carry;
        s0 = (s0 >> w) | (s1 << (64 - w));
        s1 = (s1 >> w) | (s2 << (64 - w));
        s2 = (s2 >> w) | (s3 << (64 - w));
        s3 >>= w;
        carry = v > half;
        const bool neg = carry != 0;
        if (neg) v = (1ull << w) - v;
        if (v == 0) continue;
        const uint64_t* e = table + (long long)A * ((long long)j * half + v - 1);
        if (e[3] == ~0ull) continue;            // an infinity entry
        if (inf) {
            f_load(acc.x, e);
            f_load(acc.y, e + A / 2);
            if (neg) f_neg(acc.y, acc.y);
            f_set_one(acc.z);
            inf = false;
        } else {
            inf = pt_madd(acc, e, neg);
        }
    }
    if (inf) pt_inf(acc);
    pt_store(out + N * i, acc);
}

// table: the affine table of a base for windows of w bits (2 <= w <= 16)
extern "C" int merlin_bn_fixed_base(int g2, const void* table,
                                    const void* scalars, long long n, int w,
                                    void* out, void* stream) {
    if (n <= 0) return 0;
    if (w < 2 || w > 16) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((n + BN_FB_THREADS - 1) / BN_FB_THREADS);
    if (g2)
        bn_fixed_base_kernel<Fq2><<<blocks, BN_FB_THREADS, 0,
                                    (cudaStream_t)stream>>>(
            (const uint64_t*)table, (const uint64_t*)scalars, n, w, (uint64_t*)out);
    else
        bn_fixed_base_kernel<Fq><<<blocks, BN_FB_THREADS, 0,
                                   (cudaStream_t)stream>>>(
            (const uint64_t*)table, (const uint64_t*)scalars, n, w, (uint64_t*)out);
    return (int)cudaGetLastError();
}
