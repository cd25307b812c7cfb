// Kernel B3's range sums and the conversion of its bases to affine form
// (the MSM's other launches are in bn254_msm.cu; a source of its own, so
// that the two compile side by side).
//
// Replaces no TPU kernel (the JAX package sums buckets and converts points
// in jnp lax.scans over 16-bit limbs).  Bound: operations.
//
//   bn_sum_ranges: one thread per range of at most 32 (points) or 256 (Fr)
//     positions: the sum of their values (read through an index array, or
//     contiguous).  Over Jacobian points it joins an MSM
//     bucket's range sums (snark/msm.py sum_by_key); over Fr it sums the
//     Groth16 setup's coefficient products by signal and the prover's by
//     constraint.
//   bn_to_affine: one thread a chunk of points: Montgomery's batch
//     inversion of their Z (prefix products kept in the output's x words,
//     one Fermat inversion a chunk, then back down: three products a
//     point), x = X / Z^2 and y = Y / Z^3; a point at infinity (Z = 0) is
//     left out of the products and written as an x of all ones (no
//     canonical element has it) and a y of zeros.  The Groth16 key's
//     points and fflonk's SRS are made affine once, where they are made.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define BN_SUMS_THREADS 128
#define BN_AFFINE_CHUNK 64

static inline unsigned sums_blocks(long long n) {
    return (unsigned)((n + BN_SUMS_THREADS - 1) / BN_SUMS_THREADS);
}

// An element of a range sum: an Fr value or a point, with its identity
// (0, infinity), load, store and addition.
struct FrEl {
    uint64_t v[4];
};
template <class E> struct ElWords;
template <> struct ElWords<FrEl> { static constexpr int N = 4; };
template <class F> struct ElWords<Pt<F>> { static constexpr int N = PtWords<F>::N; };

__device__ __forceinline__ void el_zero(FrEl& a) { bn_zero(a.v); }
__device__ __forceinline__ void el_load(FrEl& a, const uint64_t* p) { bn_copy(a.v, p); }
__device__ __forceinline__ void el_store(uint64_t* p, const FrEl& a) { bn_copy(p, a.v); }
// a, b < r
__device__ __forceinline__ void el_add(FrEl& r, const FrEl& a, const FrEl& b) {
    add_mod<FrP>(r.v, a.v, b.v);
}
template <class F>
__device__ __forceinline__ void el_zero(Pt<F>& a) { pt_inf(a); }
template <class F>
__device__ __forceinline__ void el_load(Pt<F>& a, const uint64_t* p) { pt_load(a, p); }
template <class F>
__device__ __forceinline__ void el_store(uint64_t* p, const Pt<F>& a) { pt_store(p, a); }
template <class F>
__device__ __forceinline__ void el_add(Pt<F>& r, const Pt<F>& a, const Pt<F>& b) {
    pt_add(r, a, b);
}

template <class E>
__global__ void bn_sum_ranges_kernel(const uint64_t* __restrict__ vals,
                                     const long long* __restrict__ idx,
                                     const long long* __restrict__ starts,
                                     const long long* __restrict__ counts,
                                     long long n_ranges, uint64_t* __restrict__ out) {
    constexpr int N = ElWords<E>::N;
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_ranges) return;
    E acc, x;
    el_zero(acc);
    const long long s = starts[r];
#pragma unroll 1
    for (long long k = s; k < s + counts[r]; ++k) {
        const long long j = idx != nullptr ? idx[k] : k;
        el_load(x, vals + N * j);
        el_add(acc, acc, x);
    }
    el_store(out + N * r, acc);
}

// a^(q - 2) = 1 / a over Fq (a nonzero, Montgomery form in and out)
__device__ __noinline__ void fq_inv(uint64_t* r, const uint64_t* a) {
    const uint64_t e[4] = {FqP::M0 - 2, FqP::M1, FqP::M2, FqP::M3};
    uint64_t acc[4];
    bn_one<FqP>(acc);
#pragma unroll 1
    for (int i = 3; i >= 0; --i) {
#pragma unroll 1
        for (int b = 63; b >= 0; --b) {
            mont_mul<FqP>(acc, acc, acc);
            if ((e[i] >> b) & 1) mont_mul<FqP>(acc, acc, a);
        }
    }
    bn_copy(r, acc);
}

__device__ __forceinline__ void f_inv(Fq& r, const Fq& a) { fq_inv(r.v, a.v); }

// 1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
__device__ __forceinline__ void f_inv(Fq2& r, const Fq2& a) {
    uint64_t n0[4], n1[4];
    mont_mul<FqP>(n0, a.c0, a.c0);
    mont_mul<FqP>(n1, a.c1, a.c1);
    add_mod<FqP>(n0, n0, n1);
    fq_inv(n1, n0);
    mont_mul<FqP>(r.c0, a.c0, n1);
    mont_mul<FqP>(n0, a.c1, n1);
    const uint64_t zero[4] = {0, 0, 0, 0};
    sub_mod<FqP>(r.c1, zero, n0);
}

// pts: (n, 3 W) Jacobian words; out: (n, 2 W) affine words
template <class F>
__global__ void __launch_bounds__(BN_SUMS_THREADS)
bn_to_affine_kernel(const uint64_t* __restrict__ pts, long long n,
                    uint64_t* __restrict__ out) {
    constexpr int N = PtWords<F>::N;
    constexpr int W = N / 3;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long i0 = t * BN_AFFINE_CHUNK;
    if (i0 >= n) return;
    const long long i1 = i0 + BN_AFFINE_CHUNK < n ? i0 + BN_AFFINE_CHUNK : n;
    F acc, z;
    f_set_one(acc);
#pragma unroll 1
    for (long long i = i0; i < i1; ++i) {
        f_load(z, pts + N * i + 2 * W);
        f_store(out + 2 * W * i, acc);     // the product of the Z before i
        if (!f_is_zero(z)) f_mul(acc, acc, z);
    }
    F inv;
    f_inv(inv, acc);
#pragma unroll 1
    for (long long i = i1 - 1; i >= i0; --i) {
        uint64_t* o = out + 2 * W * i;
        f_load(z, pts + N * i + 2 * W);
        if (f_is_zero(z)) {
#pragma unroll
            for (int k = 0; k < W; ++k) {
                o[k] = ~0ull;
                o[W + k] = 0;
            }
            continue;
        }
        F zi, zi2, v;
        f_load(zi, o);
        f_mul(zi, zi, inv);                // 1 / Z_i
        f_mul(inv, inv, z);                // 1 / (Z_i0 .. Z_i-1)
        f_mul(zi2, zi, zi);
        f_mul(zi, zi2, zi);                // 1 / Z_i^3
        f_load(v, pts + N * i);
        f_mul(v, v, zi2);
        f_store(o, v);
        f_load(v, pts + N * i + W);
        f_mul(v, v, zi);
        f_store(o + W, v);
    }
}

template <class E>
static int launch_sum_ranges(const void* vals, const void* idx,
                             const void* starts, const void* counts,
                             long long n_ranges, void* out, void* stream) {
    bn_sum_ranges_kernel<E><<<sums_blocks(n_ranges), BN_SUMS_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const uint64_t*)vals, (const long long*)idx, (const long long*)starts,
        (const long long*)counts, n_ranges, (uint64_t*)out);
    return (int)cudaGetLastError();
}

// kind: 0 = Fr, 1 = G1 (Fq), 2 = G2 (Fq2); idx may be null (contiguous
// ranges)
extern "C" int merlin_bn_sum_ranges(int kind, const void* vals, const void* idx,
                                    const void* starts, const void* counts,
                                    long long n_ranges, void* out, void* stream) {
    if (n_ranges <= 0) return 0;
    switch (kind) {
        case 0:
            return launch_sum_ranges<FrEl>(vals, idx, starts, counts, n_ranges, out,
                                           stream);
        case 1:
            return launch_sum_ranges<Pt<Fq>>(vals, idx, starts, counts, n_ranges,
                                             out, stream);
        case 2:
            return launch_sum_ranges<Pt<Fq2>>(vals, idx, starts, counts, n_ranges,
                                              out, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" int merlin_bn_to_affine(int g2, const void* pts, long long n,
                                   void* out, void* stream) {
    if (n <= 0) return 0;
    const long long chunks = (n + BN_AFFINE_CHUNK - 1) / BN_AFFINE_CHUNK;
    if (g2)
        bn_to_affine_kernel<Fq2><<<sums_blocks(chunks), BN_SUMS_THREADS, 0,
                                   (cudaStream_t)stream>>>(
            (const uint64_t*)pts, n, (uint64_t*)out);
    else
        bn_to_affine_kernel<Fq><<<sums_blocks(chunks), BN_SUMS_THREADS, 0,
                                  (cudaStream_t)stream>>>(
            (const uint64_t*)pts, n, (uint64_t*)out);
    return (int)cudaGetLastError();
}
