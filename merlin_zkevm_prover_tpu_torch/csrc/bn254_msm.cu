// Kernel B3 (Pippenger multi-scalar multiplication) over G1 (Fq) and G2
// (Fq2), Jacobian points; B4 is in bn254_fixed_base.cu.
//
// Replaces no TPU kernel: the JAX package runs snark/msm.py:57-131 as jnp
// lax.scans over 16-bit limbs.  Bound: operations (a complete G1 addition
// is 16 Montgomery products of 36 64-bit products; a G2 one three times
// that); a point is 96 or 192 bytes.
//
// B3, with c-bit windows (snark/msm.py drives them in this order):
//   bn_msm_digits: one thread per (window, scalar) of a group of windows
//     w0 .. (the wrapper sorts at most MSM_GROUP_ENTRIES keys at once): the
//     key (w - w0) * 2^c + digit, -1 for digit 0 (skipped); the wrapper
//     sorts the keys (torch.sort) and cuts each bucket into ranges of at
//     most 32 entries (sum_range);
//   bn_sum_ranges: one thread per range: the sum of its points (through an
//     index array on the first pass, contiguous partial sums after), until
//     each bucket is one sum.  The same kernel over Fr sums the Groth16
//     setup's coefficient products by signal and the prover's by
//     constraint (snark/msm.py sum_by_key);
//   bn_bucket_reduce: one thread per (window, segment of 2^seg_bits
//     buckets): the running sum over the segment, descending, gives
//     R = sum B_b and A = sum (b - lo + 1) B_b;
//   bn_window_reduce: one thread per window: sum_b b B_b =
//     sum A - sum R + 2^seg_bits * sum_s s R_s (the last by a running sum);
//   bn_window_combine: one thread: acc = 2^c acc + W_w from the top window.
// Scalars are plain integers, (n, 4) 64-bit limbs.  No more than right and
// simple: one thread per range, point or window.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define BN_MSM_THREADS 128

static inline unsigned msm_blocks(long long n) {
    return (unsigned)((n + BN_MSM_THREADS - 1) / BN_MSM_THREADS);
}

// windows w0 .. w0 + nw - 1; key (w - w0) * 2^c + digit
__global__ void bn_msm_digits_kernel(const uint64_t* __restrict__ scalars,
                                     long long n, int c, int w0, int nw,
                                     int bits, long long* __restrict__ keys) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n * nw) return;
    const int wl = (int)(e / n);
    const int w = w0 + wl;
    const long long i = e - (long long)wl * n;
    const uint64_t* s = scalars + 4 * i;
    long long digit = 0;
    for (int k = 0; k < c; ++k) {
        const int b = w * c + k;
        if (b >= bits) break;
        digit |= (long long)((s[b >> 6] >> (b & 63)) & 1ull) << k;
    }
    keys[e] = digit == 0 ? -1 : ((long long)wl << c) | digit;
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

template <class F>
__global__ void bn_bucket_reduce_kernel(const uint64_t* __restrict__ buckets,
                                        int nw, int c, int seg_bits,
                                        uint64_t* __restrict__ out) {
    constexpr int N = PtWords<F>::N;
    const int n_seg = 1 << (c - seg_bits);
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)nw * n_seg) return;
    const long long w = t / n_seg;
    const long long seg = t - w * n_seg;
    const long long len = 1LL << seg_bits;
    Pt<F> run, acc, p;
    pt_inf(run);
    pt_inf(acc);
#pragma unroll 1
    for (long long j = len - 1; j >= 0; --j) {
        const long long b = seg * len + j;  // bucket 0 holds infinity
        pt_load(p, buckets + N * ((w << c) + b));
        pt_add(run, run, p);
        pt_add(acc, acc, run);
    }
    pt_store(out + N * (2 * t), run);
    pt_store(out + N * (2 * t + 1), acc);
}

template <class F>
__global__ void bn_window_reduce_kernel(const uint64_t* __restrict__ partials,
                                        int nw, int n_seg, int seg_bits,
                                        uint64_t* __restrict__ out) {
    constexpr int N = PtWords<F>::N;
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= nw) return;
    Pt<F> sum_a, sum_r, run, tsum, p;
    pt_inf(sum_a);
    pt_inf(sum_r);
    pt_inf(run);
    pt_inf(tsum);
#pragma unroll 1
    for (int s = n_seg - 1; s >= 0; --s) {
        const uint64_t* base = partials + N * (2 * ((long long)w * n_seg + s));
        pt_load(p, base);            // R_s
        pt_add(sum_r, sum_r, p);
        if (s > 0) {
            pt_add(run, run, p);
            pt_add(tsum, tsum, run);  // sum_s s R_s
        }
        pt_load(p, base + N);        // A_s
        pt_add(sum_a, sum_a, p);
    }
#pragma unroll 1
    for (int k = 0; k < seg_bits; ++k) pt_dbl(tsum, tsum);
    pt_neg(sum_r, sum_r);
    pt_add(sum_a, sum_a, sum_r);
    pt_add(sum_a, sum_a, tsum);
    pt_store(out + N * w, sum_a);
}

template <class F>
__global__ void bn_window_combine_kernel(const uint64_t* __restrict__ wsums,
                                         int nw, int c, uint64_t* __restrict__ out) {
    constexpr int N = PtWords<F>::N;
    if (blockIdx.x != 0 || threadIdx.x != 0) return;
    Pt<F> acc, p;
    pt_inf(acc);
#pragma unroll 1
    for (int w = nw - 1; w >= 0; --w) {
#pragma unroll 1
        for (int k = 0; k < c; ++k) pt_dbl(acc, acc);
        pt_load(p, wsums + N * w);
        pt_add(acc, acc, p);
    }
    pt_store(out, acc);
}

extern "C" int merlin_bn_msm_digits(const void* scalars, long long n, int c,
                                    int w0, int nw, int bits, void* keys,
                                    void* stream) {
    if (n <= 0) return 0;
    bn_msm_digits_kernel<<<msm_blocks(n * nw), BN_MSM_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const uint64_t*)scalars, n, c, w0, nw, bits, (long long*)keys);
    return (int)cudaGetLastError();
}

template <class E>
static int launch_sum_ranges(const void* vals, const void* idx,
                             const void* starts, const void* counts,
                             long long n_ranges, void* out, void* stream) {
    bn_sum_ranges_kernel<E><<<msm_blocks(n_ranges), BN_MSM_THREADS, 0,
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
            return launch_sum_ranges<FrEl>(vals, idx, starts, counts, n_ranges,
                                           out, stream);
        case 1:
            return launch_sum_ranges<Pt<Fq>>(vals, idx, starts, counts,
                                             n_ranges, out, stream);
        case 2:
            return launch_sum_ranges<Pt<Fq2>>(vals, idx, starts, counts,
                                              n_ranges, out, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" int merlin_bn_bucket_reduce(int g2, const void* buckets, int nw,
                                       int c, int seg_bits, void* out,
                                       void* stream) {
    const long long threads = (long long)nw << (c - seg_bits);
    if (g2)
        bn_bucket_reduce_kernel<Fq2><<<msm_blocks(threads), BN_MSM_THREADS, 0,
                                       (cudaStream_t)stream>>>(
            (const uint64_t*)buckets, nw, c, seg_bits, (uint64_t*)out);
    else
        bn_bucket_reduce_kernel<Fq><<<msm_blocks(threads), BN_MSM_THREADS, 0,
                                      (cudaStream_t)stream>>>(
            (const uint64_t*)buckets, nw, c, seg_bits, (uint64_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int merlin_bn_window_reduce(int g2, const void* partials, int nw,
                                       int n_seg, int seg_bits, void* out,
                                       void* stream) {
    if (g2)
        bn_window_reduce_kernel<Fq2><<<msm_blocks(nw), BN_MSM_THREADS, 0,
                                       (cudaStream_t)stream>>>(
            (const uint64_t*)partials, nw, n_seg, seg_bits, (uint64_t*)out);
    else
        bn_window_reduce_kernel<Fq><<<msm_blocks(nw), BN_MSM_THREADS, 0,
                                      (cudaStream_t)stream>>>(
            (const uint64_t*)partials, nw, n_seg, seg_bits, (uint64_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int merlin_bn_window_combine(int g2, const void* wsums, int nw, int c,
                                        void* out, void* stream) {
    if (g2)
        bn_window_combine_kernel<Fq2><<<1, 1, 0, (cudaStream_t)stream>>>(
            (const uint64_t*)wsums, nw, c, (uint64_t*)out);
    else
        bn_window_combine_kernel<Fq><<<1, 1, 0, (cudaStream_t)stream>>>(
            (const uint64_t*)wsums, nw, c, (uint64_t*)out);
    return (int)cudaGetLastError();
}
