// Kernel B3 (Pippenger multi-scalar multiplication) over G1 (Fq) and G2
// (Fq2), affine bases, signed c-bit digits.  The range sums of Jacobian
// points and of Fr values and the bases' conversion to affine form are in
// bn254_msm_sums.cu; B4 is in bn254_fixed_base.cu.
//
// Replaces no TPU kernel: the JAX package runs snark/msm.py:57-131 as jnp
// lax.scans over 16-bit limbs.  Bound: operations (a mixed addition of an
// affine point is 11 Montgomery products of 36 64-bit products in G1,
// three times that in G2; a complete addition 16).  An affine base is 64
// or 128 bytes, an entry 4.
//
// snark/msm.py drives them in this order:
//   bn_msm_digits<DIGITS_COUNT>: one thread a scalar recodes it low
//     window first with a carry (curve.signed_digits' rule: v = bits +
//     carry, a digit v - 2^c with a carry of one where v > 2^(c-1)), and
//     counts each nonzero digit in its bucket (window, |digit|), 2^(c-1)
//     buckets a window, by warp-aggregated atomics; a base at infinity (an
//     x of all ones) or a zero scalar counts nothing;
//   then for each group of windows w0 .. w0 + g - 1 (at most
//   MSM_GROUP_ENTRIES digit entries a group):
//   the wrapper: each bucket's first position (torch.cumsum), its ranges;
//   bn_msm_digits<DIGITS_SCATTER>: the same walk writes each entry, the
//     point index with the digit's sign in bit 31, at its bucket's cursor:
//     the entries in bucket order (a counting sort);
//   bn_msm_bucket_sums: one thread a range of a bucket's entries, strided
//     (range j of a bucket of k ranges takes entries j, j + k, ...) so that
//     a warp reads neighbouring entries: the affine points, y negated for
//     a negative digit, added by pt_madd (11 products) into a Jacobian
//     sum (loading the next entry's point during an addition took 130
//     registers and ran 6% slower: PERF.md); bn_sum_ranges joins a
//     bucket's ranges (the witness's digit-1 bucket holds about half the
//     points);
//   bn_msm_reduce, once an MSM over all its windows: one block a window;
//     thread t runs the running sums over the buckets [t S, (t + 1) S) (b
//     is the digit b + 1): R_t = sum B_b, A_t = sum (b - t S + 1) B_b; the
//     block joins the pairs by a tree in shared memory (left and right
//     halves: R = R1 + R2, A = A1 + A2 + S 2^l R2 at level l), so that W
//     = A of the root = sum_b (b + 1) B_b; the block that finishes last (a
//     counter) combines the windows from the top: acc = 2^c acc + W_w.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define BN_MSM_THREADS 128
#define BN_MSM_REDUCE_THREADS 256

static inline unsigned msm_blocks(long long n) {
    return (unsigned)((n + BN_MSM_THREADS - 1) / BN_MSM_THREADS);
}

// bits [0, bits) of a 64-bit limb holding bits [lo, lo + 64) of a scalar
__device__ __forceinline__ uint64_t limb_below(uint64_t v, int lo, int bits) {
    if (bits >= lo + 64) return v;
    if (bits <= lo) return 0;
    return v & ((1ull << (bits - lo)) - 1);
}

// What bn_msm_digits writes: each bucket's count, the entries at the
// buckets' cursors (the counting sort), or every digit's 32-bit key (or
// ~0 for a zero digit) and entry at (w - w0) n + i, unsorted (the route
// through torch.sort that tools/bn254_times.py measures beside the
// counting sort).
enum DigitsMode { DIGITS_COUNT = 0, DIGITS_SCATTER = 1, DIGITS_KEYS = 2 };

// counts: (g * 2^(c-1),) per-bucket counts (DIGITS_COUNT) or each
// bucket's cursor, its first free position (DIGITS_SCATTER), or the
// (g n,) keys (DIGITS_KEYS); entries: the entries (DIGITS_SCATTER,
// DIGITS_KEYS).  Every lane of a warp walks the same windows, so
// __match_any_sync sees the whole warp.
template <int MODE>
__global__ void __launch_bounds__(BN_MSM_THREADS)
bn_msm_digits_kernel(const uint64_t* __restrict__ scalars,
                     const uint64_t* __restrict__ bases, int base_words,
                     long long n, int c, int w0, int g, int bits,
                     unsigned* __restrict__ counts,
                     unsigned* __restrict__ entries) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const unsigned lane = threadIdx.x & 31;
    bool live = i < n;
    uint64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    if (live) {
        live = bases[(long long)base_words * i + 3] != ~0ull;  // infinity
        s0 = limb_below(scalars[4 * i], 0, bits);
        s1 = limb_below(scalars[4 * i + 1], 64, bits);
        s2 = limb_below(scalars[4 * i + 2], 128, bits);
        s3 = limb_below(scalars[4 * i + 3], 192, bits);
        live = live && (s0 | s1 | s2 | s3) != 0;
    }
    const uint64_t mask = (1ull << c) - 1;
    const unsigned half = 1u << (c - 1);
    const int n_win = bits / c + 1;
    const int last = w0 + g < n_win ? w0 + g : n_win;
    unsigned carry = 0;
#pragma unroll 1
    for (int w = 0; w < last; ++w) {
        unsigned v = (unsigned)(s0 & mask) + carry;
        s0 = (s0 >> c) | (s1 << (64 - c));
        s1 = (s1 >> c) | (s2 << (64 - c));
        s2 = (s2 >> c) | (s3 << (64 - c));
        s3 >>= c;
        carry = v > half;
        if (carry) v = (1u << c) - v;
        const int key = live && v != 0 && w >= w0
            ? (int)((unsigned)(w - w0) * half + v - 1) : -1;
        if (MODE == DIGITS_KEYS) {
            if (i < n && w >= w0) {
                const long long at = (long long)(w - w0) * n + i;
                counts[at] = (unsigned)key;
                entries[at] = (unsigned)i | (carry << 31);
            }
            continue;
        }
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key < 0) continue;
        const int leader = __ffs(peers) - 1;
        unsigned at = 0;
        if ((int)lane == leader) at = atomicAdd(counts + key, __popc(peers));
        if (MODE == DIGITS_SCATTER) {
            at = __shfl_sync(peers, at, leader);
            entries[at + __popc(peers & ((1u << lane) - 1))] =
                (unsigned)i | (carry << 31);
        }
    }
}

// out[r]: the Jacobian sum of the affine bases of entries starts[r],
// starts[r] + strides[r], ... (counts[r] of them), y negated where an
// entry's bit 31 is set.  The sum starts from its first point (Z = 1) and,
// after pt_madd returns infinity, from the next one: pt_madd takes
// infinity on neither side.
template <class F>
__global__ void __launch_bounds__(BN_MSM_THREADS)
bn_msm_bucket_sums_kernel(const uint64_t* __restrict__ bases,
                          const unsigned* __restrict__ entries,
                          const long long* __restrict__ starts,
                          const int* __restrict__ counts,
                          const int* __restrict__ strides, long long n_ranges,
                          uint64_t* __restrict__ out) {
    constexpr int N = PtWords<F>::N;
    constexpr int W = N / 3;
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_ranges) return;
    Pt<F> acc;
    bool inf = true;
    long long k = starts[r];
    const int cnt = counts[r], step = strides[r];
#pragma unroll 1
    for (int j = 0; j < cnt; ++j, k += step) {
        const unsigned e = entries[k];
        const uint64_t* b = bases + (long long)(2 * W) * (e & 0x7fffffffu);
        const bool neg = (e >> 31) != 0;
        if (inf) {
            f_load(acc.x, b);
            f_load(acc.y, b + W);
            if (neg) f_neg(acc.y, acc.y);
            f_set_one(acc.z);
            inf = false;
        } else {
            inf = pt_madd(acc, b, neg);
        }
    }
    if (inf) pt_inf(acc);
    pt_store(out + (long long)N * r, acc);
}

// A point read past L1 (another block's result, made visible by its
// __threadfence).
template <class F>
__device__ __forceinline__ void pt_load_cg(Pt<F>& p, const uint64_t* src) {
    constexpr int N = PtWords<F>::N;
    uint64_t w[N];
#pragma unroll
    for (int k = 0; k < N; ++k)
        w[k] = __ldcg((const unsigned long long*)src + k);
    pt_load(p, w);
}

// buckets: (gridDim.x * 2^(c-1), N) Jacobian bucket sums, a window a
// block; block w writes wsums[w]; counter: zero before the launch; the
// block that brings it to gridDim.x writes the MSM's point to out.
// Segments of 2^s_bits buckets; blockDim.x a power of two (threads past
// the buckets hold infinity); dynamic shared memory: blockDim.x (R, A)
// pairs.
template <class F>
__global__ void __launch_bounds__(BN_MSM_REDUCE_THREADS)
bn_msm_reduce_kernel(const uint64_t* __restrict__ buckets, int c, int s_bits,
                     uint64_t* wsums, unsigned* counter,
                     uint64_t* out) {
    extern __shared__ uint64_t tree[];
    constexpr int N = PtWords<F>::N;
    const int t = threadIdx.x;
    const long long half = 1LL << (c - 1);
    const long long lo = (long long)t << s_bits;
    const uint64_t* b = buckets + (long long)N * (blockIdx.x * half);
    Pt<F> run, acc, p;
    pt_inf(run);
    pt_inf(acc);
    if (lo < half) {
#pragma unroll 1
        for (long long j = (1LL << s_bits) - 1; j >= 0; --j) {
            pt_load(p, b + N * (lo + j));
            pt_add(run, run, p);
            pt_add(acc, acc, run);
        }
    }
    pt_store(tree + N * (2 * t), run);
    pt_store(tree + N * (2 * t + 1), acc);
    __syncthreads();
#pragma unroll 1
    for (int l = 0; (1 << l) < (int)blockDim.x; ++l) {
        if ((t & ((2 << l) - 1)) == 0) {
            const int u = t + (1 << l);
            pt_load(run, tree + N * (2 * t));
            pt_load(acc, tree + N * (2 * t + 1));
            pt_load(p, tree + N * (2 * u + 1));
            pt_add(acc, acc, p);                 // A1 + A2
            pt_load(p, tree + N * (2 * u));      // R2
            pt_add(run, run, p);
#pragma unroll 1
            for (int k = 0; k < s_bits + l; ++k) pt_dbl(p, p);
            pt_add(acc, acc, p);                 // + S 2^l R2
            pt_store(tree + N * (2 * t), run);
            pt_store(tree + N * (2 * t + 1), acc);
        }
        __syncthreads();
    }
    if (t != 0) return;
    pt_load(acc, tree + N);
    pt_store(wsums + (long long)N * blockIdx.x, acc);
    __threadfence();
    const int nw = gridDim.x;
    if (atomicAdd(counter, 1u) != (unsigned)nw - 1) return;
    __threadfence();
    pt_inf(acc);
#pragma unroll 1
    for (int w = nw - 1; w >= 0; --w) {
#pragma unroll 1
        for (int k = 0; k < c; ++k) pt_dbl(acc, acc);
        pt_load_cg(p, wsums + (long long)N * w);
        pt_add(acc, acc, p);
    }
    pt_store(out, acc);
}

// mode: a DigitsMode
extern "C" int merlin_bn_msm_digits(int mode, const void* scalars,
                                    const void* bases, int base_words,
                                    long long n, int c, int w0, int g, int bits,
                                    void* counts, void* entries, void* stream) {
    if (n <= 0) return 0;
    if (c < 2 || c > 24 || bits < 1 || bits > 256 || mode < DIGITS_COUNT ||
        mode > DIGITS_KEYS)
        return (int)cudaErrorInvalidValue;
    const uint64_t* s = (const uint64_t*)scalars;
    const uint64_t* b = (const uint64_t*)bases;
    unsigned* k = (unsigned*)counts;
    unsigned* e = (unsigned*)entries;
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == DIGITS_COUNT)
        bn_msm_digits_kernel<DIGITS_COUNT><<<msm_blocks(n), BN_MSM_THREADS, 0,
                                             st>>>(s, b, base_words, n, c, w0,
                                                   g, bits, k, nullptr);
    else if (mode == DIGITS_SCATTER)
        bn_msm_digits_kernel<DIGITS_SCATTER><<<msm_blocks(n), BN_MSM_THREADS,
                                               0, st>>>(s, b, base_words, n, c,
                                                        w0, g, bits, k, e);
    else
        bn_msm_digits_kernel<DIGITS_KEYS><<<msm_blocks(n), BN_MSM_THREADS, 0,
                                            st>>>(s, b, base_words, n, c, w0,
                                                  g, bits, k, e);
    return (int)cudaGetLastError();
}

extern "C" int merlin_bn_msm_bucket_sums(int g2, const void* bases,
                                         const void* entries, const void* starts,
                                         const void* counts, const void* strides,
                                         long long n_ranges, void* out,
                                         void* stream) {
    if (n_ranges <= 0) return 0;
    if (g2)
        bn_msm_bucket_sums_kernel<Fq2><<<msm_blocks(n_ranges), BN_MSM_THREADS, 0,
                                         (cudaStream_t)stream>>>(
            (const uint64_t*)bases, (const unsigned*)entries,
            (const long long*)starts, (const int*)counts, (const int*)strides,
            n_ranges, (uint64_t*)out);
    else
        bn_msm_bucket_sums_kernel<Fq><<<msm_blocks(n_ranges), BN_MSM_THREADS, 0,
                                        (cudaStream_t)stream>>>(
            (const uint64_t*)bases, (const unsigned*)entries,
            (const long long*)starts, (const int*)counts, (const int*)strides,
            n_ranges, (uint64_t*)out);
    return (int)cudaGetLastError();
}

// bn_msm_reduce's block for windows of `half` buckets: BN_MSM_REDUCE_THREADS
// halved down to the buckets, at least a warp
extern "C" int merlin_bn_msm_reduce_threads(long long half) {
    int threads = BN_MSM_REDUCE_THREADS;
    while (threads > 32 && threads > half) threads >>= 1;
    return threads;
}

template <class F>
static int launch_reduce(const void* buckets, int c, int nw, void* wsums,
                         void* counter, void* out, void* stream) {
    const long long half = 1LL << (c - 1);
    const int threads = merlin_bn_msm_reduce_threads(half);
    int s_bits = 0;
    while ((long long)threads << (s_bits + 1) <= half) ++s_bits;
    const size_t smem = (size_t)threads * 2 * PtWords<F>::N * sizeof(uint64_t);
    static bool attr_set = false;
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            bn_msm_reduce_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)((size_t)BN_MSM_REDUCE_THREADS * 2 * PtWords<F>::N *
                  sizeof(uint64_t)));
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    bn_msm_reduce_kernel<F><<<nw, threads, smem, (cudaStream_t)stream>>>(
        (const uint64_t*)buckets, c, s_bits, (uint64_t*)wsums,
        (unsigned*)counter, (uint64_t*)out);
    return (int)cudaGetLastError();
}

// buckets of the nw windows of an MSM
extern "C" int merlin_bn_msm_reduce(int g2, const void* buckets, int c, int nw,
                                    void* wsums, void* counter,
                                    void* out, void* stream) {
    if (nw <= 0) return 0;
    if (c < 2 || c > 24) return (int)cudaErrorInvalidValue;
    return g2 ? launch_reduce<Fq2>(buckets, c, nw, wsums, counter, out, stream)
              : launch_reduce<Fq>(buckets, c, nw, wsums, counter, out, stream);
}
