// Kernel B1: Poseidon over BN254 Fr (t = 2..17, the circomlib optimized
// form) and the arity-16 BN128 Merkle tree: the sponge kernel (a launch per
// width of the row's chunks), the words kernel (rows of width <= 4) and the
// node kernel.
//
// Replaces no TPU kernel: the JAX package hashes these trees on the host in
// python ints (ops/poseidon_bn254.py:69-182, stark/merkle_bn128.py:22-60,
// 97-98), which at recursiveF's width (some 6 million permutations) would
// take hours.  Bound: operations.  A t = 17 permutation is 5,168 Montgomery
// products in the reference's count; a row moves a few hundred bytes.
//
// The design, for the card:
// - The width T is a template parameter: the permutation is inline.  A
//   leaf's full chunks run at T = 17, its last chunk in a second launch at
//   T = pending + 1 (ops/poseidon_bn254_cuda.py leaf_hash).
// - A dense mix is lazy: each output sums its T double-width products
//   (bn_mul_wide, bn_add9) and is reduced once (bn_redc9), and so is the
//   dot product of a partial round.
// - The constants are read warp-uniformly through the read-only cache
//   (__ldg).
// - One thread a permutation, the state in a column of shared memory, a
//   mix two outputs at a time: its last BN_POS_MIX_REGS outputs in
//   registers and the others through a scratch column (a T = 17 state and
//   its mix outputs do not fit 255 registers together).  832 bytes a thread
//   at T = 17: 8 warps an SM.  The state in registers (it spills at
//   T = 17), the constants in shared memory, and a permutation shared by
//   2, 4 or 8 lanes with the mix by shuffles were slower (PERF.md).
//
// Tables (ops/poseidon_bn254_cuda.py _flat_tables): one array of Montgomery
// elements, 4 words each, and meta[t * 5 + k] = element offsets of C, S, M,
// P and the number of partial rounds of width t; C, S, M, P of one width
// are contiguous.  M[j][i] is element (j * t + i) of its matrix:
// out[i] = sum_j M[j][i] * in[j].  Values at the interfaces are plain
// canonical Fr (not Montgomery); a chunk's capacity passed between two
// launches stays in Montgomery form.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define BN_POS_T_MAX 17
#define BN_POS_HALF_F 4  // N_ROUNDS_F / 2
#define BN_POS_ARITY 16
#define BN_POS_THREADS 64
#define BN_POS_MIX_REGS 8

// one table element, read warp-uniformly
__device__ __forceinline__ void pos_ldc(uint64_t* x, const uint64_t* p) {
    const ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(p));
    const ulonglong2 b = __ldg(reinterpret_cast<const ulonglong2*>(p) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

struct PosTabs {
    const uint64_t *c, *s, *m, *p;
    int n_p;
};

template <int T>
__device__ __forceinline__ PosTabs pos_tabs(const uint64_t* __restrict__ tab,
                                           const int* __restrict__ meta) {
    const int c0 = __ldg(meta + T * 5), s0 = __ldg(meta + T * 5 + 1),
              m0 = __ldg(meta + T * 5 + 2), p0 = __ldg(meta + T * 5 + 3);
    const uint64_t* base = tab + 4 * (long long)c0;
    return {base, base + 4 * (s0 - c0), base + 4 * (m0 - c0),
            base + 4 * (p0 - c0), __ldg(meta + T * 5 + 4)};
}

__device__ __forceinline__ void pos_sbox(uint64_t* x) {
    uint64_t x2[4], x4[4];
    mont_mul<FrP>(x2, x, x);
    mont_mul<FrP>(x4, x2, x2);
    mont_mul<FrP>(x, x4, x);
}

// the constants of full round r (after its S-boxes; the last has none)
__device__ __forceinline__ const uint64_t* pos_round_c(const PosTabs& tb, int T,
                                                       int r) {
    return r < BN_POS_HALF_F
        ? tb.c + 4 * (r + 1) * T
        : tb.c + 4 * ((BN_POS_HALF_F + 1) * T + tb.n_p + (r - BN_POS_HALF_F) * T);
}

__device__ __forceinline__ void to_mont_fr(uint64_t* r, const uint64_t* a) {
    uint64_t r2[4];
    bn_r2<FrP>(r2);
    mont_mul<FrP>(r, a, r2);
}

__device__ __forceinline__ void from_mont_fr(uint64_t* r, const uint64_t* a) {
    const uint64_t one[4] = {1, 0, 0, 0};
    mont_mul<FrP>(r, a, one);
}

// element k of a chunk from element el0 of a row of w GL words (three words
// an element, zero past the row's end), in Montgomery form
__device__ __forceinline__ void pos_load_elem(uint64_t* e, const uint64_t* src,
                                              int w, int el) {
    const int base = 3 * el;
    bn_zero(e);
#pragma unroll
    for (int i = 0; i < 3; ++i)
        if (base + i < w) e[i] = src[base + i];
    to_mont_fr(e, e);
}

// The last mix_regs outputs of a mix (an even number) stay in registers
// until the mix ends, the others go through the scratch column.
template <int T>
struct PosCols {
    static constexpr int mix_regs = T > BN_POS_MIX_REGS ? BN_POS_MIX_REGS : 0;
    static constexpr int scratch = T - mix_regs;
    static constexpr int words = (scratch + T) * 4 * BN_POS_THREADS;
};

// word k of element j of this thread's column: col[(4 j + k) * THREADS]
__device__ __forceinline__ void col_get(const uint64_t* col, int j, uint64_t* x) {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = col[(4 * j + k) * BN_POS_THREADS];
}

__device__ __forceinline__ void col_put(uint64_t* col, int j, const uint64_t* x) {
#pragma unroll
    for (int k = 0; k < 4; ++k) col[(4 * j + k) * BN_POS_THREADS] = x[k];
}

// outputs i and i + 1 (two) of a mix: acc, acc2 = sum_j mat[j][i] st[j]
template <int T>
__device__ __forceinline__ void pos_mix_pair(const uint64_t* st,
                                             const uint64_t* mat, int i,
                                             bool two, uint64_t* r,
                                             uint64_t* r2) {
    uint64_t acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    uint64_t acc2[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll 1
    for (int j = 0; j < T; ++j) {
        uint64_t x[4], m[4], p[8];
        col_get(st, j, x);
        pos_ldc(m, mat + 4 * (j * T + i));
        bn_mul_wide(p, x, m);
        bn_add9(acc, p);
        if (two) {
            pos_ldc(m, mat + 4 * (j * T + i + 1));
            bn_mul_wide(p, x, m);
            bn_add9(acc2, p);
        }
    }
    bn_redc9<FrP>(r, acc);
    if (two) bn_redc9<FrP>(r2, acc2);
}

// st = mat^T st, one reduction an output, two outputs at a time (each
// input read once for both): the last mix_regs into registers, the others
// through `scr`
template <int T>
__device__ __forceinline__ void pos_mix(uint64_t* st, uint64_t* scr,
                                        const uint64_t* mat) {
    constexpr int K = PosCols<T>::mix_regs;
    constexpr int S = PosCols<T>::scratch;
    uint64_t keep[K > 0 ? K : 1][4];
#pragma unroll
    for (int k = 0; k < K; k += 2)
        pos_mix_pair<T>(st, mat, S + k, true, keep[k], keep[k + 1]);
#pragma unroll 1
    for (int i = 0; i < S; i += 2) {
        uint64_t r[4], r2[4];
        const bool two = i + 1 < S;
        pos_mix_pair<T>(st, mat, i, two, r, r2);
        col_put(scr, i, r);
        if (two) col_put(scr, i + 1, r2);
    }
#pragma unroll 1
    for (int j = 0; j < S; ++j) {
        uint64_t x[4];
        col_get(scr, j, x);
        col_put(st, j, x);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) col_put(st, S + k, keep[k]);
}

// the partial rounds: S-box and constant on element 0, then the sparse mix
// (new st[0] = sum_j S[j] st[j], one reduction; st[j] += S[T + j - 1] st[0])
template <int T>
__device__ __forceinline__ void pos_partial(uint64_t* st, const PosTabs& tb) {
    const uint64_t* cp = tb.c + 4 * (BN_POS_HALF_F + 1) * T;
#pragma unroll 1
    for (int r = 0; r < tb.n_p; ++r) {
        uint64_t x0[4], m[4], p[8];
        col_get(st, 0, x0);
        pos_sbox(x0);
        pos_ldc(m, cp + 4 * r);
        add_mod<FrP>(x0, x0, m);
        const uint64_t* sr = tb.s + 4 * (long long)(2 * T - 1) * r;
        uint64_t acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
        pos_ldc(m, sr);
        bn_mul_wide(p, x0, m);
        bn_add9(acc, p);
#pragma unroll 1
        for (int j = 1; j < T; ++j) {
            uint64_t x[4], q[4];
            col_get(st, j, x);
            pos_ldc(m, sr + 4 * j);
            bn_mul_wide(p, x, m);
            bn_add9(acc, p);
            pos_ldc(m, sr + 4 * (T + j - 1));
            mont_mul<FrP>(q, x0, m);
            add_mod<FrP>(x, x, q);
            col_put(st, j, x);
        }
        bn_redc9<FrP>(x0, acc);
        col_put(st, 0, x0);
    }
}

// The width-T permutation of a Montgomery-form state, in place
// (ops/poseidon_bn254.py permute_t): eight full rounds, the partial rounds
// after the fourth; the last full round adds no constants, the fourth mixes
// by P.
template <int T>
__device__ __forceinline__ void pos_permute(uint64_t* st, uint64_t* scr,
                                            const PosTabs& tb) {
#pragma unroll 1
    for (int j = 0; j < T; ++j) {
        uint64_t x[4], c[4];
        col_get(st, j, x);
        pos_ldc(c, tb.c + 4 * j);
        add_mod<FrP>(x, x, c);
        col_put(st, j, x);
    }
#pragma unroll 1
    for (int r = 0; r < 2 * BN_POS_HALF_F; ++r) {
        if (r == BN_POS_HALF_F) pos_partial<T>(st, tb);
        const uint64_t* c = pos_round_c(tb, T, r);
        const bool ark = r != 2 * BN_POS_HALF_F - 1;
#pragma unroll 1
        for (int j = 0; j < T; ++j) {
            uint64_t x[4], k[4];
            col_get(st, j, x);
            pos_sbox(x);
            if (ark) {
                pos_ldc(k, c + 4 * j);
                add_mod<FrP>(x, x, k);
            }
            col_put(st, j, x);
        }
        pos_mix<T>(st, scr, r == BN_POS_HALF_F - 1 ? tb.p : tb.m);
    }
}

extern __shared__ uint64_t pos_smem[];

template <int T>
static inline size_t pos_smem_bytes() {
    return (size_t)PosCols<T>::words * 8;
}

// The sponge over chunks of T - 1 Fr elements of each row (three GL words
// an element, below 2^192 < r): n_chunks chunks from element `first`, the
// capacity from cap (Montgomery; none: 0).  out: (h, 4), the capacity in
// Montgomery form, or (final) the leaf, plain.  One thread a row.
template <int T>
__global__ void __launch_bounds__(BN_POS_THREADS)
bn_poseidon_sponge_kernel(const uint64_t* __restrict__ rows, long long h, int w,
                          int first, int n_chunks,
                          const uint64_t* __restrict__ cap, int final,
                          const uint64_t* __restrict__ tab,
                          const int* __restrict__ meta, uint64_t* __restrict__ out) {
    uint64_t* scr = pos_smem + threadIdx.x;
    uint64_t* st = pos_smem + PosCols<T>::scratch * 4 * BN_POS_THREADS + threadIdx.x;
    const PosTabs tb = pos_tabs<T>(tab, meta);
    const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= h) return;
    const uint64_t* src = rows + row * w;
    uint64_t acc[4] = {0, 0, 0, 0};
    if (cap != nullptr) bn_copy(acc, cap + 4 * row);
#pragma unroll 1
    for (int c = 0; c < n_chunks; ++c) {
        col_put(st, 0, acc);
        const int el0 = first + c * (T - 1);
#pragma unroll 1
        for (int k = 0; k < T - 1; ++k) {
            uint64_t e[4];
            pos_load_elem(e, src, w, el0 + k);
            col_put(st, k + 1, e);
        }
        pos_permute<T>(st, scr, tb);
        col_get(st, 0, acc);
    }
    if (final) from_mont_fr(acc, acc);
    bn_copy(out + 4 * row, acc);
}

// level: (n, 4) plain canonical Fr.  out: (ceil(n / 16), 4): hash16 of each
// group of 16 children, zero past the level's end.  One thread a node.
__global__ void __launch_bounds__(BN_POS_THREADS)
bn_poseidon_node_kernel(const uint64_t* __restrict__ level, long long n,
                        const uint64_t* __restrict__ tab,
                        const int* __restrict__ meta, uint64_t* __restrict__ out) {
    constexpr int T = BN_POS_ARITY + 1;
    uint64_t* scr = pos_smem + threadIdx.x;
    uint64_t* st = pos_smem + PosCols<T>::scratch * 4 * BN_POS_THREADS + threadIdx.x;
    const PosTabs tb = pos_tabs<T>(tab, meta);
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long groups = (n + BN_POS_ARITY - 1) / BN_POS_ARITY;
    if (g >= groups) return;
    uint64_t x[4] = {0, 0, 0, 0};
    col_put(st, 0, x);
#pragma unroll 1
    for (int k = 0; k < BN_POS_ARITY; ++k) {
        const long long idx = g * BN_POS_ARITY + k;
        if (idx < n) to_mont_fr(x, level + 4 * idx);
        else bn_zero(x);
        col_put(st, k + 1, x);
    }
    pos_permute<T>(st, scr, tb);
    col_get(st, 0, x);
    from_mont_fr(x, x);
    bn_copy(out + 4 * g, x);
}


// rows: (h, w) row-major GL words, w <= 4.  out: (h, 4) plain canonical
// leaves, sum_i w_i 2^(64 i) mod r.
__global__ void __launch_bounds__(BN_POS_THREADS)
bn_poseidon_words_kernel(const uint64_t* __restrict__ rows, long long h, int w,
                         uint64_t* __restrict__ out) {
    const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= h) return;
    uint64_t x[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (i < w) x[i] = rows[row * w + i];
    bn_reduce_256<FrP>(x);
    bn_copy(out + 4 * row, x);
}

static unsigned pos_blocks(long long threads) {
    return (unsigned)((threads + BN_POS_THREADS - 1) / BN_POS_THREADS);
}

// a dynamic shared memory size above 48 KB needs the kernel's opt-in
template <class K>
static int pos_smem_opt_in(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

template <int T>
static int launch_sponge(const void* rows, long long h, int w, int first,
                         int n_chunks, const void* cap, int final,
                         const void* tab, const void* meta, void* out,
                         void* stream) {
    const size_t smem = pos_smem_bytes<T>();
    int err = pos_smem_opt_in(bn_poseidon_sponge_kernel<T>, smem);
    if (err) return err;
    bn_poseidon_sponge_kernel<T><<<pos_blocks(h), BN_POS_THREADS,
                                   smem, (cudaStream_t)stream>>>(
        (const uint64_t*)rows, h, w, first, n_chunks, (const uint64_t*)cap,
        final, (const uint64_t*)tab, (const int*)meta, (uint64_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int merlin_bn_poseidon_words(const void* rows, long long h, int w,
                                        void* out, void* stream) {
    if (h <= 0) return 0;
    if (w < 0 || w > 4) return (int)cudaErrorInvalidValue;
    bn_poseidon_words_kernel<<<pos_blocks(h), BN_POS_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const uint64_t*)rows, h, w, (uint64_t*)out);
    return (int)cudaGetLastError();
}

// t: 2..17
extern "C" int merlin_bn_poseidon_sponge(const void* rows, long long h, int w,
                                         int t, int first, int n_chunks,
                                         const void* cap, int final,
                                         const void* tab, const void* meta,
                                         void* out, void* stream) {
    if (h <= 0) return 0;
#define POS_T(T_)                                                            \
    case T_:                                                                 \
        return launch_sponge<T_>(rows, h, w, first, n_chunks, cap, final,    \
                                 tab, meta, out, stream);
    switch (t) {
        POS_T(2) POS_T(3) POS_T(4) POS_T(5) POS_T(6) POS_T(7) POS_T(8)
        POS_T(9) POS_T(10) POS_T(11) POS_T(12) POS_T(13) POS_T(14)
        POS_T(15) POS_T(16) POS_T(17)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef POS_T
}

extern "C" int merlin_bn_poseidon_node(const void* level, long long n,
                                       const void* tab, const void* meta,
                                       void* out, void* stream) {
    if (n <= 0) return 0;
    const long long groups = (n + BN_POS_ARITY - 1) / BN_POS_ARITY;
    const size_t smem = pos_smem_bytes<BN_POS_ARITY + 1>();
    int err = pos_smem_opt_in(bn_poseidon_node_kernel, smem);
    if (err) return err;
    bn_poseidon_node_kernel<<<pos_blocks(groups), BN_POS_THREADS,
                              smem, (cudaStream_t)stream>>>(
        (const uint64_t*)level, n, (const uint64_t*)tab, (const int*)meta,
        (uint64_t*)out);
    return (int)cudaGetLastError();
}
