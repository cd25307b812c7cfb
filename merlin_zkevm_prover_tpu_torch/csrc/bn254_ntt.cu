// Kernel B2: the radix-2 NTT over BN254 Fr in natural order, and the
// elementwise Montgomery kernels around it (the coset scale, Groth16's
// A * B - C, power tables, fflonk's polynomial evaluations).
//
// Replaces no TPU kernel: the JAX package runs snark/fft.py:56-92 as jnp
// limb scans.  The transform is the reference's (a bit-reversal gather,
// then log2(n) DIT stages, butterfly (u, v) -> (u + w v, u - w v), w =
// root^(k n / 2m) from a table of n / 2 powers), run in passes of up to k
// stages (snark/fft.py ntt_passes; k of 10 to 12).  Bound: operations (n / 2
// log2(n) Montgomery products of 36 64-bit products) against 64 bytes an
// element a pass.
//
//   bn_fr_ntt_pass: one block a tile of 2^(kp + cb) elements in shared
//     memory: the elements whose index differs only in the pass's stage
//     bits s0 .. s0 + kp - 1 (2^kp of them), for 2^cb consecutive values of
//     the bits below s0, so that a warp reads neighbouring words; the kp
//     stages run in shared memory, limb-major (limb j of element e at
//     j 2^(kp + cb) + e, so that a warp's threads read neighbouring words
//     and no two share a bank), and the tile is written once.  The first
//     pass gathers its tile through the bit reversal; the inverse's last
//     pass multiplies by 1 / n as it stores.  ceil(log2 n / k) passes where
//     the stage kernel took log2 n launches, each reading and writing the
//     whole array.
//   bn_fr_powers: start * base^j; block b, thread t takes j = b T L + t +
//     r T for r < L (neighbouring threads on neighbouring elements): its
//     first power by square-and-multiply over a table of base^(2^i), then
//     one product by base^T an element.  Bound: the 32 bytes an element it
//     writes.
//   bn_fr_poly_eval: sum_j c_j x^j with the powers made as bn_fr_powers
//     makes them, never written: each thread sums its products, the block
//     sums its threads' in shared memory, and the block that finishes last
//     sums the blocks' sums.  Bound: operations (two products a
//     coefficient, its power and its product) against the 32 bytes a
//     coefficient it reads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define BN_NTT_THREADS 256
#define BN_NTT_PASS_THREADS 256
#define BN_NTT_MAX_TILE_BITS 12
#define BN_POWERS_RUN 64

// src: the input (s0 == 0: read at the bit reversal of each index) or the
// array itself; dst: the array; a tile of 2^(kp + cb) elements: local
// element e = u 2^cb + v is index (h << (s0 + kp)) | (u << s0) | (low0 + v);
// scale: null, or 1 / n (Montgomery) for the inverse's last pass.
__global__ void __launch_bounds__(BN_NTT_PASS_THREADS)
bn_fr_ntt_pass_kernel(const uint64_t* src, uint64_t* dst, int log_n, int s0,
                      int kp, int cb, const uint64_t* __restrict__ tw,
                      const uint64_t* __restrict__ scale) {
    extern __shared__ uint64_t tile[];
    const int t = threadIdx.x;
    const int size = 1 << (kp + cb);
    const long long n_high = 1LL << (log_n - s0 - kp);
    const long long h = blockIdx.x % n_high;
    const long long low0 = (long long)(blockIdx.x / n_high) << cb;
    const int vmask = (1 << cb) - 1;
#pragma unroll 1
    for (int e = t; e < size; e += blockDim.x) {
        const long long i = (h << (s0 + kp)) | ((long long)(e >> cb) << s0) |
                            (low0 + (e & vmask));
        const long long j = s0 == 0
            ? (long long)(__brevll((unsigned long long)i) >> (64 - log_n)) : i;
#pragma unroll
        for (int k = 0; k < 4; ++k) tile[k * size + e] = src[4 * j + k];
    }
    __syncthreads();
#pragma unroll 1
    for (int l = 1; l <= kp; ++l) {
        const int hl = 1 << (l - 1);
        const int sh = log_n - s0 - l;
#pragma unroll 1
        for (int bf = t; bf < size / 2; bf += blockDim.x) {
            const int v = bf & vmask;
            const int b = bf >> cb;
            const int bm = b & (hl - 1);
            const int e1 = ((((b >> (l - 1)) << l) | bm) << cb) | v;
            const int e2 = e1 + (hl << cb);
            const long long kk = ((long long)bm << s0) + low0 + v;
            uint64_t u[4], y[4], w[4], x[4];
            bn_copy(w, tw + 4 * (kk << sh));
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                u[k] = tile[k * size + e1];
                y[k] = tile[k * size + e2];
            }
            mont_mul<FrP>(x, y, w);
            add_mod<FrP>(y, u, x);
            sub_mod<FrP>(x, u, x);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                tile[k * size + e1] = y[k];
                tile[k * size + e2] = x[k];
            }
        }
        __syncthreads();
    }
#pragma unroll 1
    for (int e = t; e < size; e += blockDim.x) {
        const long long i = (h << (s0 + kp)) | ((long long)(e >> cb) << s0) |
                            (low0 + (e & vmask));
        uint64_t r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) r[k] = tile[k * size + e];
        if (scale != nullptr) mont_mul<FrP>(r, r, scale);
        bn_copy(dst + 4 * i, r);
    }
}

// out[j] = start * base^j; step = base^blockDim.x
__global__ void __launch_bounds__(BN_NTT_THREADS)
bn_fr_powers_kernel(const uint64_t* __restrict__ sq,
                    const uint64_t* __restrict__ start,
                    const uint64_t* __restrict__ step, long long n,
                    uint64_t* __restrict__ out) {
    const long long j0 = (long long)blockIdx.x * blockDim.x * BN_POWERS_RUN +
                         threadIdx.x;
    if (j0 >= n) return;
    uint64_t x[4], st[4];
    fr_pow_from_table(x, start, sq, j0);
    bn_copy(st, step);
#pragma unroll 1
    for (int r = 0; r < BN_POWERS_RUN; ++r) {
        const long long j = j0 + (long long)r * blockDim.x;
        if (j >= n) break;
        bn_copy(out + 4 * j, x);
        mont_mul<FrP>(x, x, st);
    }
}

// out = sum_j c_j x^j, c_j at coefs + stride * j (Montgomery); sq[i] =
// x^(2^i), step = x^blockDim.x; partials: one element a block; counter:
// zero before the launch.
__global__ void __launch_bounds__(BN_NTT_THREADS)
bn_fr_poly_eval_kernel(const uint64_t* __restrict__ coefs, long long stride,
                       long long m, const uint64_t* __restrict__ sq,
                       const uint64_t* __restrict__ step, uint64_t* partials,
                       unsigned* counter, uint64_t* __restrict__ out) {
    __shared__ uint64_t red[4 * BN_NTT_THREADS];
    __shared__ bool last;
    const int t = threadIdx.x;
    const long long j0 = (long long)blockIdx.x * blockDim.x * BN_POWERS_RUN + t;
    uint64_t acc[4] = {0, 0, 0, 0};
    if (j0 < m) {
        uint64_t x[4], st[4], one[4], p[4];
        bn_one<FrP>(one);
        fr_pow_from_table(x, one, sq, j0);
        bn_copy(st, step);
#pragma unroll 1
        for (int r = 0; r < BN_POWERS_RUN; ++r) {
            const long long j = j0 + (long long)r * blockDim.x;
            if (j >= m) break;
            mont_mul<FrP>(p, coefs + stride * j, x);
            add_mod<FrP>(acc, acc, p);
            mont_mul<FrP>(x, x, st);
        }
    }
    bn_copy(red + 4 * t, acc);
    __syncthreads();
#pragma unroll 1
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (t < s) add_mod<FrP>(red + 4 * t, red + 4 * t, red + 4 * (t + s));
        __syncthreads();
    }
    if (t == 0) {
        bn_copy(partials + 4 * blockIdx.x, red);
        __threadfence();
        last = atomicAdd(counter, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    bn_zero(acc);
#pragma unroll 1
    for (long long b = t; b < gridDim.x; b += blockDim.x) {
        uint64_t p[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            p[k] = __ldcg((const unsigned long long*)partials + 4 * b + k);
        add_mod<FrP>(acc, acc, p);
    }
    bn_copy(red + 4 * t, acc);
    __syncthreads();
#pragma unroll 1
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (t < s) add_mod<FrP>(red + 4 * t, red + 4 * t, red + 4 * (t + s));
        __syncthreads();
    }
    if (t == 0) bn_copy(out, red);
}

// out[i] = a[i] * b[i * b_stride] (b_stride 0: one b for all), field fq or fr.
template <class P>
__global__ void bn_mont_mul_kernel(const uint64_t* __restrict__ a,
                                   const uint64_t* __restrict__ b, long long n,
                                   long long b_stride, uint64_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint64_t r[4];
    mont_mul<P>(r, a + 4 * i, b + 4 * (i * b_stride));
    bn_copy(out + 4 * i, r);
}

// out[i] = a[i] * b[i] - c[i] over Fr (Groth16's H values on the coset).
__global__ void bn_fr_mul_sub_kernel(const uint64_t* __restrict__ a,
                                     const uint64_t* __restrict__ b,
                                     const uint64_t* __restrict__ c, long long n,
                                     uint64_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint64_t r[4];
    mont_mul<FrP>(r, a + 4 * i, b + 4 * i);
    sub_mod<FrP>(r, r, c + 4 * i);
    bn_copy(out + 4 * i, r);
}

static inline unsigned bn_blocks(long long n) {
    return (unsigned)((n + BN_NTT_THREADS - 1) / BN_NTT_THREADS);
}

static inline unsigned run_blocks(long long n) {
    const long long per = (long long)BN_NTT_THREADS * BN_POWERS_RUN;
    return (unsigned)((n + per - 1) / per);
}

// One pass of stages s0 + 1 .. s0 + kp over tiles of 2^(kp + cb) elements
// (kp + cb <= BN_NTT_MAX_TILE_BITS, cb <= s0); scale null or 1 / n.
extern "C" int merlin_bn_fr_ntt_pass(const void* src, void* dst, int log_n,
                                     int s0, int kp, int cb, const void* tw,
                                     const void* scale, void* stream) {
    if (log_n < 1 || kp < 1 || cb < 0 || cb > s0 || s0 + kp > log_n ||
        kp + cb > BN_NTT_MAX_TILE_BITS)
        return (int)cudaErrorInvalidValue;
    static bool attr_set = false;
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            bn_fr_ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (1 << BN_NTT_MAX_TILE_BITS) * 4 * (int)sizeof(uint64_t));
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    const unsigned tiles = (unsigned)(1LL << (log_n - kp - cb));
    const size_t smem = ((size_t)1 << (kp + cb)) * 4 * sizeof(uint64_t);
    bn_fr_ntt_pass_kernel<<<tiles, BN_NTT_PASS_THREADS, smem,
                            (cudaStream_t)stream>>>(
        (const uint64_t*)src, (uint64_t*)dst, log_n, s0, kp, cb,
        (const uint64_t*)tw, (const uint64_t*)scale);
    return (int)cudaGetLastError();
}

// sq: base^(2^i) for i up to n's bit length; step: base^BN_NTT_THREADS
extern "C" int merlin_bn_fr_powers(const void* sq, const void* start,
                                   const void* step, long long n, void* out,
                                   void* stream) {
    if (n <= 0) return 0;
    bn_fr_powers_kernel<<<run_blocks(n), BN_NTT_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const uint64_t*)sq, (const uint64_t*)start, (const uint64_t*)step, n,
        (uint64_t*)out);
    return (int)cudaGetLastError();
}

// the block of the powers and poly_eval kernels: a thread's powers are
// this far apart (step = base^run_threads)
extern "C" int merlin_bn_fr_run_threads() { return BN_NTT_THREADS; }

// partials: one element for each of poly_eval_blocks(m) blocks
extern "C" long long merlin_bn_fr_poly_eval_blocks(long long m) {
    return run_blocks(m);
}

extern "C" int merlin_bn_fr_poly_eval(const void* coefs, long long stride,
                                      long long m, const void* sq,
                                      const void* step, void* partials,
                                      void* counter, void* out, void* stream) {
    if (m <= 0) return 0;
    bn_fr_poly_eval_kernel<<<run_blocks(m), BN_NTT_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const uint64_t*)coefs, stride, m, (const uint64_t*)sq,
        (const uint64_t*)step, (uint64_t*)partials, (unsigned*)counter,
        (uint64_t*)out);
    return (int)cudaGetLastError();
}

// field: 0 = Fq, 1 = Fr
extern "C" int merlin_bn_mont_mul(int field, const void* a, const void* b,
                                  long long n, long long b_stride, void* out,
                                  void* stream) {
    if (n <= 0) return 0;
    if (field == 0)
        bn_mont_mul_kernel<FqP><<<bn_blocks(n), BN_NTT_THREADS, 0,
                                  (cudaStream_t)stream>>>(
            (const uint64_t*)a, (const uint64_t*)b, n, b_stride, (uint64_t*)out);
    else
        bn_mont_mul_kernel<FrP><<<bn_blocks(n), BN_NTT_THREADS, 0,
                                  (cudaStream_t)stream>>>(
            (const uint64_t*)a, (const uint64_t*)b, n, b_stride, (uint64_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int merlin_bn_fr_mul_sub(const void* a, const void* b, const void* c,
                                    long long n, void* out, void* stream) {
    if (n <= 0) return 0;
    bn_fr_mul_sub_kernel<<<bn_blocks(n), BN_NTT_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)a, (const uint64_t*)b, (const uint64_t*)c, n,
        (uint64_t*)out);
    return (int)cudaGetLastError();
}
