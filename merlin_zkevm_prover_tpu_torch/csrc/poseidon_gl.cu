// Poseidon-Goldilocks kernels: the batched permutation (permute), the rate-8
// row sponge (linear_hash) and the Merkle pair hash (node_hash).  One thread
// holds one 12-word state in registers and runs all 30 rounds of every
// permutation it needs; the 360 round constants and the MDS circulant sit in
// __constant__ memory, which broadcasts a word to the whole warp when all
// threads read the same address, as they do here.
//
// Plain C interface: every entry point launches on the given stream,
// allocates nothing, does not synchronise and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

#define PG_WIDTH 12
#define PG_RATE 8
#define PG_CAP 4
#define PG_ROUNDS 30
#define PG_HALF_FULL 4
#define PG_PARTIAL 22

__constant__ uint64_t PG_RC[PG_ROUNDS * PG_WIDTH];  // canonical
__constant__ uint32_t PG_CIRC[PG_WIDTH];            // each < 2^6
__constant__ uint32_t PG_DIAG0;                     // extra M[0][0] term

// in: s[] canonical.  out: s[] canonical.
// out[i] = sum_j CIRC[(j - i) mod 12] * s[j]  (+ DIAG0 * s[0] for i = 0).
// The sum is taken on the 32-bit halves of s: the coefficients add up to
// less than 2^9, so each half-sum is below 2^41 and cannot overflow.
__device__ __forceinline__ void pg_mds(uint64_t s[PG_WIDTH]) {
    uint64_t lo[PG_WIDTH], hi[PG_WIDTH], out[PG_WIDTH];
#pragma unroll
    for (int j = 0; j < PG_WIDTH; ++j) {
        lo[j] = s[j] & 0xFFFFFFFFULL;
        hi[j] = s[j] >> 32;
    }
#pragma unroll
    for (int i = 0; i < PG_WIDTH; ++i) {
        uint64_t al = 0, ah = 0;
#pragma unroll
        for (int j = 0; j < PG_WIDTH; ++j) {
            uint64_t c = PG_CIRC[(j - i + PG_WIDTH) % PG_WIDTH];
            al += c * lo[j];
            ah += c * hi[j];
        }
        if (i == 0) {
            al += (uint64_t)PG_DIAG0 * lo[0];
            ah += (uint64_t)PG_DIAG0 * hi[0];
        }
        // value = al + ah * 2^32 as a 128-bit word (l, h), h < 2^10
        uint64_t l = al + (ah << 32);
        uint64_t h = (ah >> 32) + (l < al ? 1 : 0);
        out[i] = gl_reduce128(l, h);
    }
#pragma unroll
    for (int i = 0; i < PG_WIDTH; ++i) s[i] = out[i];
}

// in: s[] canonical.  out: s[] canonical.
__device__ __forceinline__ void pg_permute(uint64_t s[PG_WIDTH]) {
    for (int r = 0; r < PG_ROUNDS; ++r) {
#pragma unroll
        for (int i = 0; i < PG_WIDTH; ++i)
            s[i] = gl_add(s[i], PG_RC[r * PG_WIDTH + i]);
        if (r < PG_HALF_FULL || r >= PG_HALF_FULL + PG_PARTIAL) {
#pragma unroll
            for (int i = 0; i < PG_WIDTH; ++i) s[i] = gl_pow7(s[i]);
        } else {
            s[0] = gl_pow7(s[0]);
        }
        pg_mds(s);
    }
}

// state: (12, B) lane-major words in [0, 2^64): word i of state k at
// i * B + k, the layout of the reference's permute_tpu.  out: (12, B)
// canonical, same layout.  One thread per state: for each word the threads of
// a warp read and write 32 neighbouring addresses, so every access is
// coalesced.
__global__ void pg_permute_kernel(const uint64_t* __restrict__ state,
                                  uint64_t* __restrict__ out, long long b) {
    long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= b) return;
    uint64_t s[PG_WIDTH];
#pragma unroll
    for (int i = 0; i < PG_WIDTH; ++i) s[i] = gl_canon(state[i * b + k]);
    pg_permute(s);
#pragma unroll
    for (int i = 0; i < PG_WIDTH; ++i) out[i * b + k] = s[i];
}

// rows: (H, W) row-major words in [0, 2^64), W > 4.  out: (H, 4) canonical.
// One thread per row: capacity starts at zero; per rate-8 chunk the state
// is [chunk | capacity], the last chunk zero-padded; the new capacity is
// lanes 0..3 of the permuted state.
__global__ void pg_linear_hash_kernel(const uint64_t* __restrict__ rows,
                                      uint64_t* __restrict__ out,
                                      long long h, int w) {
    long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= h) return;
    const uint64_t* p = rows + row * (long long)w;
    uint64_t s[PG_WIDTH];
    uint64_t cap[PG_CAP] = {0, 0, 0, 0};
    for (int off = 0; off < w; off += PG_RATE) {
#pragma unroll
        for (int k = 0; k < PG_RATE; ++k)
            s[k] = (off + k < w) ? gl_canon(p[off + k]) : 0;
#pragma unroll
        for (int k = 0; k < PG_CAP; ++k) s[PG_RATE + k] = cap[k];
        pg_permute(s);
#pragma unroll
        for (int k = 0; k < PG_CAP; ++k) cap[k] = s[k];
    }
#pragma unroll
    for (int k = 0; k < PG_CAP; ++k) out[row * 4 + k] = cap[k];
}

// left, right: n digests of 4 words each, digest i at left + i * stride and
// right + i * stride (stride in words).  out: (n, 4) canonical, dense.
// out[i] = permute([left_i | right_i | 0 0 0 0])[:4].
// With right = left + 4 and stride = 8 this hashes one tree level in place
// out of the level below; out may lie in the same array, beyond the inputs.
__global__ void pg_node_hash_kernel(const uint64_t* __restrict__ left,
                                    const uint64_t* __restrict__ right,
                                    long long stride,
                                    uint64_t* __restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint64_t s[PG_WIDTH];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        s[k] = gl_canon(left[i * stride + k]);
        s[4 + k] = gl_canon(right[i * stride + k]);
        s[8 + k] = 0;
    }
    pg_permute(s);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[i * 4 + k] = s[k];
}

extern "C" int merlin_poseidon_set_constants(const uint64_t* rc,
                                             const uint32_t* circ,
                                             uint32_t diag0) {
    cudaError_t e = cudaMemcpyToSymbol(PG_RC, rc, sizeof(uint64_t) * PG_ROUNDS * PG_WIDTH);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemcpyToSymbol(PG_CIRC, circ, sizeof(uint32_t) * PG_WIDTH);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemcpyToSymbol(PG_DIAG0, &diag0, sizeof(uint32_t));
    return (int)e;
}

extern "C" int merlin_permute(const void* state, void* out, long long b,
                              void* stream) {
    if (b <= 0) return 0;
    const int threads = 128;
    long long blocks = (b + threads - 1) / threads;
    pg_permute_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)state, (uint64_t*)out, b);
    return (int)cudaGetLastError();
}

extern "C" int merlin_linear_hash(const void* rows, void* out, long long h,
                                  int w, void* stream) {
    if (h <= 0) return 0;
    const int threads = 128;
    long long blocks = (h + threads - 1) / threads;
    pg_linear_hash_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)rows, (uint64_t*)out, h, w);
    return (int)cudaGetLastError();
}

extern "C" int merlin_node_hash(const void* left, const void* right,
                                long long stride, void* out, long long n,
                                void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    long long blocks = (n + threads - 1) / threads;
    pg_node_hash_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)left, (const uint64_t*)right, stride, (uint64_t*)out, n);
    return (int)cudaGetLastError();
}
