// Goldilocks block NTT: one thread block transforms a tile of columns of
// length L = 2^log_l (L <= 512) held in shared memory, all stages on chip,
// one read and one write of device memory per element.
//
// The tile is L rows by 2^log_cols columns, laid out [row][col] so that the
// threads of a warp touch neighbouring columns of one row: loads and stores
// of the (L, B) row-major matrix are coalesced along the column axis, and
// butterflies exchange through shared memory at the stage's row stride with
// __syncthreads() between stages.
//
// Two transforms, both unscaled, twiddles from one (L-1)-word table in
// which the stage with half-size m occupies [m-1, 2m-1) and holds
// w_{2m}^t, t < m:
//   dif = 1: decimation in frequency, natural order in, bit-reversed out;
//   dif = 0: decimation in time, bit-reversed in, natural order out.
// Fused around them:
//   zero_top: the input has only L/2 rows, the upper half is zero (the
//             LDE's zero padding is never read from device memory);
//   u (L words) / v (B words): row r is multiplied by u[r], column c by
//             v[c] (the separable INTT 1/N and coset shift);
//   cscale: every element is multiplied by one constant (the INTT's 1/N).
// Inputs may be any words in [0, 2^64); they are canonicalised on load, and
// every output is canonical.
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

__global__ void ntt_block_kernel(const uint64_t* __restrict__ x,
                                 uint64_t* __restrict__ out,
                                 const uint64_t* __restrict__ tw,
                                 const uint64_t* __restrict__ u,
                                 const uint64_t* __restrict__ v,
                                 uint64_t cscale, int use_cscale, int log_l,
                                 int log_cols, long long b, int dif,
                                 int zero_top) {
    extern __shared__ uint64_t s[];
    const int l = 1 << log_l;
    const int cols = 1 << log_cols;
    const int cmask = cols - 1;
    const long long c0 = (long long)blockIdx.x * cols;
    const int in_rows = zero_top ? (l >> 1) : l;
    const int total = l << log_cols;

    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        int r = idx >> log_cols;
        long long col = c0 + (idx & cmask);
        uint64_t val = 0;
        if (r < in_rows && col < b) val = gl_canon(x[(long long)r * b + col]);
        s[idx] = val;
    }
    __syncthreads();

    const int half_total = total >> 1;  // butterflies per stage in this tile
    if (dif) {
        for (int log_m = log_l - 1; log_m >= 0; --log_m) {
            const int m = 1 << log_m;
            for (int idx = threadIdx.x; idx < half_total; idx += blockDim.x) {
                int c = idx & cmask;
                int bf = idx >> log_cols;
                int j = bf & (m - 1);
                int i0 = ((bf >> log_m) << (log_m + 1)) | j;
                uint64_t a = s[(i0 << log_cols) | c];
                uint64_t d = s[((i0 + m) << log_cols) | c];
                s[(i0 << log_cols) | c] = gl_add(a, d);
                uint64_t t = gl_sub(a, d);
                if (m > 1) t = gl_mul(t, tw[m - 1 + j]);
                s[((i0 + m) << log_cols) | c] = t;
            }
            __syncthreads();
        }
    } else {
        for (int log_m = 0; log_m < log_l; ++log_m) {
            const int m = 1 << log_m;
            for (int idx = threadIdx.x; idx < half_total; idx += blockDim.x) {
                int c = idx & cmask;
                int bf = idx >> log_cols;
                int j = bf & (m - 1);
                int i0 = ((bf >> log_m) << (log_m + 1)) | j;
                uint64_t a = s[(i0 << log_cols) | c];
                uint64_t d = s[((i0 + m) << log_cols) | c];
                if (m > 1) d = gl_mul(d, tw[m - 1 + j]);
                s[(i0 << log_cols) | c] = gl_add(a, d);
                s[((i0 + m) << log_cols) | c] = gl_sub(a, d);
            }
            __syncthreads();
        }
    }

    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        int r = idx >> log_cols;
        long long col = c0 + (idx & cmask);
        if (col >= b) continue;
        uint64_t val = s[idx];
        if (u != nullptr) val = gl_mul(val, u[r]);
        if (v != nullptr) val = gl_mul(val, v[col]);
        if (use_cscale) val = gl_mul(val, cscale);
        out[(long long)r * b + col] = val;
    }
}

// x: (L or L/2, b) row-major; out: (L, b); tw: (max(L-1, 1)) words;
// u: L words or null; v: b words or null.  Returns cudaGetLastError().
extern "C" int merlin_ntt_block(const void* x, void* out, const void* tw,
                                const void* u, const void* v,
                                unsigned long long cscale, int use_cscale,
                                int log_l, long long b, int dif, int zero_top,
                                void* stream) {
    if (b <= 0) return 0;
    if (log_l < 1 || log_l > 9) return (int)cudaErrorInvalidValue;
    // tile of 4096 words (32 KB of shared memory) whatever the length:
    // short transforms take more columns per block
    int log_cols = 12 - log_l;
    long long cols = 1LL << log_cols;
    long long blocks = (b + cols - 1) / cols;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(uint64_t) << 12;
    ntt_block_kernel<<<(unsigned)blocks, 256, smem, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (uint64_t*)out, (const uint64_t*)tw,
        (const uint64_t*)u, (const uint64_t*)v, (uint64_t)cscale, use_cscale,
        log_l, log_cols, b, dif, zero_top);
    return (int)cudaGetLastError();
}
