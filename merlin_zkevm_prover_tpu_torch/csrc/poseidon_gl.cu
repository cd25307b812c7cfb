// Poseidon-Goldilocks kernels: the batched permutation (permute), the rate-8
// row sponge (linear_hash) and the Merkle pair hash (node_hash), the last in
// three forms chosen per tree level by ops/poseidon_cuda.py (_level_plan):
//
//   pg_node_hash_kernel      one thread per pair, for levels large enough to
//                            fill the card;
//   pg_node_hash_group_kernel one state spread over a group of 16 threads
//                            (12 live lanes), for smaller levels, where one
//                            permutation's latency sets the time;
//   pg_merkle_top_kernel     one block that hashes every level from a few
//                            pairs up to the root, with __syncthreads()
//                            between levels, in one launch.
//
// The one-thread-per-state kernels share pg_permute_lazy: the 12-word state
// in registers, words kept lazy (any word in [0, 2^64), see goldilocks.cuh)
// between rounds and canonicalised once where they are written out, each
// round constant folded into the previous round's linear layer, and the
// circulant MDS computed in the frequency domain (pg_circ_half) with adds,
// subtracts and small constants instead of 144 multiplies per half.  The
// round constants sit in __constant__ memory, which broadcasts a word to the
// whole warp when all threads read the same address, as they do there; the
// group kernels, whose threads read different lanes, read a copy in global
// (or, for the top kernel, shared) memory instead.
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

// Threads per block of the one-thread-per-state kernels, set by their
// times on the card (PERF.md).
#define PG_PERMUTE_THREADS 256
#define PG_LINEAR_HASH_THREADS 512
#define PG_NODE_HASH_THREADS 128
#define PG_NODE_GROUP_THREADS 128  // 8 groups of 16
#define PG_TRACE_THREADS 128
// Rows of one PoseidonG slot: the input and the state after each round.
#define PG_SLOT_ROWS (PG_ROUNDS + 1)

// Row r holds the constants added before round r; row PG_ROUNDS is zero (no
// constant follows the last round).  Canonical.
__constant__ uint64_t PG_RC[(PG_ROUNDS + 1) * PG_WIDTH];
// The same rows in global memory, for the group kernels, whose threads read
// different lanes (a warp reading 32 different __constant__ words is served
// one word at a time).
__device__ uint64_t PG_RC_GLOBAL[(PG_ROUNDS + 1) * PG_WIDTH];

// The MDS matrix: M[i][j] = PG_CIRC[(j - i) mod 12], plus PG_MDS_DIAG0 on
// M[0][0] (ops/poseidon_constants.py MDS_CIRC, MDS_DIAG; tests hold these
// against it).  Each entry < 2^6.
__constant__ const uint32_t PG_CIRC[PG_WIDTH] = {17, 15, 41, 16, 2,  28,
                                                 13, 13, 39, 18, 34, 20};
#define PG_MDS_DIAG0 8

// Frequency-domain blocks of the circulant (see pg_circ_half), derived from
// MDS_CIRC by ops/poseidon_cuda.mds_block_constants(); tests hold these
// against it.  With c(z) = sum_k CIRC[k] z^-k:
//   S block (z^4-axis DC):   c_S(u) / 4 = KS (1 + u + u^2) + KS u
//   T block (z^4-axis at -1): 3-point DC and Eisenstein part, / 12
//   D block (z^4-axis at +-i): Gaussian DC part and Q(zeta_12) part, / 6
#define PG_KS 16
#define PG_KT_DC 3
#define PG_KT_E0 (-1)
#define PG_KT_E1 2
#define PG_KD_DC0 (-5)
#define PG_KD_DC1 (-2)
#define PG_KD_E00 6
#define PG_KD_E01 5
#define PG_KD_E10 0
#define PG_KD_E11 (-1)

#define PG_K(c) ((uint64_t)(int64_t)(c))

// (a + b u)(C + D u) mod u^2 + u + 1 = (C a - D b) + (D a + (C - D) b) u.
// Words are two's-complement integers; arithmetic wraps mod 2^64.
template <int C, int D>
__device__ __forceinline__ void pg_eis(uint64_t a, uint64_t b, uint64_t& r0,
                                       uint64_t& r1) {
    r0 = PG_K(C) * a - PG_K(D) * b;
    r1 = PG_K(D) * a + PG_K(C - D) * b;
}

// 3-point transform of (p0, p1, p2) for u^3 - 1 = (u - 1)(u^2 + u + 1):
// dc = p0 + p1 + p2 and e0 + e1 u = p mod (u^2 + u + 1).
__device__ __forceinline__ void pg_f3(uint64_t p0, uint64_t p1, uint64_t p2,
                                      uint64_t& dc, uint64_t& e0, uint64_t& e1) {
    dc = p0 + p1 + p2;
    e0 = p0 - p2;
    e1 = p1 - p2;
}

// Its inverse times 3: q = 3p from (dc, e0, e1).
__device__ __forceinline__ void pg_i3(uint64_t dc, uint64_t e0, uint64_t e1,
                                      uint64_t q[3]) {
    q[2] = dc - e0 - e1;
    q[0] = q[2] + 3 * e0;
    q[1] = q[2] + 3 * e1;
}

// in: x[12], each < 2^32.  out: y[i] = sum_j CIRC[(j - i) mod 12] x[j]
// (the circulant only), each < 2^40.
// y = c(z) x(z) mod z^12 - 1, and z^12 - 1 splits by the CRT index map
// m = (4u + 9v) mod 12 into u^3 - 1 and v^4 - 1; v^4 - 1 into v - 1 (S),
// v + 1 (T) and v^2 + 1 (D); u^3 - 1 into u - 1 and u^2 + u + 1.  Each block
// is multiplied by c's block with the inverse transforms' 1/4, 1/3 folded
// into the constants above, which are integers for this circulant.  Only
// +, - and * by integer constants occur, so every word is the true signed
// intermediate mod 2^64, and y, an integer in [0, 2^40), is exact.
__device__ __forceinline__ void pg_circ_half(const uint64_t x[PG_WIDTH],
                                             uint64_t y[PG_WIDTH]) {
    uint64_t S[3], T[3], D0[3], D1[3];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
        uint64_t x0 = x[(4 * u) % 12], x1 = x[(4 * u + 9) % 12];
        uint64_t x2 = x[(4 * u + 18) % 12], x3 = x[(4 * u + 27) % 12];
        uint64_t a = x0 + x2, b = x1 + x3;
        S[u] = a + b;
        T[u] = a - b;
        D0[u] = x0 - x2;
        D1[u] = x1 - x3;
    }
    // S block: (S[u] / 4-scaled) KS (sum S + S[u - 1])
    uint64_t ss = S[0] + S[1] + S[2];
    uint64_t sh[3];
#pragma unroll
    for (int u = 0; u < 3; ++u) sh[u] = PG_K(PG_KS) * (ss + S[(u + 2) % 3]);
    // T block
    uint64_t tdc, te0, te1, pe0, pe1, th[3];
    pg_f3(T[0], T[1], T[2], tdc, te0, te1);
    pg_eis<PG_KT_E0, PG_KT_E1>(te0, te1, pe0, pe1);
    pg_i3(PG_K(PG_KT_DC) * tdc, pe0, pe1, th);
    // D block: (D0 + D1 v), v^2 = -1
    uint64_t adc, a0, a1, bdc, b0, b1;
    pg_f3(D0[0], D0[1], D0[2], adc, a0, a1);
    pg_f3(D1[0], D1[1], D1[2], bdc, b0, b1);
    uint64_t g0 = PG_K(PG_KD_DC0) * adc - PG_K(PG_KD_DC1) * bdc;
    uint64_t g1 = PG_K(PG_KD_DC1) * adc + PG_K(PG_KD_DC0) * bdc;
    uint64_t q00, q01, q11a, q11b, q01a, q01b, q10a, q10b;
    pg_eis<PG_KD_E00, PG_KD_E01>(a0, a1, q00, q01);    // A K0
    pg_eis<PG_KD_E10, PG_KD_E11>(b0, b1, q11a, q11b);  // B K1
    pg_eis<PG_KD_E10, PG_KD_E11>(a0, a1, q01a, q01b);  // A K1
    pg_eis<PG_KD_E00, PG_KD_E01>(b0, b1, q10a, q10b);  // B K0
    uint64_t d0h[3], d1h[3];
    pg_i3(g0, q00 - q11a, q01 - q11b, d0h);
    pg_i3(g1, q01a + q10a, q01b + q10b, d1h);
#pragma unroll
    for (int u = 0; u < 3; ++u) {
        uint64_t p = sh[u] + th[u], m = sh[u] - th[u];
        y[(4 * u) % 12] = p + d0h[u];
        y[(4 * u + 18) % 12] = p - d0h[u];
        y[(4 * u + 9) % 12] = m + d1h[u];
        y[(4 * u + 27) % 12] = m - d1h[u];
    }
}

// in: al, ah < 2^43.  out: lazy, congruent to al + 2^32 ah.
// al + 2^32 ah = l + 2^64 h with h = (ah >> 32) + carry < 2^11 + 1.
__device__ __forceinline__ uint64_t pg_fold(uint64_t al, uint64_t ah) {
    uint64_t l = al + (ah << 32);
    uint32_t h = (uint32_t)(ah >> 32) + (l < al ? 1u : 0u);
    return gl_reduce96_lazy(l, h);
}

// in: s[] lazy; rc[] canonical.  out: s[] lazy, s <- M s + rc, where M is
// the circulant plus PG_MDS_DIAG0 on M[0][0].  The product is taken on the
// 32-bit halves: each half-sum is < 2^40 + 2^35, plus a half of rc < 2^32.
__device__ __forceinline__ void pg_mds_rc(uint64_t s[PG_WIDTH],
                                          const uint64_t* rc) {
    uint64_t lo[PG_WIDTH], hi[PG_WIDTH], ylo[PG_WIDTH], yhi[PG_WIDTH];
#pragma unroll
    for (int j = 0; j < PG_WIDTH; ++j) {
        lo[j] = s[j] & 0xFFFFFFFFULL;
        hi[j] = s[j] >> 32;
    }
    pg_circ_half(lo, ylo);
    pg_circ_half(hi, yhi);
    ylo[0] += PG_MDS_DIAG0 * lo[0];
    yhi[0] += PG_MDS_DIAG0 * hi[0];
#pragma unroll
    for (int i = 0; i < PG_WIDTH; ++i)
        s[i] = pg_fold(ylo[i] + (rc[i] & 0xFFFFFFFFULL), yhi[i] + (rc[i] >> 32));
}

// in: s[] lazy.  out: s[] lazy.  S-box on every lane, then M s + rc_next.
__device__ __forceinline__ void pg_full_round(uint64_t s[PG_WIDTH],
                                              const uint64_t* rc_next) {
#pragma unroll
    for (int i = 0; i < PG_WIDTH; ++i) s[i] = gl_pow7_lazy(s[i]);
    pg_mds_rc(s, rc_next);
}

// in: s[] lazy.  out: s[] lazy.  S-box on lane 0, then M s + rc_next.
__device__ __forceinline__ void pg_partial_round(uint64_t s[PG_WIDTH],
                                                 const uint64_t* rc_next) {
    s[0] = gl_pow7_lazy(s[0]);
    pg_mds_rc(s, rc_next);
}

// in: s[] any words.  out: s[] lazy (gl_canon what is written out).
// Round r is  s <- M sbox(s + RC[r]);  here RC[r + 1] is added inside round
// r's linear layer, RC[0] before the first round.
__device__ __forceinline__ void pg_permute_lazy(uint64_t s[PG_WIDTH]) {
#pragma unroll
    for (int i = 0; i < PG_WIDTH; ++i) s[i] = gl_add_lazy(s[i], PG_RC[i]);
#pragma unroll 1
    for (int r = 0; r < PG_HALF_FULL; ++r)
        pg_full_round(s, PG_RC + (r + 1) * PG_WIDTH);
#pragma unroll 1
    for (int r = PG_HALF_FULL; r < PG_HALF_FULL + PG_PARTIAL; ++r)
        pg_partial_round(s, PG_RC + (r + 1) * PG_WIDTH);
#pragma unroll 1
    for (int r = PG_HALF_FULL + PG_PARTIAL; r < PG_ROUNDS; ++r)
        pg_full_round(s, PG_RC + (r + 1) * PG_WIDTH);
}

// state: (12, B) lane-major words in [0, 2^64): word i of state k at
// i * B + k, the layout of the reference's permute_tpu.  out: (12, B)
// canonical, same layout.  One thread per state: for each word the threads of
// a warp read and write 32 neighbouring addresses, so every access is
// coalesced.
__global__ void __launch_bounds__(PG_PERMUTE_THREADS)
pg_permute_kernel(const uint64_t* __restrict__ state, uint64_t* __restrict__ out,
                  long long b) {
    long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= b) return;
    uint64_t s[PG_WIDTH];
#pragma unroll
    for (int i = 0; i < PG_WIDTH; ++i) s[i] = state[i * b + k];
    pg_permute_lazy(s);
#pragma unroll
    for (int i = 0; i < PG_WIDTH; ++i) out[i * b + k] = gl_canon(s[i]);
}

// S1, the PoseidonG state machine's round trace (no Pallas counterpart: the
// reference fills it in python ints, executor/sm/poseidon_g_executor.py:25,
// 55-76).  state: (12, S) lane-major words in [0, 2^64), slot k's word i at
// i * S + k.  out: 16 columns of n words, column c at c * n; slot k owns rows
// k * 31 .. k * 31 + 30.  Row 0 holds the input reduced mod p; row r + 1 the
// canonical state after round r, M sbox(s + RC[r]); columns 12..15 hold row
// 30's first four words (the digest) on each of the slot's 31 rows.  The
// caller zeroes the rows past 31 * S.
//
// K1's round functions with the zero constant row (PG_RC row PG_ROUNDS) in
// the linear layer, so that the state written after round r does not carry
// RC[r + 1]; the next round adds its own constant first.  One thread per
// slot: the reads are coalesced as in K1, but a warp's stores of one row land
// 31 words apart (one sector each).  The work is bound by the bytes written
// (16 words a row), not by the 118 S-boxes a slot.
__global__ void __launch_bounds__(PG_TRACE_THREADS)
pg_trace_kernel(const uint64_t* __restrict__ state, uint64_t* __restrict__ out,
                long long slots, long long n) {
    long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= slots) return;
    uint64_t* rows = out + k * PG_SLOT_ROWS;
    const uint64_t* zero_rc = PG_RC + PG_ROUNDS * PG_WIDTH;
    uint64_t s[PG_WIDTH];
#pragma unroll
    for (int i = 0; i < PG_WIDTH; ++i) {
        s[i] = gl_canon(state[i * slots + k]);
        rows[i * n] = s[i];
    }
#pragma unroll 1
    for (int r = 0; r < PG_ROUNDS; ++r) {
#pragma unroll
        for (int i = 0; i < PG_WIDTH; ++i)
            s[i] = gl_add_lazy(s[i], PG_RC[r * PG_WIDTH + i]);
        if (r < PG_HALF_FULL || r >= PG_HALF_FULL + PG_PARTIAL)
            pg_full_round(s, zero_rc);
        else
            pg_partial_round(s, zero_rc);
#pragma unroll
        for (int i = 0; i < PG_WIDTH; ++i) {
            s[i] = gl_canon(s[i]);
            rows[i * n + r + 1] = s[i];
        }
    }
#pragma unroll
    for (int h = 0; h < PG_CAP; ++h)
#pragma unroll 1
        for (int r = 0; r < PG_SLOT_ROWS; ++r) rows[(PG_WIDTH + h) * n + r] = s[h];
}

// rows: (H, W) row-major words in [0, 2^64), W > 4.  out: (H, 4) canonical.
// One thread per row: capacity starts at zero; per rate-8 chunk the state
// is [chunk | capacity], the last chunk zero-padded; the new capacity is
// lanes 0..3 of the permuted state, kept lazy until it is written.
__global__ void __launch_bounds__(PG_LINEAR_HASH_THREADS)
pg_linear_hash_kernel(const uint64_t* __restrict__ rows,
                      uint64_t* __restrict__ out, long long h, int w) {
    long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= h) return;
    const uint64_t* p = rows + row * (long long)w;
    uint64_t s[PG_WIDTH];
    uint64_t cap[PG_CAP] = {0, 0, 0, 0};
    for (int off = 0; off < w; off += PG_RATE) {
#pragma unroll
        for (int k = 0; k < PG_RATE; ++k) s[k] = (off + k < w) ? p[off + k] : 0;
#pragma unroll
        for (int k = 0; k < PG_CAP; ++k) s[PG_RATE + k] = cap[k];
        pg_permute_lazy(s);
#pragma unroll
        for (int k = 0; k < PG_CAP; ++k) cap[k] = s[k];
    }
#pragma unroll
    for (int k = 0; k < PG_CAP; ++k) out[row * 4 + k] = gl_canon(cap[k]);
}

// left, right: n digests of 4 words each, digest i at left + i * stride and
// right + i * stride (stride in words).  out: (n, 4) canonical, dense.
// out[i] = permute([left_i | right_i | 0 0 0 0])[:4].
// With right = left + 4 and stride = 8 this hashes one tree level in place
// out of the level below; out may lie in the same array, beyond the inputs.
__global__ void __launch_bounds__(PG_NODE_HASH_THREADS)
pg_node_hash_kernel(const uint64_t* __restrict__ left,
                    const uint64_t* __restrict__ right, long long stride,
                    uint64_t* __restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint64_t s[PG_WIDTH];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        s[k] = left[i * stride + k];
        s[4 + k] = right[i * stride + k];
        s[8 + k] = 0;
    }
    pg_permute_lazy(s);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[i * 4 + k] = gl_canon(s[k]);
}

// ---------------------------------------------------------------------------
// One state over a group of PG_GROUP threads.  Thread t of a group holds
// lane t of its state for t < 12; threads 12..15 mirror lanes 0..3 (same
// values, never stored), so no thread of a warp idles in the shuffles.  The
// S-box of a lane runs on its own thread; the linear layer gathers the other
// 11 lanes with __shfl_sync inside the group (mask: the group's 16 threads,
// so a group may run alone while the other group of its warp has no pair).
// ---------------------------------------------------------------------------

#define PG_GROUP 16
// Groups of the top kernel's one block: a bound of 256 threads leaves the
// compiler the registers it needs (at 1024 it spilled).
#define PG_TOP_MAX_GROUPS 16

// in: xl, xh the halves of lane `lane` of the group's state.  out: the
// halves' sums for this lane's row of M, sum_d CIRC[d] x_{(lane + d) mod 12}
// (+ PG_MDS_DIAG0 x_0 on lane 0), each < 2^40 + 2^35.  Three partial sums
// keep the dependent chain of multiply-adds short.
__device__ __forceinline__ void pg_group_row(uint32_t xl, uint32_t xh, int lane,
                                             unsigned mask, uint64_t& al,
                                             uint64_t& ah) {
    uint64_t l[3] = {(uint64_t)PG_CIRC[0] * xl, 0, 0};
    uint64_t h[3] = {(uint64_t)PG_CIRC[0] * xh, 0, 0};
#pragma unroll
    for (int d = 1; d < PG_WIDTH; ++d) {
        int src = lane + d >= PG_WIDTH ? lane + d - PG_WIDTH : lane + d;
        uint32_t yl = __shfl_sync(mask, xl, src, PG_GROUP);
        uint32_t yh = __shfl_sync(mask, xh, src, PG_GROUP);
        l[d % 3] += (uint64_t)PG_CIRC[d] * yl;
        h[d % 3] += (uint64_t)PG_CIRC[d] * yh;
    }
    if (lane == 0) {
        l[0] += (uint64_t)PG_MDS_DIAG0 * xl;
        h[0] += (uint64_t)PG_MDS_DIAG0 * xh;
    }
    al = l[0] + l[1] + l[2];
    ah = h[0] + h[1] + h[2];
}

// A full round on one lane.  in: x lazy; rc canonical (this lane's constant
// of the next round).  out: lane `lane` of M sbox(x) + rc, lazy.
__device__ __forceinline__ uint64_t pg_group_full_round(uint64_t x, int lane,
                                                        uint64_t rc,
                                                        unsigned mask) {
    x = gl_pow7_lazy(x);
    uint64_t al, ah;
    pg_group_row((uint32_t)x, (uint32_t)(x >> 32), lane, mask, al, ah);
    return pg_fold(al + (rc & 0xFFFFFFFFULL), ah + (rc >> 32));
}

// A partial round: only lane 0 goes through the S-box, so the row sums over
// the lanes as they were before it do not wait for it; lane 0's change is
// added after: out_i += M[i][0] (x7_0 - x_0), on the halves, m0 = M[i][0].
// The halves of the change are signed (> -2^32, < 2^32) and the corrected
// half-sums are the true ones, in [0, 2^41), so wrapping arithmetic is exact.
// in: x lazy.  out: lane `lane` of M sbox_0(x) + rc, lazy.
__device__ __forceinline__ uint64_t pg_group_partial_round(uint64_t x, int lane,
                                                           uint32_t m0,
                                                           uint64_t rc,
                                                           unsigned mask) {
    uint64_t x7 = gl_pow7_lazy(x);
    uint32_t xl = (uint32_t)x, xh = (uint32_t)(x >> 32);
    uint64_t al, ah;
    pg_group_row(xl, xh, lane, mask, al, ah);
    uint64_t dl = (x7 & 0xFFFFFFFFULL) - xl, dh = (x7 >> 32) - xh;
    dl = __shfl_sync(mask, dl, 0, PG_GROUP);
    dh = __shfl_sync(mask, dh, 0, PG_GROUP);
    return pg_fold(al + m0 * dl + (rc & 0xFFFFFFFFULL),
                   ah + m0 * dh + (rc >> 32));
}

// in: x any word (lane `lane`); rc this lane's column of the round
// constants (row r at rc[r * 12]), in global or shared memory.  out: lane
// `lane` of the permuted state, lazy.
__device__ __forceinline__ uint64_t pg_group_permute_lazy(uint64_t x, int lane,
                                                          const uint64_t* rc,
                                                          unsigned mask) {
    uint32_t m0 = lane == 0 ? PG_CIRC[0] + PG_MDS_DIAG0 : PG_CIRC[PG_WIDTH - lane];
    x = gl_add_lazy(x, rc[0]);
#pragma unroll 1
    for (int r = 0; r < PG_HALF_FULL; ++r)
        x = pg_group_full_round(x, lane, rc[(r + 1) * PG_WIDTH], mask);
#pragma unroll 1
    for (int r = PG_HALF_FULL; r < PG_HALF_FULL + PG_PARTIAL; ++r)
        x = pg_group_partial_round(x, lane, m0, rc[(r + 1) * PG_WIDTH], mask);
#pragma unroll 1
    for (int r = PG_HALF_FULL + PG_PARTIAL; r < PG_ROUNDS; ++r)
        x = pg_group_full_round(x, lane, rc[(r + 1) * PG_WIDTH], mask);
    return x;
}

__device__ __forceinline__ int pg_group_lane() {
    int t = threadIdx.x & (PG_GROUP - 1);
    return t < PG_WIDTH ? t : t - PG_WIDTH;
}

__device__ __forceinline__ unsigned pg_group_mask() {
    return 0xFFFFu << (threadIdx.x & 16);
}

// The contract of pg_node_hash_kernel, one pair per group of 16 threads.
__global__ void __launch_bounds__(PG_NODE_GROUP_THREADS)
pg_node_hash_group_kernel(const uint64_t* __restrict__ left,
                          const uint64_t* __restrict__ right, long long stride,
                          uint64_t* __restrict__ out, long long n) {
    long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / PG_GROUP;
    if (i >= n) return;  // the whole group leaves together
    int t = threadIdx.x & (PG_GROUP - 1), lane = pg_group_lane();
    uint64_t x = lane < 4 ? left[i * stride + lane]
               : lane < 8 ? right[i * stride + lane - 4] : 0;
    x = pg_group_permute_lazy(x, lane, PG_RC_GLOBAL + lane, pg_group_mask());
    if (t < 4) out[i * 4 + t] = gl_canon(x);
}

// nodes: a tree level of n = 2^k >= 2 digests, dense (n, 4), followed in
// memory by room for the n - 1 digests of the levels above it (the
// (2h-1, 4) node array of merkle_levels_).  One block hashes level after
// level up to the root: each group takes pairs i = g, g + G, ... of the
// level; __syncthreads() between levels makes a level's stores visible to
// the whole block before the next level reads them.
__global__ void __launch_bounds__(PG_TOP_MAX_GROUPS * PG_GROUP)
pg_merkle_top_kernel(uint64_t* nodes, long long n) {
    // the block reuses the constants level after level: one copy in shared
    // memory (on the card, cheaper per level than reads of the global copy)
    __shared__ uint64_t rc_s[(PG_ROUNDS + 1) * PG_WIDTH];
    for (int k = threadIdx.x; k < (PG_ROUNDS + 1) * PG_WIDTH; k += blockDim.x)
        rc_s[k] = PG_RC_GLOBAL[k];
    __syncthreads();
    int t = threadIdx.x & (PG_GROUP - 1), lane = pg_group_lane();
    int g = threadIdx.x / PG_GROUP, groups = blockDim.x / PG_GROUP;
    unsigned mask = pg_group_mask();
    uint64_t* in = nodes;
    for (long long m = n; m > 1; m >>= 1) {
        uint64_t* out = in + m * 4;
        for (long long i = g; i < m / 2; i += groups) {
            uint64_t x = lane < 8 ? in[i * 8 + lane] : 0;
            x = pg_group_permute_lazy(x, lane, rc_s + lane, mask);
            if (t < 4) out[i * 4 + t] = gl_canon(x);
        }
        __syncthreads();
        in = out;
    }
}

extern "C" int merlin_poseidon_set_constants(const uint64_t* rc) {
    cudaError_t e = cudaMemcpyToSymbol(PG_RC, rc, sizeof(uint64_t) * PG_ROUNDS * PG_WIDTH);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemcpyToSymbol(PG_RC_GLOBAL, rc,
                                   sizeof(uint64_t) * PG_ROUNDS * PG_WIDTH);
}

extern "C" int merlin_permute(const void* state, void* out, long long b,
                              void* stream) {
    if (b <= 0) return 0;
    const int threads = PG_PERMUTE_THREADS;
    long long blocks = (b + threads - 1) / threads;
    pg_permute_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)state, (uint64_t*)out, b);
    return (int)cudaGetLastError();
}

// state: (12, slots) lane-major; out: 16 columns of n >= 31 * slots words.
extern "C" int merlin_poseidon_trace(const void* state, void* out,
                                     long long slots, long long n,
                                     void* stream) {
    if (slots <= 0) return 0;
    if (n < slots * PG_SLOT_ROWS) return (int)cudaErrorInvalidValue;
    const int threads = PG_TRACE_THREADS;
    long long blocks = (slots + threads - 1) / threads;
    pg_trace_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)state, (uint64_t*)out, slots, n);
    return (int)cudaGetLastError();
}

extern "C" int merlin_linear_hash(const void* rows, void* out, long long h,
                                  int w, void* stream) {
    if (h <= 0) return 0;
    const int threads = PG_LINEAR_HASH_THREADS;
    long long blocks = (h + threads - 1) / threads;
    pg_linear_hash_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)rows, (uint64_t*)out, h, w);
    return (int)cudaGetLastError();
}

extern "C" int merlin_node_hash(const void* left, const void* right,
                                long long stride, void* out, long long n,
                                void* stream) {
    if (n <= 0) return 0;
    const int threads = PG_NODE_HASH_THREADS;
    long long blocks = (n + threads - 1) / threads;
    pg_node_hash_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)left, (const uint64_t*)right, stride, (uint64_t*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int merlin_node_hash_group(const void* left, const void* right,
                                      long long stride, void* out, long long n,
                                      void* stream) {
    if (n <= 0) return 0;
    const int threads = PG_NODE_GROUP_THREADS;
    long long blocks = (n * PG_GROUP + threads - 1) / threads;
    pg_node_hash_group_kernel<<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
        (const uint64_t*)left, (const uint64_t*)right, stride, (uint64_t*)out, n);
    return (int)cudaGetLastError();
}

// nodes: a level of n digests (n a power of two, 2 <= n) and the room above
// it.  One group per pair of that level, at most PG_TOP_MAX_GROUPS.
extern "C" int merlin_merkle_top(void* nodes, long long n, void* stream) {
    if (n < 2) return (int)cudaErrorInvalidValue;
    int groups = n / 2 < PG_TOP_MAX_GROUPS ? (int)(n / 2) : PG_TOP_MAX_GROUPS;
    pg_merkle_top_kernel<<<1, groups * PG_GROUP, 0, (cudaStream_t)stream>>>(
        (uint64_t*)nodes, n);
    return (int)cudaGetLastError();
}
