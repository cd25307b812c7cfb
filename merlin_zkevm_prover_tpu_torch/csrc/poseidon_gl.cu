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
// S1: warps a block.  Each warp runs 32 runs of slots, one a lane, and keeps
// its rows in pools of its own in shared memory (pg_trace_kernel).
#define PG_TRACE_WARPS 4
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
// i * S + k.  out: 16 columns of n >= 31 S words, column c at c * n; slot k
// owns rows k * 31 .. k * 31 + 30.  Row 0 holds the input reduced mod p; row
// r + 1 the canonical state after round r, M sbox(s + RC[r]); columns 12..15
// hold row 30's first four words (the digest) on each of the slot's 31 rows;
// rows 31 S .. n - 1 are zero (the kernel writes them).
//
// Bound: the bytes, 16 words written a row and 12 read a slot (the 118
// S-boxes a slot take a tenth of that time).  The compute is K1's: one lane
// a slot, the 12-word state in registers, K1's round functions with the zero
// constant row (PG_RC row PG_ROUNDS) in the linear layer, so that the state
// written after round r does not carry RC[r + 1]; each round adds its own
// constant first.  Each word is canonicalised once, where it is staged.
//
// The stores.  Stored as computed, a warp's 32 words of one row land 31
// words apart, and each 128-B line of a column fills over 16 rounds while
// every resident thread keeps a dozen lines open: 1 GB of part-written
// lines at 2^23 rows against a 50 MB L2.  Here each lane runs a contiguous
// run of slots one after the other, so that its rows in each column are one
// contiguous stream, and stages each row in shared memory until the row's
// line (16 rows, row & 15 its place) is complete; then its half-warp stores
// the line: 16 consecutive lanes on its 16 consecutive words, both halves
// together (two lines a store), whole lines where n is a multiple of 16.
// The digest columns are stored at each slot's end, from the 4 digest words
// of the slot and of the one before it, shuffled from the lane that owns
// them.  A line shared by two streams is stored in two parts, one by each
// lane; the last stream's last line is stored with its dead rows as zeros,
// and the dead rows after it by every thread at the end.
//
// The pools.  A ring of 16 rows a column for each lane (1.5 KB) would leave
// room for 4 warps an SM, too few to hide a round's latency.  But a run is
// odd, so the 16 lanes of a half-warp start their streams on rows 31 run
// apart, distinct mod 16: at each step (one row for every lane) each lane
// is at another place f of its open line, one lane's line completes and
// another's starts.  Row f of a line lives 16 - f steps (until its line is
// stored), so a pool of 16 - f entries holds row f for the whole half-warp,
// the entry written at step tau being tau mod (16 - f): 136 words a column
// where 16 rings take 256.  Two columns' pools fill a 17 x 16 array of
// words: the even column's entry s of row f at 16 s + f, the odd column's at
// 16 (16 - s) + 15 - f (the two triangles s + f <= 15 and s + f >= 16 do
// not meet).  The lanes of a half-warp write, and the lanes of a store read,
// 16 distinct rows f, so each 64-bit access takes 16 distinct bank pairs
// (tests/test_torch_sm_executors.py counts them).  816 bytes a lane: 8
// warps an SM.
#define PG_LINE 16                                   // words in a 128-B line
#define PG_TRI_WORDS (PG_LINE * (PG_LINE + 1))       // two columns' pools
#define PG_HALF_WORDS (PG_WIDTH / 2 * PG_TRI_WORDS)  // a half-warp's pools
#define PG_TRACE_THREADS (32 * PG_TRACE_WARPS)
#define PG_TRACE_SMEM ((size_t)PG_TRACE_WARPS * 2 * PG_HALF_WORDS * 8)

extern __shared__ __align__(16) uint64_t pg_trace_smem[];

// The word of entry s of row f of a column's pool in its pair's array.
__device__ __forceinline__ int pg_pool_word(int s, int f, int odd) {
    return odd ? PG_LINE * (PG_LINE - s) + (PG_LINE - 1 - f) : PG_LINE * s + f;
}

// x mod m for 0 <= x < 2^22, 1 <= m <= 16, rm = 1 / m (a float product and
// one correction instead of an integer division).
__device__ __forceinline__ int pg_mod(int x, int m, float rm) {
    int r = x - m * __float2int_rz((float)x * rm);
    r += r < 0 ? m : 0;
    return r >= m ? r - m : r;
}

__global__ void __launch_bounds__(PG_TRACE_THREADS)
pg_trace_kernel(const uint64_t* __restrict__ state, uint64_t* __restrict__ out,
                long long slots, long long n, int run) {
    const int lane = threadIdx.x & 31;
    const int e = lane & (PG_LINE - 1);  // a store's row in its line
    const int odd = lane >> 4;           // the lane's half-warp; in a store,
                                         // the odd column of each pair
    const unsigned half = odd ? 0xFFFF0000u : 0x0000FFFFu;
    const float re = 1.0f / (PG_LINE - e);
    const long long t = (long long)blockIdx.x * PG_TRACE_THREADS + threadIdx.x;
    const long long k0 = t * run;  // the lane's first slot
    const int rows = run * PG_SLOT_ROWS;  // a stream's rows
    // this half-warp's pools
    uint64_t* pool = pg_trace_smem + (threadIdx.x >> 4) * PG_HALF_WORDS;
    const long long s_rows = slots * PG_SLOT_ROWS;
    // 12 state words of row `at` from the pools (entry sl of row e), or
    // zeros for a dead row
    auto put_line = [&](long long at, bool dead, int sl) {
        const int w[2] = {pg_pool_word(sl, e, 0), pg_pool_word(sl, e, 1)};
        uint64_t* o = out + at;
#pragma unroll
        for (int c = 0; c < PG_WIDTH; ++c)
            o[c * n] = dead ? 0 : pool[(c >> 1) * PG_TRI_WORDS + w[c & 1]];
    };
    auto put_digest = [&](long long at, int h, uint64_t v) {
        out[(PG_WIDTH + h) * n + at] = v;
    };
    if ((t - lane) * run < slots) {  // warp-uniform: the warp has a slot
        const uint64_t* zero_rc = PG_RC + PG_ROUNDS * PG_WIDTH;
        // this lane's stream: rows [lo, hi); a lane j of its half-warp
        // starts at lo + (j - lane) rows, its stream ends at the same
        // distance or at 31 S
        const long long lo = k0 * PG_SLOT_ROWS;
        const long long hi = max(lo, min(lo + rows, s_rows));
        // the half's first stream start mod 16, and 1 / rows mod 16 (rows
        // is odd: its inverse is rows^7)
        const int h0 = (int)((lo - (long long)e * rows) & (PG_LINE - 1));
        const int r16 = rows & (PG_LINE - 1);
        const int inv = r16 * r16 * r16 * r16 * r16 * r16 * r16 & (PG_LINE - 1);
        uint64_t s[PG_WIDTH], prev[PG_CAP] = {0, 0, 0, 0};
#pragma unroll 1
        for (int i = 0; i < run; ++i) {
            const long long base = lo + (long long)i * PG_SLOT_ROWS;
            const bool live = base < hi;
#pragma unroll
            for (int j = 0; j < PG_WIDTH; ++j)
                s[j] = live ? gl_canon(state[j * slots + k0 + i]) : 0;
#pragma unroll 1
            for (int r = 0; r < PG_SLOT_ROWS; ++r) {
                if (r) {
                    // round r - 1: s <- M sbox(s + RC[r - 1]), canonical
#pragma unroll
                    for (int j = 0; j < PG_WIDTH; ++j)
                        s[j] = gl_add_lazy(s[j], PG_RC[(r - 1) * PG_WIDTH + j]);
                    if (r - 1 < PG_HALF_FULL || r - 1 >= PG_HALF_FULL + PG_PARTIAL)
                        pg_full_round(s, zero_rc);
                    else
                        pg_partial_round(s, zero_rc);
#pragma unroll
                    for (int j = 0; j < PG_WIDTH; ++j) s[j] = gl_canon(s[j]);
                }
                const int tau = i * PG_SLOT_ROWS + r;  // the step
                const int f = (int)((base + r) & (PG_LINE - 1));
                if (live) {
                    const int sl = pg_mod(tau, PG_LINE - f,
                                          __fdividef(1.0f, (float)(PG_LINE - f)));
                    const int w[2] = {pg_pool_word(sl, f, 0), pg_pool_word(sl, f, 1)};
#pragma unroll
                    for (int c = 0; c < PG_WIDTH; ++c)
                        pool[(c >> 1) * PG_TRI_WORDS + w[c & 1]] = s[c];
                }
                __syncwarp();
                // The lines that this row completes: each half-warp stores
                // those of its lanes, both halves together, two lines a
                // store.  At every step one lane of a half is at row 15 of
                // its line (the phases are distinct): j15, found by
                // arithmetic.  Its line lies inside its stream but in the
                // stream's first 15 steps; those first lines, and the
                // part-lines at a stream's end, take the general loop.
                {
                    const int j15 = ((PG_LINE - 1 - tau - h0) * inv) & (PG_LINE - 1);
                    const long long src_lo = lo + (long long)(j15 - e) * rows;
                    if (tau >= PG_LINE - 1 && src_lo + i * PG_SLOT_ROWS < s_rows)
                        put_line(src_lo + tau - (PG_LINE - 1) + e, false,
                                 pg_mod(tau + 1, PG_LINE - e, re));
                }
                // (a stream's first line ends in its first 15 steps, and a
                // stream ends on a slot's last row)
                unsigned mh = 0;
                if (tau < PG_LINE - 1 || r == PG_SLOT_ROWS - 1)
                    mh = __ballot_sync(0xFFFFFFFFu,
                                       live && (f == PG_LINE - 1 ? tau < PG_LINE - 1
                                                                 : base + r + 1 == hi)) &
                         half;
                while (__any_sync(0xFFFFFFFFu, mh)) {
                    if (!mh) continue;
                    const int src = __ffs(mh) - 1;
                    mh &= mh - 1;
                    const long long src_lo = lo + (long long)(src - lane) * rows;
                    const long long src_hi = min(src_lo + rows, s_rows);
                    const int fs = (int)((src_lo + tau) & (PG_LINE - 1));
                    const long long at = src_lo + tau - fs + e;  // this lane's row
                    if (at < src_lo || at >= n || (at >= src_hi && at < s_rows))
                        continue;  // another stream's row, or none
                    // row e of the line was staged at step tau - fs + e
                    const bool dead = at >= src_hi;
                    put_line(at, dead, dead ? 0 : pg_mod(tau - fs + e, PG_LINE - e, re));
                }
                __syncwarp();
            }
            // The digest: row 30's first four words.  Store the digest lines
            // that end in this slot and, at the stream's end, the line that
            // holds its last row: lines q = 0, 1, 2 from the first line end
            // at or after the slot's first row, each half-warp its own.  The
            // loop over the 16 lanes of a half stores its lines 0 and 1
            // where they lie inside the stream; the general loop the first
            // slot's line 0 and the stream's last line.
            uint64_t cur[PG_CAP];
#pragma unroll
            for (int h = 0; h < PG_CAP; ++h) cur[h] = s[h];
            const int x1 = PG_LINE - 1 - (int)(base & (PG_LINE - 1));  // + base
#pragma unroll 1
            for (int jj = 0; jj < PG_LINE; ++jj) {
                const int src = (lane & PG_LINE) + jj;
                const long long sb = lo + (long long)(jj - e) * rows + i * PG_SLOT_ROWS;
                const int sx1 = PG_LINE - 1 - (int)(sb & (PG_LINE - 1));
                const bool on = sb < s_rows;
                uint64_t vp[PG_CAP], vc[PG_CAP];
#pragma unroll
                for (int h = 0; h < PG_CAP; ++h) {
                    vp[h] = __shfl_sync(0xFFFFFFFFu, prev[h], src);
                    vc[h] = __shfl_sync(0xFFFFFFFFu, cur[h], src);
                }
                if (on && (i > 0 || sx1 == PG_LINE - 1)) {
                    const long long at = sb + sx1 - (PG_LINE - 1) + e;
                    const bool before = e < PG_LINE - 1 - sx1;  // at < sb
#pragma unroll
                    for (int h = 0; h < PG_CAP; ++h)
                        put_digest(at, h, before ? vp[h] : vc[h]);
                }
                if (on && sx1 + PG_LINE <= PG_SLOT_ROWS - 1) {
#pragma unroll
                    for (int h = 0; h < PG_CAP; ++h)
                        put_digest(sb + sx1 + 1 + e, h, vc[h]);
                }
            }
            const bool second = x1 + PG_LINE <= PG_SLOT_ROWS - 1;
            const bool tail = live && base + PG_SLOT_ROWS == hi &&
                              ((base + PG_SLOT_ROWS) & (PG_LINE - 1)) != 0;
#pragma unroll 1
            for (int q = 0; q < 3 && __any_sync(0xFFFFFFFFu, live && (i == 0 || tail));
                 ++q) {
                unsigned mh = __ballot_sync(
                    0xFFFFFFFFu, live && ((q == 0 && i == 0 && x1 != PG_LINE - 1) ||
                                          (tail && q == 1 + second))) & half;
                while (__any_sync(0xFFFFFFFFu, mh)) {
                    const bool act = mh != 0;
                    const int src = act ? __ffs(mh) - 1 : lane;
                    mh &= mh - 1;
                    const long long src_lo = lo + (long long)(src - lane) * rows;
                    const long long src_hi = min(src_lo + rows, s_rows);
                    const long long sb = src_lo + (long long)i * PG_SLOT_ROWS;
                    const long long at = sb + (PG_LINE - 1 - (int)(sb & (PG_LINE - 1))) +
                                         PG_LINE * q - (PG_LINE - 1) + e;
                    const bool ok = act && at >= src_lo && at < n &&
                                    (at < src_hi || at >= s_rows);
#pragma unroll
                    for (int h = 0; h < PG_CAP; ++h) {
                        const uint64_t vp = __shfl_sync(0xFFFFFFFFu, prev[h], src);
                        const uint64_t vc = __shfl_sync(0xFFFFFFFFu, cur[h], src);
                        if (ok) put_digest(at, h, at >= src_hi ? 0 : at < sb ? vp : vc);
                    }
                }
            }
#pragma unroll
            for (int h = 0; h < PG_CAP; ++h) prev[h] = cur[h];
        }
    }
    // the dead rows after the line that holds row 31 S - 1
    const long long z0 = min(n, (s_rows + PG_LINE - 1) & ~(long long)(PG_LINE - 1));
    const long long dead = n - z0;
    const long long all = (long long)gridDim.x * PG_TRACE_THREADS;
    for (long long k = t; k < dead * (PG_WIDTH + PG_CAP); k += all)
        out[(k / dead) * n + z0 + k % dead] = 0;
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

// S1's launch for `slots` slots: thread t runs slots [t * run, (t + 1) *
// run), `run` odd (the pools need it) and below 2^22 / 31 (pg_mod's range);
// `run` 0 takes the fewest slots a lane that lets every lane be resident on
// the current device at once, made odd.  plan: the run, the blocks of
// PG_TRACE_THREADS that cover every slot, PG_TRACE_THREADS.
static cudaError_t pg_trace_plan(long long slots, int run, long long* plan) {
    cudaError_t e = cudaFuncSetAttribute(
        pg_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)PG_TRACE_SMEM);
    if (e != cudaSuccess) return e;
    if (slots <= 0 || run < 0) return cudaErrorInvalidValue;
    if (run == 0) {
        int per_sm = 0, dev = 0, sms = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, pg_trace_kernel, PG_TRACE_THREADS, PG_TRACE_SMEM);
        if (e != cudaSuccess) return e;
        e = cudaGetDevice(&dev);
        if (e != cudaSuccess) return e;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return e;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        const long long lanes = (long long)PG_TRACE_THREADS * per_sm * sms;
        const long long r = (slots + lanes - 1) / lanes;
        if (r >= (1 << 22)) return cudaErrorInvalidValue;
        run = (int)(r + 1 - r % 2);
    }
    if (run % 2 == 0 || (long long)run * PG_SLOT_ROWS + PG_LINE > (1 << 22))
        return cudaErrorInvalidValue;
    plan[0] = run;
    plan[1] = ((slots + run - 1) / run + PG_TRACE_THREADS - 1) / PG_TRACE_THREADS;
    plan[2] = PG_TRACE_THREADS;
    return cudaSuccess;
}

extern "C" int merlin_poseidon_trace_plan(long long slots, int run,
                                          long long* plan) {
    return (int)pg_trace_plan(slots, run, plan);
}

// state: (12, slots) lane-major; out: 16 columns of n >= 31 * slots words;
// run as in pg_trace_plan (0: its choice).
extern "C" int merlin_poseidon_trace(const void* state, void* out,
                                     long long slots, long long n, int run,
                                     void* stream) {
    if (slots <= 0 || n < slots * PG_SLOT_ROWS) return (int)cudaErrorInvalidValue;
    long long plan[3];
    cudaError_t e = pg_trace_plan(slots, run, plan);
    if (e != cudaSuccess) return (int)e;
    pg_trace_kernel<<<(unsigned)plan[1], PG_TRACE_THREADS, PG_TRACE_SMEM,
                      (cudaStream_t)stream>>>((const uint64_t*)state,
                                              (uint64_t*)out, slots, n,
                                              (int)plan[0]);
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
