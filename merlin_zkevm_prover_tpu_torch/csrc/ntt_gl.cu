// Goldilocks block NTT for Hopper: the transform of length L = 2^log_l
// (L <= 512) along the rows of a matrix, every column at once, with the
// pipeline's epilogues and its mid gather fused in.
//
// Replaces three Pallas kernels of merlin_zkevm_prover_tpu/ops/ntt_tpu.py:
// _ntt_kernel (:192, DIT of a bit-reversed block, no epilogue),
// _ntt_kernel_v2 (:517, the pipeline's block at L < 16) and _ntt_kernel_v3
// (:736, the pipeline's block at L = 16 .. 512).
//
// What bounds it on this card.  A length-L transform does (L/2) log2 L
// butterflies a column, one field product each, and moves 16 bytes an
// element.  At L = 512 the bytes bound it at 3.35 TB/s, but the integer
// instructions come close: by a count of the source (not of the SASS), a
// butterfly is some 45 instructions (the 64 x 64 -> 128-bit product and
// its reduction some 30), some 250 an element, 1.8e9 for a (512, 13824)
// block, 0.055 ms at one instruction per scheduler and clock, beside the
// 0.034 ms that its bytes take.  Hopper has no tensor-core (wgmma / mma)
// form of a 64-bit modular product, so none is used; the butterflies run on
// the integer pipes, and the design keeps the instructions around them few.
//
// Two forms, both reading every input word once from device memory and
// writing every output word once:
//
//   ntt_reg_kernel   (L <= 16): one thread per column holds the whole
//       column in registers and runs every stage and the epilogue there:
//       no shared memory, no barrier.  With zero_top it reads L/2 rows.
//       The stage table (L - 1 words) is read into registers before the
//       first butterfly.  128 threads a block.
//   ntt_tile_kernel  (L = 32 .. 512): a block owns COLS columns,
//       COLS = 2^NTT_LOG_TILE_WORDS / L (8 at L = 512), and runs the log2 L
//       stages as ceil(log2 L / 3) register passes of radix 2^r, r <= 3
//       (512: 8 x 8 x 8, 256: 8 x 8 x 4, 128: 8 x 4 x 4, 64: 8 x 8,
//       32: 8 x 4).  In a pass a thread takes 2^r elements of one column at
//       the pass's row stride, runs r stages in registers and writes them
//       back.  The first pass reads straight from device memory and the
//       last writes straight to it; the passes go through an L x COLS tile
//       in shared memory between them, with one __syncthreads() between
//       two passes (two at L = 128 .. 512, one below).  The stage table is
//       copied into shared memory once per block, so the butterfly loop
//       reads no device memory.  Threads map column-fastest, so a warp's
//       global accesses are runs of COLS words (64 bytes or more) along a
//       row; a half-warp reads 16 tile words of at most two rows, which a
//       row swizzle keeps in different banks (tile_word).
//       The tile width and the launch parameters were chosen by
//       measurement (tools/ntt_times.py --define, PERF.md): 8, 16 and 32
//       columns, 128, 256 and 512 threads, radix 8 and 16, 4 to 6 blocks
//       an SM.  A persistent form that copied the next tile in with
//       cp.async while it worked on this one was no faster: its two tile
//       buffers leave room for 3 blocks an SM, not 6.
//
// Arithmetic: goldilocks.cuh's canonical gl_add / gl_sub / gl_mul, except
// that decimation in time keeps its sums lazy (gl_add_lazy / gl_sub_lazy:
// one operand any word, the other the canonical product or a canonicalised
// word) and canonicalises each output once; the test file models those
// ranges in python ints.

// Two transforms, both unscaled, twiddles from one (L-1)-word table in
// which the stage with half-size m occupies [m-1, 2m-1) and holds
// w_{2m}^t, t < m (its first word is 1):
//   dif = 1: decimation in frequency, natural order in, bit-reversed out;
//   dif = 0: decimation in time, bit-reversed in, natural order out.
//
// Layout.  Column j of the transform is word (j % c) of column group
// q = j / c; row r, column j sits at x[r * x_rs + q * x_ld + j % c] (and
// likewise in out with o_rs, o_ld).  A plain (rows, B) matrix is c = B; a
// 64-column slice of a wider matrix viewed as the pipeline's (n1, n2 * c)
// block is x_rs = n2 * ld, x_ld = ld, so kernel A of the inverse transform
// reads a slice in place and kernel B of the forward transform writes into
// one.
//
// Fused around the transform:
//   gather (gtw != null): the pipeline's mid gather, in kernel B's load.
//     Input row r, column j = q * c + cc reads
//       x[rev_L(r) * x_rs + rev_n1(q) * x_ld + cc] * gtw[r * n1 + q],
//     that is z[s, k1, cc] = y[rev1(k1) n2 + rev2(s), cc] * T[s, k1] with
//     x_rs = c, x_ld = n2 * c: the transpose, both bit reversals and the
//     four-step twiddle, with no pass of their own over the matrix.  The
//     gather sits in kernel B's load rather than kernel A's store: both
//     move runs of c words, and a scattered read costs only sectors read
//     in part, where a scattered write leaves sectors written in part.
//   zero_top: the input has only L/2 rows, the upper half is zero (the
//     LDE's zero padding is never read from device memory);
//   u (L words) / v: row r is multiplied by u[r], column j by v[j / v_div]
//     (the separable INTT 1/N and coset shift; v_div = c reads the n1-word
//     table of the pipeline, v_div = 1 one word per column);
//   cscale: every element is multiplied by one constant (the INTT's 1/N).
// Inputs may be any words in [0, 2^64); they are canonicalised on load (the
// gather's product is canonical), and every output is canonical.
#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

#define NTT_LOG_TILE_WORDS 12   // pass kernel's tile: 2^12 words, 32 KB
#define NTT_PASS_MAX_BITS 3     // passes of radix 8 at most
#define NTT_TILE_THREADS 256
#define NTT_TILE_MIN_BLOCKS 6   // __launch_bounds__: at most 40 registers
#define NTT_REG_THREADS 128
#define NTT_REG_MAX_BITS 4      // L <= 16: one thread per column
// Timing probe only: 0 leaves out every butterfly of the pass kernel (its
// results are then wrong), so that `tools/ntt_times.py --define
// NTT_BUTTERFLIES=0` times its data movement alone.
#define NTT_BUTTERFLIES 1

// Mirrored field for field by ctypes.Structure in ops/ntt_cuda.py.
struct NttArgs {
    const uint64_t* x;
    long long x_rs, x_ld;
    uint64_t* out;
    long long o_rs, o_ld;
    long long b, c;               // columns; words per column group
    const uint64_t* tw;
    const uint64_t* u;
    const uint64_t* v;
    long long v_div;
    const uint64_t* gtw;          // gather table (L, n1), or null
    long long g_n1_bits;
    unsigned long long cscale;
    long long use_cscale;
    long long log_l, dif, zero_top;
};

// Where one column's words are read and written, and its column scale.
struct ColIo {
    long long in_base, out_base;
    uint32_t q;
    uint64_t vj;
};

__device__ __forceinline__ uint32_t bitrev(uint32_t x, int bits) {
    return bits ? __brev(x) >> (32 - bits) : 0u;
}

__device__ __forceinline__ ColIo col_io(const NttArgs& a, long long j,
                                        bool need_v) {
    ColIo io;
    const uint32_t c = (uint32_t)a.c;
    const uint32_t q = (uint32_t)j / c;
    const uint32_t cc = (uint32_t)j - q * c;
    const uint32_t qin = a.gtw ? bitrev(q, (int)a.g_n1_bits) : q;
    io.in_base = (long long)qin * a.x_ld + cc;
    io.out_base = (long long)q * a.o_ld + cc;
    io.q = q;
    io.vj = (need_v && a.v) ? a.v[(uint32_t)j / (uint32_t)a.v_div] : 1;
    return io;
}

// Row r of the input column (canonical).
template <int LOG_L>
__device__ __forceinline__ uint64_t load_row(const NttArgs& a,
                                             const ColIo& io, int r) {
    if (a.gtw) {
        const uint32_t rr = bitrev((uint32_t)r, LOG_L);
        const uint64_t y = a.x[io.in_base + (long long)rr * a.x_rs];
        const uint64_t t = a.gtw[((long long)r << a.g_n1_bits) + io.q];
        return gl_mul(y, t);
    }
    return gl_canon(a.x[io.in_base + (long long)r * a.x_rs]);
}

// Row r of the output column, after the epilogue scales.
__device__ __forceinline__ void store_row(const NttArgs& a, const ColIo& io,
                                          int r, uint64_t val) {
    val = gl_canon(val);  // decimation in time leaves lazy words
    if (a.u) val = gl_mul(val, a.u[r]);
    if (a.v) val = gl_mul(val, io.vj);
    if (a.use_cscale) val = gl_mul(val, (uint64_t)a.cscale);
    a.out[io.out_base + (long long)r * a.o_rs] = val;
}

// ---------------------------------------------------------------------------
// L <= 16: one thread per column, everything in registers
// ---------------------------------------------------------------------------

template <int LOG_L, bool DIF>
__global__ void __launch_bounds__(NTT_REG_THREADS)
ntt_reg_kernel(const NttArgs a) {
    constexpr int L = 1 << LOG_L;
    uint64_t t[L];
#pragma unroll
    for (int i = 0; i < L - 1; ++i) t[i] = a.tw[i];
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= a.b) return;
    const ColIo io = col_io(a, j, true);
    uint64_t e[L];
#pragma unroll
    for (int r = 0; r < L; ++r)
        e[r] = (a.zero_top && r >= L / 2) ? 0 : load_row<LOG_L>(a, io, r);
#pragma unroll
    for (int s = 0; s < LOG_L; ++s) {
        const int lm = DIF ? LOG_L - 1 - s : s;
        const int m = 1 << lm;
#pragma unroll
        for (int i = 0; i < L / 2; ++i) {
            const int jj = i & (m - 1);
            const int i0 = ((i >> lm) << (lm + 1)) | jj;
            uint64_t p = e[i0], q = e[i0 + m];
            const bool mul = jj != 0;  // t[m - 1] = w^0 = 1
            const uint64_t tw = t[m - 1 + jj];
            if (DIF) {
                e[i0] = gl_add(p, q);
                const uint64_t d = gl_sub(p, q);
                e[i0 + m] = mul ? gl_mul(d, tw) : d;
            } else {
                const uint64_t t = mul ? gl_mul(q, tw) : gl_canon(q);
                e[i0] = gl_add_lazy(p, t);
                e[i0 + m] = gl_sub_lazy(p, t);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < L; ++r) store_row(a, io, r, e[r]);
}

// ---------------------------------------------------------------------------
// L = 32 .. 512: register passes over a shared-memory tile
// ---------------------------------------------------------------------------

// Pass P of the plan for length 2^LOG_L: R stages (radix 2^R), the passes
// before it covering BEFORE stages.  Decimation in time runs stages
// 0 .. LOG_L-1 in that order, so its pass covers stages [BEFORE,
// BEFORE + R); decimation in frequency runs them from the top down.
template <int LOG_L, int P>
struct PassPlan {
    static constexpr int NP =
        (LOG_L + NTT_PASS_MAX_BITS - 1) / NTT_PASS_MAX_BITS;
    static constexpr int R = LOG_L / NP + (P < LOG_L % NP ? 1 : 0);
    static constexpr int BEFORE =
        P * (LOG_L / NP) + (P < LOG_L % NP ? P : LOG_L % NP);
};

// Word of the tile that holds row r, column cl.  A half-warp reads 16
// words: 16 columns of one row when the tile has 16 or more, and two rows
// r, r + d (d = 1 or the pass's radix 8, r even) of 8 columns when it has
// 8, which would fall in the same banks; the row slot r ^ ((r >> 3) & 1)
// puts such two rows in different halves of the banks.
template <int LOG_COLS>
__device__ __forceinline__ int tile_word(int r, int cl) {
    if (LOG_COLS >= 4) return (r << LOG_COLS) + cl;
    return ((r ^ ((r >> 3) & 1)) << LOG_COLS) + cl;
}

template <int LOG_L, bool DIF, int P>
__device__ __forceinline__ void tile_pass(const NttArgs& a, uint64_t* s,
                                          const uint64_t* stw, long long c0) {
    constexpr int LOG_COLS = NTT_LOG_TILE_WORDS - LOG_L;
    constexpr int COLS = 1 << LOG_COLS;
    constexpr int L = 1 << LOG_L;
    using PL = PassPlan<LOG_L, P>;
    constexpr int R = PL::R;
    constexpr int K = 1 << R;
    constexpr int Q = DIF ? LOG_L - PL::BEFORE - R : PL::BEFORE;
    constexpr int S = 1 << Q;                  // row stride of the pass
    constexpr int ITEMS = (L / K) << LOG_COLS;  // (group, column) pairs
    constexpr bool FIRST = P == 0;
    constexpr bool LAST = P == PL::NP - 1;

    for (int w = threadIdx.x; w < ITEMS; w += NTT_TILE_THREADS) {
        const int cl = w & (COLS - 1);
        const int g = w >> LOG_COLS;
        const int base = ((g >> Q) << (Q + R)) | (g & (S - 1));
        const long long j = c0 + cl;
        const bool live = j < a.b;
        ColIo io;
        uint64_t e[K];
        if (FIRST) {
            if (live) io = col_io(a, j, LAST);
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const int r = base + k * S;
                const bool zero = !live || (a.zero_top && r >= L / 2);
                e[k] = zero ? 0 : load_row<LOG_L>(a, io, r);
            }
        } else {
#pragma unroll
            for (int k = 0; k < K; ++k)
                e[k] = s[tile_word<LOG_COLS>(base + k * S, cl)];
        }
        const int blo = base & (S - 1);
#pragma unroll
        for (int st = 0; st < R * NTT_BUTTERFLIES; ++st) {
            const int t = DIF ? R - 1 - st : st;  // stage Q + t, distance 2^t
            const int h = 1 << t;
            const int m = S << t;                  // stage half-size
#pragma unroll
            for (int i = 0; i < K / 2; ++i) {
                const int kk = ((i >> t) << (t + 1)) | (i & (h - 1));
                const uint64_t p = e[kk], q = e[kk + h];
                // the twiddle is 1 at m = 1
                const uint64_t tw =
                    m == 1 ? 1 : stw[m - 1 + blo + ((kk & (h - 1)) << Q)];
                if (DIF) {
                    const uint64_t d = gl_sub(p, q);
                    e[kk] = gl_add(p, q);
                    e[kk + h] = m == 1 ? d : gl_mul(d, tw);
                } else {
                    const uint64_t t = m == 1 ? gl_canon(q) : gl_mul(q, tw);
                    e[kk] = gl_add_lazy(p, t);
                    e[kk + h] = gl_sub_lazy(p, t);
                }
            }
        }
        if (LAST) {
            if (!live) continue;
            if (!FIRST) io = col_io(a, j, true);
#pragma unroll
            for (int k = 0; k < K; ++k) store_row(a, io, base + k * S, e[k]);
        } else {
#pragma unroll
            for (int k = 0; k < K; ++k)
                s[tile_word<LOG_COLS>(base + k * S, cl)] = e[k];
        }
    }
}

template <int LOG_L>
constexpr size_t tile_smem_bytes() {
    return sizeof(uint64_t) *
           (((size_t)1 << NTT_LOG_TILE_WORDS) + ((size_t)1 << LOG_L) - 1);
}

template <int LOG_L, bool DIF>
__global__ void __launch_bounds__(NTT_TILE_THREADS, NTT_TILE_MIN_BLOCKS)
ntt_tile_kernel(const NttArgs a) {
    constexpr int LOG_COLS = NTT_LOG_TILE_WORDS - LOG_L;
    static_assert(LOG_COLS >= 3, "tile narrower than 8 columns");
    constexpr int L = 1 << LOG_L;
    constexpr int NP = PassPlan<LOG_L, 0>::NP;
    static_assert(NP == 2 || NP == 3, "the tile kernel takes 2 or 3 passes");
    extern __shared__ uint64_t smem[];
    uint64_t* s = smem;                           // [L][COLS]
    uint64_t* stw = smem + ((size_t)L << LOG_COLS);  // the stage table
    for (int i = threadIdx.x; i < L - 1; i += NTT_TILE_THREADS) stw[i] = a.tw[i];
    __syncthreads();
    const long long c0 = (long long)blockIdx.x << LOG_COLS;
    tile_pass<LOG_L, DIF, 0>(a, s, stw, c0);
    __syncthreads();
    if constexpr (NP == 3) {
        tile_pass<LOG_L, DIF, 1>(a, s, stw, c0);
        __syncthreads();
    }
    tile_pass<LOG_L, DIF, NP - 1>(a, s, stw, c0);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <int LOG_L, bool DIF>
static int launch_reg(const NttArgs& a, cudaStream_t stream) {
    const long long blocks = (a.b + NTT_REG_THREADS - 1) / NTT_REG_THREADS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    ntt_reg_kernel<LOG_L, DIF><<<(unsigned)blocks, NTT_REG_THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int LOG_L, bool DIF>
static int launch_tile(const NttArgs& a, cudaStream_t stream) {
    constexpr int LOG_COLS = NTT_LOG_TILE_WORDS - LOG_L;
    constexpr size_t smem = tile_smem_bytes<LOG_L>();
    static bool attr_set = false;  // per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            ntt_tile_kernel<LOG_L, DIF>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    const long long blocks = (a.b + (1LL << LOG_COLS) - 1) >> LOG_COLS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    ntt_tile_kernel<LOG_L, DIF><<<(unsigned)blocks, NTT_TILE_THREADS, smem,
                                  stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool DIF>
static int launch(const NttArgs& a, cudaStream_t s) {
    static_assert(NTT_REG_MAX_BITS == 4, "the register form takes L <= 16");
    switch (a.log_l) {
        case 1: return launch_reg<1, DIF>(a, s);
        case 2: return launch_reg<2, DIF>(a, s);
        case 3: return launch_reg<3, DIF>(a, s);
        case 4: return launch_reg<4, DIF>(a, s);
        case 5: return launch_tile<5, DIF>(a, s);
        case 6: return launch_tile<6, DIF>(a, s);
        case 7: return launch_tile<7, DIF>(a, s);
        case 8: return launch_tile<8, DIF>(a, s);
        case 9: return launch_tile<9, DIF>(a, s);
    }
    return (int)cudaErrorInvalidValue;
}

// One launch of the block transform described by *a (see NttArgs and the
// header).  Returns cudaGetLastError() after the launch, or an error code
// for arguments the kernels do not take.
extern "C" int merlin_ntt_block(const NttArgs* a, void* stream) {
    if (a->b <= 0) return 0;
    if (a->log_l < 1 || a->log_l > 9 || a->c < 1 || a->b > 0x7FFFFFFFLL ||
        a->v_div < 1 || a->g_n1_bits < 0 || a->g_n1_bits > 31)
        return (int)cudaErrorInvalidValue;
    return a->dif ? launch<true>(*a, (cudaStream_t)stream)
                  : launch<false>(*a, (cudaStream_t)stream);
}
