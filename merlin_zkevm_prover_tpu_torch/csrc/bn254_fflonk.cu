// Kernels F1-F3 of the fflonk prover over BN254 Fr (Montgomery, four 64-bit
// limbs, csrc/bn254.cuh).
//
// Replace no TPU kernel: the JAX package computes these in python ints
// (snark/fflonk.py).  The port's own, because at the final hop's domain
// (n = 2^21 .. 2^24 rows, a 4n quotient domain) a python loop per element
// or per chain takes hours.
//
// F1 bn_fr_scan: the inclusive scan, by addition or by multiplication, of
//   k interleaved chains (element i belongs to chain i mod k), forwards or
//   backwards.  The elements are read as rows of k; a thread scans one
//   chain over a segment of BN_SCAN_SEG rows (neighbouring threads on
//   neighbouring chains: coalesced for k >= 32) and writes the segment's
//   total; the wrapper scans the totals the same way (segments of
//   segments) and a second kernel combines each element with the scanned
//   total of the segments before it.  Division by X^k - beta (a backward
//   additive scan between two power tables), the grand product's prefix
//   products (k = 1, multiplicative) and sums of stacked polynomials
//   (k = their length) run on it.  Bound: bytes (read once, written once)
//   for addition, operations for multiplication.
// F2 bn_fr_inv: the inverse of every element (0 for 0) by Montgomery's
//   batch trick.  A block of BN_INV_THREADS threads takes BN_INV_THREADS *
//   BN_INV_RUN consecutive elements; thread t takes BN_INV_RUN of them a
//   block apart (t, t + T, ...: a warp reads neighbouring elements), keeps
//   their prefix products in registers (a zero, or a slot past n, counts as
//   one), and puts its total at a leaf of a product tree in shared memory;
//   the tree is multiplied up, one thread inverts its root (one inversion a
//   block, by the binary extended Euclidean algorithm: Fermat's chain of
//   380 products held each wave of blocks some 0.4 ms on the H100), and
//   the inverses are multiplied down to the leaves
//   (1/L = R / (L R)); each thread then walks its run backwards, 1/a_r =
//   (1/P_r) P_(r-1) and 1/P_(r-1) = (1/P_r) a_r, writing 0 for a zero.
//   Three products an element and the tree's three a thread.  Bound:
//   operations (three products an element, one inversion a batch).
// F3 bn_fflonk_quotient<part>: the numerators of the quotients at the
//   points of a domain (snark/fflonk.py:326-332, 352-367, 383-399):
//     part 0  t0 = a qL + b qR + a b qM + c qO + qC + pi
//     part 1  num = (a + b X + g)(b + k1 b X + g)(c + k2 b X + g),
//             den = (a + b s1 + g)(b + b s2 + g)(c + b s3 + g)   (n domain)
//     part 2  t1 = (z - 1) L1,  t2 = num z - den z(omega X)       (4n domain)
//   with X = root^i and z(omega X) = z[(i + shift) mod n].  One kernel a
//   part (its own registers, only its own columns).  In parts 1 and 2
//   thread t of block b takes the BN_QUOTIENT_RUN points i = b T R + t +
//   r T (neighbouring threads on neighbouring points, every column read
//   coalesced): its first X from the table of the root's squarings
//   (fr_pow_from_table, B2's scheme and run length), then one product by
//   root^T a point; part 0, with no X, takes one point a thread.
//   Elements move by 16-byte loads and stores; s1..s3 may lie s_stride
//   rows apart (part 1 reads them from the 4n evaluations).  t0 and (t1,
//   t2) are two launches: beta and gamma are drawn after C1, which commits
//   T0.  Bound: operations (5 / 11 / 14 products a point by part).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define BN_FFLONK_THREADS 256
#define BN_SCAN_SEG 64
// F2's block and run, F3's run (parts 1 and 2) and blocks an SM: the
// fastest of the values timed on the H100 (PERF.md section 6)
#define BN_INV_THREADS 256
#define BN_INV_RUN 4
#define BN_QUOTIENT_RUN 64
#define BN_QUOTIENT_MIN_BLOCKS 3
#define BN_FR_TWO_ADICITY 28

static inline unsigned fflonk_blocks(long long n) {
    return (unsigned)((n + BN_FFLONK_THREADS - 1) / BN_FFLONK_THREADS);
}

// in: canonical.  op 0: r = a + b, op 1: r = a * b (Montgomery).
__device__ __forceinline__ void scan_op(int op, uint64_t* r, const uint64_t* a,
                                        const uint64_t* b) {
    if (op) mont_mul<FrP>(r, a, b);
    else add_mod<FrP>(r, a, b);
}

__device__ __forceinline__ void scan_identity(int op, uint64_t* r) {
    if (op) bn_one<FrP>(r);
    else bn_zero(r);
}

// Thread t = segment s * k + chain c: scan positions [s SEG, (s + 1) SEG)
// of chain c; position p is row p (forwards) or rows - 1 - p (backwards);
// row u's element of chain c is u k + c, absent (the identity) at or past
// len.  tot[t] = the segment's total (when tot is not null).  out may be x.
__global__ void bn_fr_scan_kernel(const uint64_t* x, long long len, long long k,
                                  long long rows, int op, int backward,
                                  uint64_t* out, uint64_t* __restrict__ tot) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long n_seg = (rows + BN_SCAN_SEG - 1) / BN_SCAN_SEG;
    if (t >= n_seg * k) return;
    const long long s = t / k;
    const long long c = t - s * k;
    uint64_t acc[4], v[4];
    scan_identity(op, acc);
    const long long p_end = min(rows, (s + 1) * BN_SCAN_SEG);
#pragma unroll 1
    for (long long p = s * BN_SCAN_SEG; p < p_end; ++p) {
        const long long u = backward ? rows - 1 - p : p;
        const long long i = u * k + c;
        if (i >= len) continue;
        bn_copy(v, x + 4 * i);
        scan_op(op, acc, acc, v);
        bn_copy(out + 4 * i, acc);
    }
    if (tot != nullptr) bn_copy(tot + 4 * t, acc);
}

// Element i of a segment s > 0 (in scan order): out[i] = carry[(s - 1) k + c]
// op out[i], carry being the inclusive scan of the segments' totals.
__global__ void bn_fr_scan_carry_kernel(uint64_t* __restrict__ out, long long len,
                                        long long k, long long rows, int op,
                                        int backward,
                                        const uint64_t* __restrict__ carry) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= len) return;
    const long long u = i / k;
    const long long c = i - u * k;
    const long long p = backward ? rows - 1 - u : u;
    const long long s = p / BN_SCAN_SEG;
    if (s == 0) return;
    uint64_t v[4];
    scan_op(op, v, out + 4 * i, carry + 4 * ((s - 1) * k + c));
    bn_copy(out + 4 * i, v);
}

// a >>= 1 over 4 words
__device__ __forceinline__ void bn_shr1(uint64_t* a) {
    a[0] = (a[0] >> 1) | (a[1] << 63);
    a[1] = (a[1] >> 1) | (a[2] << 63);
    a[2] = (a[2] >> 1) | (a[3] << 63);
    a[3] >>= 1;
}

__device__ __forceinline__ bool bn_is_one(const uint64_t* a) {
    return ((a[0] ^ 1) | a[1] | a[2] | a[3]) == 0;
}

// x = x / 2 mod r, x canonical (x + r < 2^255: no carry out)
__device__ __forceinline__ void fr_half(uint64_t* x) {
    if (x[0] & 1) {
        uint64_t m[4];
        bn_mod<FrP>(m);
        (void)bn_add4(x, x, m);
    }
    bn_shr1(x);
}

// in: x canonical, not 0.  out: 1 / x in Montgomery form (x taken in
// Montgomery form too), by the binary extended Euclidean algorithm on the
// integer X that x's words hold: u = X, v = r, x1 = 1, x2 = 0 keep
// x1 X = u and x2 X = v (mod r); halving u or v halves x1 or x2 mod r,
// subtracting the smaller of u, v from the larger subtracts their
// coefficients; when u or v reaches 1 its coefficient is 1 / X.  At most
// some 510 halvings and as many subtractions of four words in one thread:
// a short serial chain where Fermat's 380 Montgomery products are a long
// one.
// 1 / X = 1 / (x R) as an integer; two products by R^2 make it R / x.
__device__ __forceinline__ void fr_inv_binary(uint64_t* r, const uint64_t* x) {
    uint64_t u[4], v[4], x1[4], x2[4], d[4];
    bn_copy(u, x);
    bn_mod<FrP>(v);
    bn_zero(x1);
    x1[0] = 1;
    bn_zero(x2);
#pragma unroll 1
    while (!bn_is_one(u) && !bn_is_one(v)) {
#pragma unroll 1
        while ((u[0] & 1) == 0) {
            bn_shr1(u);
            fr_half(x1);
        }
#pragma unroll 1
        while ((v[0] & 1) == 0) {
            bn_shr1(v);
            fr_half(x2);
        }
        if (bn_sub4(d, u, v) == 0) {
            bn_copy(u, d);
            sub_mod<FrP>(x1, x1, x2);
        } else {
            (void)bn_sub4(v, v, u);
            sub_mod<FrP>(x2, x2, x1);
        }
    }
    if (!bn_is_one(u)) bn_copy(x1, x2);
    uint64_t r2[4];
    bn_r2<FrP>(r2);
    mont_mul<FrP>(r, x1, r2);
    mont_mul<FrP>(r, r, r2);
}

// The product tree of bn_fr_inv_kernel: node k (1 the root) has children
// 2k and 2k + 1, thread t's leaf is T + t; limb-major (limb j of node k at
// tree[j][k]), so that a warp's threads touch neighbouring words.
__device__ __forceinline__ void tree_get(uint64_t* r,
                                         uint64_t (*tree)[2 * BN_INV_THREADS],
                                         int k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = tree[j][k];
}

__device__ __forceinline__ void tree_put(uint64_t (*tree)[2 * BN_INV_THREADS],
                                         int k, const uint64_t* a) {
#pragma unroll
    for (int j = 0; j < 4; ++j) tree[j][k] = a[j];
}

// out[i] = 1 / a[i], 0 for 0: element e = b T R + t + r T of block b is
// slot r of thread t.
__global__ void __launch_bounds__(BN_INV_THREADS)
bn_fr_inv_kernel(const uint64_t* __restrict__ a, long long n,
                 uint64_t* __restrict__ out) {
    __shared__ uint64_t tree[4][2 * BN_INV_THREADS];
    const int t = threadIdx.x;
    const long long e0 =
        (long long)blockIdx.x * BN_INV_THREADS * BN_INV_RUN + t;
    uint64_t pre[BN_INV_RUN][4];   // pre[r] = the product of slots 0..r
    uint64_t acc[4], v[4], w[4];
    bn_one<FrP>(acc);
#pragma unroll
    for (int r = 0; r < BN_INV_RUN; ++r) {
        const long long e = e0 + (long long)r * BN_INV_THREADS;
        if (e < n) {
            bn_load(v, a + 4 * e);
            if (!bn_is_zero(v)) mont_mul<FrP>(acc, acc, v);
        }
        bn_copy(pre[r], acc);
    }
    tree_put(tree, BN_INV_THREADS + t, acc);
    __syncthreads();
    // up: each node the product of its children
#pragma unroll 1
    for (int s = BN_INV_THREADS / 2; s >= 1; s >>= 1) {
        if (t < s) {
            tree_get(v, tree, 2 * (s + t));
            tree_get(w, tree, 2 * (s + t) + 1);
            mont_mul<FrP>(v, v, w);
            tree_put(tree, s + t, v);
        }
        __syncthreads();
    }
    if (t == 0) {
        tree_get(v, tree, 1);      // never 0: zeros count as one
        fr_inv_binary(w, v);
        tree_put(tree, 1, w);
    }
    __syncthreads();
    // down: each node's slot takes its inverse, 1/L = R (1/(L R)) and
    // 1/R = L (1/(L R))
#pragma unroll 1
    for (int s = 1; s < BN_INV_THREADS; s <<= 1) {
        if (t < s) {
            const int k = s + t;
            uint64_t l[4], rr[4];
            tree_get(w, tree, k);
            tree_get(l, tree, 2 * k);
            tree_get(rr, tree, 2 * k + 1);
            mont_mul<FrP>(v, rr, w);
            tree_put(tree, 2 * k, v);
            mont_mul<FrP>(v, l, w);
            tree_put(tree, 2 * k + 1, v);
        }
        __syncthreads();
    }
    tree_get(acc, tree, BN_INV_THREADS + t);   // 1 / the product of the run
    const uint64_t zero[4] = {0, 0, 0, 0};
#pragma unroll
    for (int r = BN_INV_RUN - 1; r >= 0; --r) {
        const long long e = e0 + (long long)r * BN_INV_THREADS;
        if (e >= n) continue;
        bn_load(v, a + 4 * e);
        if (bn_is_zero(v)) {
            bn_store(out + 4 * e, zero);
            continue;
        }
        if (r > 0) mont_mul<FrP>(w, acc, pre[r - 1]);
        else bn_copy(w, acc);
        bn_store(out + 4 * e, w);
        mont_mul<FrP>(acc, acc, v);
    }
}

// The operands of one F3 launch (ops/bn254_fflonk_cuda.py _QuotientArgs,
// field for field).  Constants in Montgomery form; columns (n, 4) (s1..s3
// with s_stride elements from row to row); sq[i] = root^(2^i) for i below
// the bit length of n - 1, root_step = root^BN_FFLONK_THREADS.
struct QuotientArgs {
    const uint64_t *a, *b, *c, *ql, *qr, *qm, *qo, *qc, *s1, *s2, *s3, *z,
        *l1, *pi;
    uint64_t *out0, *out1;
    long long n;
    long long shift;
    long long s_stride;
    uint64_t sq[BN_FR_TWO_ADICITY][4];
    uint64_t root_step[4], beta[4], gamma[4], k1beta[4], k2beta[4];
};

// (x + y + g) for canonical x, y, g.
__device__ __forceinline__ void lin3(uint64_t* r, const uint64_t* x,
                                     const uint64_t* y, const uint64_t* g) {
    add_mod<FrP>(r, x, y);
    add_mod<FrP>(r, r, g);
}

// part 0 at point i
__device__ __forceinline__ void quotient_t0(const QuotientArgs& q, long long i) {
    uint64_t a[4], b[4], t[4], u[4], acc[4];
    bn_load(a, q.a + 4 * i);
    bn_load(t, q.ql + 4 * i);
    mont_mul<FrP>(acc, a, t);
    bn_load(b, q.b + 4 * i);
    bn_load(t, q.qr + 4 * i);
    mont_mul<FrP>(t, b, t);
    add_mod<FrP>(acc, acc, t);
    mont_mul<FrP>(t, a, b);
    bn_load(u, q.qm + 4 * i);
    mont_mul<FrP>(t, t, u);
    add_mod<FrP>(acc, acc, t);
    bn_load(a, q.c + 4 * i);
    bn_load(t, q.qo + 4 * i);
    mont_mul<FrP>(t, a, t);
    add_mod<FrP>(acc, acc, t);
    bn_load(t, q.qc + 4 * i);
    add_mod<FrP>(acc, acc, t);
    bn_load(t, q.pi + 4 * i);
    add_mod<FrP>(acc, acc, t);
    bn_store(q.out0 + 4 * i, acc);
}

// parts 1 and 2 at point i, x = root^i
template <int PART>
__device__ __forceinline__ void quotient_perm(const QuotientArgs& q, long long i,
                                              const uint64_t* x) {
    uint64_t num[4], den[4], t[4], u[4], v[4];
    const long long is = 4 * i * q.s_stride;
    bn_load(v, q.a + 4 * i);
    mont_mul<FrP>(t, q.beta, x);
    lin3(num, v, t, q.gamma);
    bn_load(t, q.s1 + is);
    mont_mul<FrP>(t, q.beta, t);
    lin3(den, v, t, q.gamma);
    bn_load(v, q.b + 4 * i);
    mont_mul<FrP>(t, q.k1beta, x);
    lin3(u, v, t, q.gamma);
    mont_mul<FrP>(num, num, u);
    bn_load(t, q.s2 + is);
    mont_mul<FrP>(t, q.beta, t);
    lin3(u, v, t, q.gamma);
    mont_mul<FrP>(den, den, u);
    bn_load(v, q.c + 4 * i);
    mont_mul<FrP>(t, q.k2beta, x);
    lin3(u, v, t, q.gamma);
    mont_mul<FrP>(num, num, u);
    bn_load(t, q.s3 + is);
    mont_mul<FrP>(t, q.beta, t);
    lin3(u, v, t, q.gamma);
    mont_mul<FrP>(den, den, u);
    if (PART == 1) {
        bn_store(q.out0 + 4 * i, num);
        bn_store(q.out1 + 4 * i, den);
        return;
    }
    bn_load(v, q.z + 4 * i);
    bn_one<FrP>(u);
    sub_mod<FrP>(t, v, u);
    bn_load(u, q.l1 + 4 * i);
    mont_mul<FrP>(t, t, u);
    bn_store(q.out0 + 4 * i, t);
    long long j = i + q.shift;
    if (j >= q.n) j -= q.n;
    mont_mul<FrP>(num, num, v);
    bn_load(u, q.z + 4 * j);
    mont_mul<FrP>(den, den, u);
    sub_mod<FrP>(t, num, den);
    bn_store(q.out1 + 4 * i, t);
}

// the points a thread takes: part 0 has no power to carry from point to
// point
template <int PART>
__host__ __device__ constexpr int quotient_run() {
    return PART == 0 ? 1 : BN_QUOTIENT_RUN;
}

template <int PART>
__global__ void __launch_bounds__(BN_FFLONK_THREADS, BN_QUOTIENT_MIN_BLOCKS)
bn_fflonk_quotient_kernel(const __grid_constant__ QuotientArgs q) {
    constexpr int RUN = quotient_run<PART>();
    const long long i0 =
        (long long)blockIdx.x * BN_FFLONK_THREADS * RUN + threadIdx.x;
    if (i0 >= q.n) return;
    if (PART == 0) {
        quotient_t0(q, i0);
        return;
    }
    uint64_t x[4], one[4];
    bn_one<FrP>(one);
    fr_pow_from_table(x, one, &q.sq[0][0], i0);
#pragma unroll 1
    for (int r = 0; r < RUN; ++r) {
        const long long i = i0 + (long long)r * BN_FFLONK_THREADS;
        if (i >= q.n) break;
        quotient_perm<PART>(q, i, x);
        if (r + 1 < RUN) mont_mul<FrP>(x, x, q.root_step);
    }
}

template <int PART>
static void quotient_launch(const QuotientArgs& q, cudaStream_t st) {
    const long long per = (long long)BN_FFLONK_THREADS * quotient_run<PART>();
    bn_fflonk_quotient_kernel<PART>
        <<<(unsigned)((q.n + per - 1) / per), BN_FFLONK_THREADS, 0, st>>>(q);
}

// op: 0 add, 1 mul; tot may be null (one segment)
extern "C" int merlin_bn_fr_scan(const void* x, long long len, long long k,
                                 long long rows, int op, int backward, void* out,
                                 void* tot, void* stream) {
    if (len <= 0) return 0;
    const long long n_seg = (rows + BN_SCAN_SEG - 1) / BN_SCAN_SEG;
    bn_fr_scan_kernel<<<fflonk_blocks(n_seg * k), BN_FFLONK_THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const uint64_t*)x, len, k, rows, op, backward, (uint64_t*)out,
        (uint64_t*)tot);
    return (int)cudaGetLastError();
}

extern "C" int merlin_bn_fr_scan_carry(void* out, long long len, long long k,
                                       long long rows, int op, int backward,
                                       const void* carry, void* stream) {
    if (len <= 0) return 0;
    bn_fr_scan_carry_kernel<<<fflonk_blocks(len), BN_FFLONK_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (uint64_t*)out, len, k, rows, op, backward, (const uint64_t*)carry);
    return (int)cudaGetLastError();
}

extern "C" int merlin_bn_fr_scan_seg() { return BN_SCAN_SEG; }

extern "C" int merlin_bn_fr_inv(const void* a, long long n, void* out,
                                void* stream) {
    if (n <= 0) return 0;
    const long long per = (long long)BN_INV_THREADS * BN_INV_RUN;
    bn_fr_inv_kernel<<<(unsigned)((n + per - 1) / per), BN_INV_THREADS, 0,
                       (cudaStream_t)stream>>>((const uint64_t*)a, n,
                                               (uint64_t*)out);
    return (int)cudaGetLastError();
}

// part: 0, 1 or 2
extern "C" int merlin_bn_fflonk_quotient(const QuotientArgs* args, int part,
                                         void* stream) {
    if (args->n <= 0) return 0;
    if (part < 0 || part > 2 || args->shift < 0 || args->shift >= args->n ||
        args->n > (1LL << BN_FR_TWO_ADICITY))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (part == 0) quotient_launch<0>(*args, st);
    else if (part == 1) quotient_launch<1>(*args, st);
    else quotient_launch<2>(*args, st);
    return (int)cudaGetLastError();
}

// The launch geometry the wrappers and holds read: 0 F2's threads, 1 F2's
// run, 2 F3's threads (root_step = root^this), 3 F3's run in parts 1 and 2
// (part 0's is 1).
extern "C" int merlin_bn_fflonk_geometry(int what) {
    switch (what) {
        case 0: return BN_INV_THREADS;
        case 1: return BN_INV_RUN;
        case 2: return BN_FFLONK_THREADS;
        case 3: return BN_QUOTIENT_RUN;
        default: return -1;
    }
}
