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
// F2 bn_fr_inv: a^(r - 2), one thread an element (256 squarings and the
//   exponent's set bits).  Bound: operations.
// F3 bn_fflonk_quotient: one thread a point of a domain, the numerators of
//   the quotients (snark/fflonk.py:326-332, 352-367, 383-399):
//     part 0  t0 = a qL + b qR + a b qM + c qO + qC + pi
//     part 1  num = (a + b X + g)(b + k1 b X + g)(c + k2 b X + g),
//             den = (a + b s1 + g)(b + b s2 + g)(c + b s3 + g)   (n domain)
//     part 2  t1 = (z - 1) L1,  t2 = num z - den z(omega X)       (4n domain)
//   with X = root^i by square-and-multiply in the thread and z(omega X) =
//   z[(i + shift) mod n].  t0 and (t1, t2) are two launches: beta and gamma
//   are drawn after C1, which commits T0.  Bound: operations.
// No more than right and simple here: one thread a chain segment, an
// element or a point.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254.cuh"

#define BN_FFLONK_THREADS 256
#define BN_SCAN_SEG 64

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

// out[i] = a[i]^(r - 2): the inverse, 0 for 0.
__global__ void bn_fr_inv_kernel(const uint64_t* __restrict__ a, long long n,
                                 uint64_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint64_t e[4] = {FrP::M0 - 2, FrP::M1, FrP::M2, FrP::M3};
    uint64_t x[4], r[4];
    bn_copy(x, a + 4 * i);
    bn_one<FrP>(r);
#pragma unroll 1
    for (int l = 3; l >= 0; --l) {
#pragma unroll 1
        for (int b = 63; b >= 0; --b) {
            mont_mul<FrP>(r, r, r);
            if ((e[l] >> b) & 1ull) mont_mul<FrP>(r, r, x);
        }
    }
    bn_copy(out + 4 * i, r);
}

// The operands of one F3 launch (ops/bn254_fflonk_cuda.py _QuotientArgs,
// field for field).  Constants in Montgomery form; columns (n, 4).
struct QuotientArgs {
    const uint64_t *a, *b, *c, *ql, *qr, *qm, *qo, *qc, *s1, *s2, *s3, *z,
        *l1, *pi;
    uint64_t *out0, *out1, *out2;
    long long n;
    long long shift;
    uint64_t root[4], beta[4], gamma[4], k1beta[4], k2beta[4];
    long long part;
};

// (x + y + g) for canonical x, y, g.
__device__ __forceinline__ void lin3(uint64_t* r, const uint64_t* x,
                                     const uint64_t* y, const uint64_t* g) {
    add_mod<FrP>(r, x, y);
    add_mod<FrP>(r, r, g);
}

__global__ void bn_fflonk_quotient_kernel(const QuotientArgs q) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= q.n) return;
    uint64_t a[4], b[4], c[4], t[4], u[4];
    bn_copy(a, q.a + 4 * i);
    bn_copy(b, q.b + 4 * i);
    bn_copy(c, q.c + 4 * i);
    if (q.part == 0) {
        uint64_t acc[4];
        mont_mul<FrP>(acc, a, q.ql + 4 * i);
        mont_mul<FrP>(t, b, q.qr + 4 * i);
        add_mod<FrP>(acc, acc, t);
        mont_mul<FrP>(t, a, b);
        mont_mul<FrP>(t, t, q.qm + 4 * i);
        add_mod<FrP>(acc, acc, t);
        mont_mul<FrP>(t, c, q.qo + 4 * i);
        add_mod<FrP>(acc, acc, t);
        add_mod<FrP>(acc, acc, q.qc + 4 * i);
        add_mod<FrP>(acc, acc, q.pi + 4 * i);
        bn_copy(q.out0 + 4 * i, acc);
        return;
    }
    // X = root^i
    uint64_t x[4], base[4];
    bn_one<FrP>(x);
    bn_copy(base, q.root);
    unsigned long long e = (unsigned long long)i;
#pragma unroll 1
    while (e) {
        if (e & 1ull) mont_mul<FrP>(x, x, base);
        e >>= 1;
        if (e) mont_mul<FrP>(base, base, base);
    }
    uint64_t num[4], den[4];
    mont_mul<FrP>(t, q.beta, x);
    lin3(num, a, t, q.gamma);
    mont_mul<FrP>(t, q.k1beta, x);
    lin3(u, b, t, q.gamma);
    mont_mul<FrP>(num, num, u);
    mont_mul<FrP>(t, q.k2beta, x);
    lin3(u, c, t, q.gamma);
    mont_mul<FrP>(num, num, u);
    mont_mul<FrP>(t, q.beta, q.s1 + 4 * i);
    lin3(den, a, t, q.gamma);
    mont_mul<FrP>(t, q.beta, q.s2 + 4 * i);
    lin3(u, b, t, q.gamma);
    mont_mul<FrP>(den, den, u);
    mont_mul<FrP>(t, q.beta, q.s3 + 4 * i);
    lin3(u, c, t, q.gamma);
    mont_mul<FrP>(den, den, u);
    if (q.part == 1) {
        bn_copy(q.out0 + 4 * i, num);
        bn_copy(q.out1 + 4 * i, den);
        return;
    }
    uint64_t z[4], one[4];
    bn_copy(z, q.z + 4 * i);
    bn_one<FrP>(one);
    sub_mod<FrP>(t, z, one);
    mont_mul<FrP>(t, t, q.l1 + 4 * i);
    bn_copy(q.out0 + 4 * i, t);
    long long j = i + q.shift;
    if (j >= q.n) j -= q.n;
    mont_mul<FrP>(num, num, z);
    mont_mul<FrP>(den, den, q.z + 4 * j);
    sub_mod<FrP>(t, num, den);
    bn_copy(q.out1 + 4 * i, t);
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
    bn_fr_inv_kernel<<<fflonk_blocks(n), BN_FFLONK_THREADS, 0,
                       (cudaStream_t)stream>>>((const uint64_t*)a, n,
                                               (uint64_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int merlin_bn_fflonk_quotient(const QuotientArgs* args, void* stream) {
    if (args->n <= 0) return 0;
    bn_fflonk_quotient_kernel<<<fflonk_blocks(args->n), BN_FFLONK_THREADS, 0,
                                (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
