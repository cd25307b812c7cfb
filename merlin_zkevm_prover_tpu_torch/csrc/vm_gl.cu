// The expression-program interpreter (stark/vm.py's step programs) for
// Hopper: every instruction of a compiled program over every row of its
// domain, in one launch.
//
// No Pallas kernel stands behind it: the reference runs its VM as one
// lax.scan over the instructions (merlin_zkevm_prover_tpu/stark/vm.py:532),
// whose body XLA compiles once.  This kernel is the port's form of that
// compiled body, so that a program of tens of thousands of instructions is
// one launch and not millions of PyTorch elementwise launches.
//
// Design (the simple one; ops/vm_cuda.py says what is left for later):
//   * one thread per row; every thread runs every instruction in order;
//   * the (Ni, 4) int32 code and the (L, 3) constant table are read by all
//     threads of a warp at one address (broadcast loads through the
//     read-only cache);
//   * the register file is in device memory, laid out (R, 3, n), so every
//     register read and write of a warp is coalesced;
//   * sections are read in place, (n, W) with any row and column stride;
//     LOADR reads row (i + roll_k) mod n;
//   * GL3 arithmetic by goldilocks.cuh's gl3_* helpers, every result
//     canonical.  Words read from sections and preloads may be any word:
//     they are canonicalised on the way in.
//
// What bounds it: the function needs the sections' words the program loads
// and its outputs once each, and its GL3 products (six 64-bit products a
// MUL / MULC).  This design moves far more: each instruction reads one or
// two registers and writes one (24 bytes each a row), and a section row is
// W words apart from the next, so a warp's load touches 32 sectors.
//
// Semantics are those of the reference's scan body: operands are read before
// the destination is written (dst may equal a or b after register
// recycling); a base load (dim != 3) gives c1 = c2 = 0; preloads are written
// before the first instruction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

#define VM_MAX_SECTIONS 8
#define VM_MAX_PRELOADS 4
#define VM_THREADS 128

enum { ADD, SUB, MUL, ADDC, SUBC, CSUBC, MULC, NEG, LOAD, LOADR, LOADC };

// Mirrored field for field by ops/vm_cuda.py _VmArgs.
struct VmArgs {
    const int32_t* code;                  // (n_instr, 4): op, a, b, dst
    long long n_instr;
    const uint64_t* table;                // (L, 3), canonical
    const uint64_t* sec[VM_MAX_SECTIONS]; // (n, W) views
    long long sec_rs[VM_MAX_SECTIONS];    // row stride, words
    long long sec_cs[VM_MAX_SECTIONS];    // column stride, words
    long long n_secs;
    const uint64_t* pre[3 * VM_MAX_PRELOADS];  // component vectors (n,)
    long long pre_stride[3 * VM_MAX_PRELOADS];
    long long pre_reg[VM_MAX_PRELOADS];
    long long n_pre;
    uint64_t* regs;                       // (n_regs, 3, n)
    long long n_regs;
    long long n;
    long long roll_k;                     // in [0, n)
};

__device__ __forceinline__ gl3_t reg_load(const uint64_t* regs, int r,
                                          long long n, long long i) {
    const uint64_t* p = regs + (long long)r * 3 * n + i;
    return {p[0], p[n], p[2 * n]};
}

__device__ __forceinline__ gl3_t const_load(const uint64_t* table, int c) {
    const unsigned long long* p =
        reinterpret_cast<const unsigned long long*>(table) + 3LL * c;
    return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__global__ void __launch_bounds__(VM_THREADS)
vm_run_kernel(const VmArgs a) {
    const long long i = (long long)blockIdx.x * VM_THREADS + threadIdx.x;
    if (i >= a.n) return;
    const long long n = a.n;
    uint64_t* regs = a.regs;

    for (int p = 0; p < a.n_pre; ++p) {
        uint64_t* dst = regs + a.pre_reg[p] * 3 * n + i;
#pragma unroll
        for (int c = 0; c < 3; ++c)
            dst[c * n] = gl_canon(a.pre[3 * p + c][i * a.pre_stride[3 * p + c]]);
    }

    long long i_rot = i + a.roll_k;
    if (i_rot >= n) i_rot -= n;

    for (long long k = 0; k < a.n_instr; ++k) {
        const int32_t* ins = a.code + 4 * k;
        const int op = __ldg(ins), x = __ldg(ins + 1), y = __ldg(ins + 2),
                  d = __ldg(ins + 3);
        gl3_t v;
        switch (op) {
            case ADD:
                v = gl3_add(reg_load(regs, x, n, i), reg_load(regs, y, n, i));
                break;
            case SUB:
                v = gl3_sub(reg_load(regs, x, n, i), reg_load(regs, y, n, i));
                break;
            case MUL:
                v = gl3_mul(reg_load(regs, x, n, i), reg_load(regs, y, n, i));
                break;
            case ADDC:
                v = gl3_add(reg_load(regs, x, n, i), const_load(a.table, y));
                break;
            case SUBC:
                v = gl3_sub(reg_load(regs, x, n, i), const_load(a.table, y));
                break;
            case CSUBC:
                v = gl3_sub(const_load(a.table, y), reg_load(regs, x, n, i));
                break;
            case MULC:
                v = gl3_mul(reg_load(regs, x, n, i), const_load(a.table, y));
                break;
            case NEG:
                v = gl3_neg(reg_load(regs, x, n, i));
                break;
            case LOAD:
            case LOADR: {
                const long long row = op == LOADR ? i_rot : i;
                const long long cs = a.sec_cs[x];
                const uint64_t* s = a.sec[x] + row * a.sec_rs[x] + (long long)(y >> 2) * cs;
                v.c0 = gl_canon(s[0]);
                if ((y & 3) == 3) {
                    v.c1 = gl_canon(s[cs]);
                    v.c2 = gl_canon(s[2 * cs]);
                } else {
                    v.c1 = v.c2 = 0;
                }
                break;
            }
            default:  // LOADC
                v = const_load(a.table, x);
                break;
        }
        uint64_t* dst = regs + (long long)d * 3 * n + i;
        dst[0] = v.c0;
        dst[n] = v.c1;
        dst[2 * n] = v.c2;
    }
}

// One launch of the program described by *a (see VmArgs).  The wrapper has
// checked every operand of every instruction against the register file, the
// table and the sections' widths.  Returns cudaGetLastError() after the
// launch, or an error code for arguments the kernel does not take.
extern "C" int merlin_vm_run(const VmArgs* a, void* stream) {
    if (a->n <= 0 || a->n_regs <= 0 || a->roll_k < 0 || a->roll_k >= a->n ||
        a->n_secs < 0 || a->n_secs > VM_MAX_SECTIONS || a->n_pre < 0 ||
        a->n_pre > VM_MAX_PRELOADS)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (a->n + VM_THREADS - 1) / VM_THREADS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    vm_run_kernel<<<(unsigned)blocks, VM_THREADS, 0, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}
