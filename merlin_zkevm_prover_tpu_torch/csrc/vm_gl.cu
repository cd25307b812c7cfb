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
// What bounds it: the function needs the sections' words the program loads
// and its outputs once each, and its products: one 64-bit product for a
// base x base MUL, three for base x extension, six (Karatsuba) for two
// extension values.  An interpreter also pays, for every instruction and
// row, the fetch and dispatch of the instruction and the reads and writes of
// its registers.  The design (ops/vm_cuda.py rewrites the code for it):
//
//   * the register file lives in dynamic shared memory.  A block owns
//     `rows` rows, a thread VM_ROWS_PER_THREAD of them (t, t + threads,
//     ...), and word w of a row's registers sits at file[w * rows + t], so
//     a warp's access to one word is 32 consecutive 8-byte words, free of
//     bank conflicts.  The code's register operands are offsets w * rows.
//     A register that only ever holds base values (c1 = c2 = 0) takes one
//     word, any other three, rows apart.  The loop touches shared memory
//     only, through 32-bit shared addresses;
//   * registers past the on-chip budget live in device memory, spill[s *
//     n_pad + row] for spilled word s, in this same kernel: the wrapper
//     brings a spilled operand into a shared temporary with a FILL and
//     sends a spilled result out with a SPILL;
//   * the code is (op | flags, a, b, dst) int32 rows, read as one 16-byte
//     broadcast load, the next instruction fetched while the current one
//     runs.  VM_A_BASE / VM_B_BASE read an operand as (c0, 0, 0) from one
//     word, VM_D_BASE writes c0 alone: a MUL of two base operands is one
//     product, a base operand times an extension value (MUL, MULC) three;
//   * sections are read in place, (n, W) with any row and column stride; a
//     warp's LOAD of one column of a row-major section touches one sector
//     a row;
//   * the file is zeroed and the preloads written at the start; at the end
//     only the output registers are written, to out (n_out, 3, n);
//   * GL3 arithmetic by goldilocks.cuh's gl3_* helpers, every result
//     canonical.  Words read from sections and preloads may be any word:
//     they are canonicalised on the way in.
//
// Measured (PERF.md, tools/vm_times.py): one row a thread beat two and four;
// a tile of the section columns staged in shared memory lost to the loads
// in place on every program but a synthetic one of loads only (the tile
// leaves room for too few warps); the wide circuit's step-4 program is
// bound by its loads of row-major sections, a 32-byte sector for 8 bytes,
// and runs of four LOADs issued together (moved up by the wrapper) took 2%
// off it and added 6% to the smoke program (more registers).
//
// Semantics are those of the reference's scan body: registers start at 0;
// preloads are written before the first instruction; operands are read
// before the destination is written (dst may equal a or b after register
// recycling); a base load (dim != 3) gives c1 = c2 = 0; LOADR reads row
// (i + roll_k) mod n.  With the flags: a base-flagged operand is read as
// (c0, 0, 0), a VM_D_BASE result writes c0 alone, and an output register
// that is base at the end is written as (c0, 0, 0).  Rows past n (the last
// block's) run the program on row i mod n and write no output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "goldilocks.cuh"

#define VM_MAX_SECTIONS 8
#define VM_MAX_PRELOADS 4
#define VM_ROWS_PER_THREAD 1
#define VM_MAX_THREADS 128
#define VM_SMEM_MAX 232448  // bytes of shared memory a block may use
#define VM_OP_MASK 15
#define VM_A_BASE 16
#define VM_B_BASE 32
#define VM_D_BASE 64

#define RPT VM_ROWS_PER_THREAD

// FILL and SPILL move a register between device memory and shared memory;
// only the wrapper emits them, for programs whose file outgrows the chip.
enum { ADD, SUB, MUL, ADDC, SUBC, CSUBC, MULC, NEG, LOAD, LOADR, LOADC,
       FILL, SPILL };

// Mirrored field for field by ops/vm_cuda.py _VmArgs.
struct VmArgs {
    const int32_t* code;                  // (n_instr + 1, 4): op | flags, a,
                                          // b, dst; a zero row last
    long long n_instr;
    const uint64_t* table;                // (L, 3), canonical
    const uint64_t* sec[VM_MAX_SECTIONS]; // (n, W) views
    long long sec_rs[VM_MAX_SECTIONS];    // row stride, words
    long long sec_cs[VM_MAX_SECTIONS];    // column stride, words
    long long n_secs;
    const uint64_t* pre[3 * VM_MAX_PRELOADS];  // component vectors (n,)
    long long pre_stride[3 * VM_MAX_PRELOADS];
    long long pre_word[VM_MAX_PRELOADS];  // first word of the register
    long long n_pre;
    const int32_t* outs;                  // (n_out, 2): first word, is base
    long long n_out;
    uint64_t* out;                        // (n_out, 3, n)
    uint64_t* spill;                      // (n_words - slots_on, n_pad)
    long long n_words;                    // words of a row's registers
    long long slots_on;                   // of them in shared memory
    long long rows;                       // rows of a block
    long long n;
    long long n_pad;                      // blocks * rows
    long long roll_k;                     // in [0, n)
};

__device__ __forceinline__ uint64_t lds64(uint32_t addr) {
    uint64_t v;
    asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(addr));
    return v;
}

__device__ __forceinline__ void sts64(uint32_t addr, uint64_t v) {
    asm volatile("st.shared.u64 [%0], %1;" ::"r"(addr), "l"(v) : "memory");
}

__device__ __forceinline__ gl3_t const_load(const uint64_t* table, int c) {
    const unsigned long long* p =
        reinterpret_cast<const unsigned long long*>(table) + 3LL * c;
    return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// Word w of a row's registers, wherever it lives (the prologue and the
// epilogue; the loop reads and writes shared memory only).
__device__ __forceinline__ uint64_t* word_at(const VmArgs& a, uint64_t* file,
                                             long long w, int t, long long g) {
    return w < a.slots_on ? file + w * a.rows + t
                          : a.spill + (w - a.slots_on) * a.n_pad + g;
}

__global__ void __launch_bounds__(VM_MAX_THREADS)
vm_run_kernel(const VmArgs a) {
    extern __shared__ uint64_t file[];   // [word][row]
    const int nt = blockDim.x, rows = (int)a.rows;
    const long long n = a.n, row0 = (long long)blockIdx.x * rows;

    int t[RPT];                 // row within the block
    long long g[RPT];           // row within the padded domain
    long long ie[RPT], ir[RPT]; // the row read (g mod n) and LOADR's row
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        t[j] = threadIdx.x + j * nt;
        g[j] = row0 + t[j];
        long long i = g[j];
        while (i >= n) i -= n;
        ie[j] = i;
        i += a.roll_k;
        if (i >= n) i -= n;
        ir[j] = i;
    }
    for (long long w = 0; w < a.n_words; ++w)
#pragma unroll
        for (int j = 0; j < RPT; ++j) *word_at(a, file, w, t[j], g[j]) = 0;
    for (int p = 0; p < a.n_pre; ++p)
#pragma unroll
        for (int j = 0; j < RPT; ++j)
#pragma unroll
            for (int c = 0; c < 3; ++c)
                *word_at(a, file, a.pre_word[p] + c, t[j], g[j]) =
                    gl_canon(a.pre[3 * p + c][ie[j] * a.pre_stride[3 * p + c]]);

    // Operands a, b and dst are offsets into the shared file (word * rows);
    // a register's components are rows apart.
    const uint32_t sfile = (uint32_t)__cvta_generic_to_shared(file);
#define LD(o) lds64(sfile + 8u * (uint32_t)(o))
#define RD(o, j, base)                                                   \
    (base ? gl3_t{LD((o) + t[j]), 0, 0}                                  \
          : gl3_t{LD((o) + t[j]), LD((o) + rows + t[j]),                 \
                  LD((o) + 2 * rows + t[j])})
    const int4* code = reinterpret_cast<const int4*>(a.code);
    int4 nxt = __ldg(code);
    for (long long k = 0; k < a.n_instr; ++k) {
        const int4 ins = nxt;
        nxt = __ldg(code + k + 1);
        const int f = ins.x, x = ins.y, y = ins.z, d = ins.w, op = f & VM_OP_MASK;
        const bool ab = f & VM_A_BASE, bb = f & VM_B_BASE, db = f & VM_D_BASE;
        gl3_t v[RPT];
        if (op <= SUB) {
            gl3_t u[RPT], q[RPT];
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                u[j] = RD(x, j, ab || db);
                q[j] = RD(y, j, bb || db);
            }
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                if (db)
                    v[j] = {op == ADD ? gl_add(u[j].c0, q[j].c0)
                                      : gl_sub(u[j].c0, q[j].c0), 0, 0};
                else
                    v[j] = op == ADD ? gl3_add(u[j], q[j]) : gl3_sub(u[j], q[j]);
            }
        } else if (op == MUL) {
            gl3_t u[RPT], q[RPT];
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                u[j] = RD(x, j, ab);
                q[j] = RD(y, j, bb);
            }
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                if (ab && bb)
                    v[j] = {gl_mul(u[j].c0, q[j].c0), 0, 0};
                else if (ab || bb)
                    v[j] = ab ? gl3_scale(u[j].c0, q[j]) : gl3_scale(q[j].c0, u[j]);
                else
                    v[j] = gl3_mul(u[j], q[j]);
            }
        } else if (op <= NEG) {      // ADDC, SUBC, CSUBC, MULC, NEG
            const gl3_t c = op == NEG ? gl3_t{0, 0, 0} : const_load(a.table, y);
            gl3_t u[RPT];
            // c0 of all but MULC's result depends on c0 alone
#pragma unroll
            for (int j = 0; j < RPT; ++j) u[j] = RD(x, j, ab || (db && op != MULC));
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                if (op == ADDC)
                    v[j] = gl3_add(u[j], c);
                else if (op == SUBC)
                    v[j] = gl3_sub(u[j], c);
                else if (op == CSUBC)
                    v[j] = gl3_sub(c, u[j]);
                else if (op == NEG)
                    v[j] = gl3_neg(u[j]);
                else
                    v[j] = ab ? gl3_scale(u[j].c0, c) : gl3_mul(u[j], c);
            }
        } else if (op <= LOADR) {
            const bool three = (y & 3) == 3;
            const long long cs = a.sec_cs[x], rs = a.sec_rs[x];
            const uint64_t* p = a.sec[x] + (long long)(y >> 2) * cs;
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                const uint64_t* q = p + (op == LOADR ? ir[j] : ie[j]) * rs;
                v[j] = {gl_canon(q[0]), three ? gl_canon(q[cs]) : 0,
                        three ? gl_canon(q[2 * cs]) : 0};
            }
        } else if (op == LOADC) {
            const gl3_t c = const_load(a.table, x);
#pragma unroll
            for (int j = 0; j < RPT; ++j) v[j] = c;
        } else if (op == FILL) {     // a: spilled word, dst: shared offset
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                const uint64_t* p = a.spill + x * a.n_pad + g[j];
                v[j] = {p[0], db ? 0 : p[a.n_pad], db ? 0 : p[2 * a.n_pad]};
            }
        } else {                     // SPILL: a: shared offset, dst: word
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                const gl3_t u = RD(x, j, db);
                uint64_t* p = a.spill + d * a.n_pad + g[j];
                p[0] = u.c0;
                if (!db) {
                    p[a.n_pad] = u.c1;
                    p[2 * a.n_pad] = u.c2;
                }
            }
            continue;
        }
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
            sts64(sfile + 8u * (uint32_t)(d + t[j]), v[j].c0);
            if (!db) {
                sts64(sfile + 8u * (uint32_t)(d + rows + t[j]), v[j].c1);
                sts64(sfile + 8u * (uint32_t)(d + 2 * rows + t[j]), v[j].c2);
            }
        }
    }
#undef RD
#undef LD

    for (int o = 0; o < a.n_out; ++o) {
        const long long w = a.outs[2 * o];
        const bool base = a.outs[2 * o + 1];
        uint64_t* dst = a.out + 3LL * o * n;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
            if (g[j] >= n) continue;
#pragma unroll
            for (int c = 0; c < 3; ++c)
                dst[c * n + g[j]] =
                    c && base ? 0 : *word_at(a, file, w + c, t[j], g[j]);
        }
    }
}

// One launch of the program described by *a (see VmArgs).  The wrapper has
// checked every operand of every instruction against the register file's
// words, the table and the sections' widths.  Returns cudaGetLastError()
// after the launch, the error of a refused opt-in to more than 48 KB of
// shared memory, or an error code for arguments the kernel does not take.
extern "C" int merlin_vm_run(const VmArgs* a, void* stream) {
    const long long rows = a->rows;
    if (a->n <= 0 || rows <= 0 || rows % (32 * RPT) ||
        rows / RPT > VM_MAX_THREADS || a->roll_k < 0 || a->roll_k >= a->n ||
        a->n_secs < 0 || a->n_secs > VM_MAX_SECTIONS || a->n_pre < 0 ||
        a->n_pre > VM_MAX_PRELOADS || a->slots_on < 0 ||
        a->slots_on > a->n_words || a->n_out < 0)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (a->n + rows - 1) / rows;
    if (blocks > 0x7FFFFFFFLL || a->n_pad != blocks * rows)
        return (int)cudaErrorInvalidValue;
    const long long smem = 8 * a->slots_on * rows;
    if (smem > VM_SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        // above 48 KB a kernel must opt in, once per device
        static bool opted[64];
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e != cudaSuccess) return (int)e;
        if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
        if (!opted[dev]) {
            e = cudaFuncSetAttribute(vm_run_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     VM_SMEM_MAX);
            if (e != cudaSuccess) return (int)e;
            opted[dev] = true;
        }
    }
    vm_run_kernel<<<(unsigned)blocks, (unsigned)(rows / RPT), (size_t)smem,
                    (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}
