// The expression register machine: one kernel that evaluates any lowered expression program
// over the rows of a batch.
//
// Replaces: pathway_tpu/internals/expression_compiler.py `_make_jitted` (:272, cached by
// `_jitted_kernel` :383) and `fused_chain_kernel` (:398), with pathway_tpu/engine/fusion.py
// `FusedChain._try_jit` (:607). There one expression DAG, or one fused Rowwise/Filter chain, is
// traced into jax.jit and XLA compiles it into one elementwise computation. Here the expression
// compiler lowers the same tree into a typed program (ops/expression_kernel.py), and this kernel,
// built once from the repository, interprets it: no compiler runs while the engine ticks, and
// nothing is cached per expression on disk.
//
// A program is rows of five int32 (op, dst, a, b, c) over 64-bit registers, with 64-bit
// constants: loads read the packed input columns (8-byte values, or bool bytes), stores write the
// output columns in their dtypes and the chain's mask as bytes.

// Semantics follow XLA with x64 where C++ leaves them open: integer arithmetic wraps (computed
// unsigned); a shift by a count outside [0, 64) gives 0 for << and the sign for >>; float to
// int64 truncates, saturates, and maps NaN to 0; float + - * / are the _rn intrinsics, so no
// multiply-add is contracted and `x * 2.0 - 1.0` rounds twice as XLA's does; subnormal operands
// and results of float arithmetic and comparisons flush to zero, as on XLA's CPU backend (the
// JAX package pins its expression kernels there); pow is the CUDA math library's.
//
// Bound on the H100: bytes. Each input value is read once and each output written once, and a
// program does a few dozen register operations per row at most. At the engine's batch sizes the
// bytes take under a microsecond, so what is left is the launch's own cost (time an empty kernel
// on the same grid: `expression_vm_empty`) and the interpretation. An interpreter's time is the
// length of one warp's chain of dispatched instructions, whatever the rows: every warp walks the
// whole program, the warps run side by side, and one step (operand loads, the dispatch's
// branches, the operation, the store) costs some 350-450 cycles of latency that more warps do not
// shorten (scripts/torch_engine_kernels_pair.py's chains of 8 and 16 dependent adds, on an NVIDIA
// H100 80GB HBM3 at 700 W). So the design cuts the steps and the branches of each step. On the engine's path the columns come from the
// host, so the upload and readback around the launch take longer than the kernel.
//
// Design:
// - The launch form (launch_form, on the host): every CONST, LD8 and LDB is folded into the
//   operands that read its register, so the kernel dispatches only the instructions that compute
//   or store (the Table API chain's program: 14 of its 24).
// - The program, its constants and the column offsets travel in the launch's parameters, each
//   instruction packed in 8 bytes (3,128 bytes in all): every thread reads the same instruction
//   from the constant bank, the next one while this one runs, and nothing copies the program
//   into the block first.
// - Shared memory holds the register file, laid out [register][row of the block] and sized to the
//   program's own register count (Program.n_regs), then the input columns at the block's rows,
//   staged at the start with up to 8 columns' loads in flight (a program's loads would wait for
//   one at a time), and the constants. So an operand is one shared-memory load from an address
//   chosen by a uniform select, with no branch, and nothing is in local memory.
// - Each thread evaluates kRows = 2 rows for every instruction it decodes, blockDim.x apart, so a
//   warp's loads and stores of a column are consecutive values. One or four rows a thread were
//   slower on that card (four rows: one warp per scheduler, and a longer step). The long
//   operations (pow, the integer powers) take the rows one after the other, so their code is
//   emitted once.
// - A block takes 128 threads while the register file and columns fit in 96 KB (n_regs + n_in
//   <= 48) and 64 threads up to MAX_REGS + MAX_COLS, so every program the lowering accepts runs
//   on the one route.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_INSNS = 256;
constexpr int MAX_REGS = 64;
constexpr int MAX_CONSTS = 64;
constexpr int MAX_COLS = 32;
constexpr int kRows = 2;                 // rows a thread evaluates per decoded instruction
constexpr int kMaxThreads = 128;         // threads a block, fewer for large register files
constexpr int kRegBytes = 96 * 1024;     // the register file's budget of shared memory a block
constexpr int kStaged = 8;               // input columns loaded at once

// in the order of OPS in ops/expression_kernel.py
enum Op {
  LD8, LDB, CONST, ST8, STB,
  ADD_I, SUB_I, MUL_I,
  ADD_F, SUB_F, MUL_F, DIV_F,
  POW_I, POW_F, IPOW_I, IPOW_F,
  EQ_I, NE_I, LT_I, LE_I,
  EQ_F, NE_F, LT_F, LE_F,
  LT_U, LE_U,
  AND, OR, XOR,
  SHL, SHR,
  NEG_I, NEG_F, NOT_I, NOT_B, ABS_I, ABS_F,
  SEL,
  I2F, F2I, I2B, F2B, B2F,
};

// One launch's program in its launch form (below), constants and column offsets, passed by value
// among the kernel's parameters (3,128 bytes). An instruction is packed in two words: op | d << 8
// (d of a store is unused), and a | b << 10 | c << 20, each operand in 10 bits (-1 as 1023).
struct Launch {
  int2 code[MAX_INSNS + 1];  // one more, zero: the fetch of the next instruction
  long long consts[MAX_CONSTS];
  long long in[MAX_COLS];           // byte offset of each input column inside `in`
  long long out[MAX_COLS];          // byte offset of each output column inside `out`
  unsigned char in_size[MAX_COLS];  // bytes a row of each input column: 8, 1 for bools, 0 unread
  int n_insns, n_in, n_regs, n_consts;
};

// Which register operands an instruction reads: a for the stores and every operation, b for the
// binary operations (not the integer powers, whose b is a constant's index), c for SEL.
__host__ __device__ __forceinline__ bool reads_a(int op) { return op >= ST8; }
__host__ __device__ __forceinline__ bool reads_b(int op) {
  return op >= ADD_I && (op < IPOW_I || (op > IPOW_F && op < NEG_I) || op == SEL);
}

// Operands of the launch form: r < n_regs + n_in a row of the register file (the program's
// registers, then its input columns at the block's rows), r >= kConstOperand a constant.
constexpr int kConstOperand = MAX_REGS + MAX_COLS;

// The launch form: each CONST, LD8 and LDB is folded into the operands that read its register
// until the register is written again (the operand then names the constant, or the input
// column's row of the register file: the same bits the register would hold), and dropped, so
// the kernel dispatches only the instructions that compute or store. Also notes each input
// column's row size, for the staging. Returns the instructions kept, or -1 for an opcode the
// machine does not have or a load or constant out of range.
int launch_form(const int* code, int n_insns, int n_regs, Launch* p) {
  int holds[MAX_REGS];  // the operand a register stands for, or -1
  for (int r = 0; r < MAX_REGS; ++r) holds[r] = -1;
  int m = 0;
  for (int i = 0; i < n_insns; ++i) {
    const int* ins = code + i * 5;
    int op = ins[0], d = ins[1], a = ins[2], b = ins[3], c = ins[4];
    if (op < LD8 || op > B2F) return -1;
    if (op == CONST || op == LD8 || op == LDB) {
      if (d < 0 || d >= n_regs || a < 0 || a >= (op == CONST ? MAX_CONSTS : MAX_COLS)) return -1;
      if (op != CONST) p->in_size[a] = op == LD8 ? 8 : 1;
      holds[d] = op == CONST ? kConstOperand + a : n_regs + a;
      continue;
    }
    auto fold = [&](int r) { return r >= 0 && r < MAX_REGS && holds[r] >= 0 ? holds[r] : r; };
    if (reads_a(op)) a = fold(a);
    if (reads_b(op)) b = fold(b);
    if (op == SEL) c = fold(c);
    if (op != ST8 && op != STB && d >= 0 && d < MAX_REGS) holds[d] = -1;
    p->code[m++] = make_int2(op | (d & 0xff) << 8, (a & 0x3ff) | (b & 0x3ff) << 10 |
                                                       (c & 0x3ff) << 20);
  }
  return m;
}

// XLA's CPU backend runs with FTZ and DAZ: a subnormal operand of float arithmetic or of a
// comparison reads as a zero of its sign, and a subnormal result is written as one. Moves,
// negation, abs and selects keep the bits.
__device__ __forceinline__ long long flush(long long v) {
  return (v & 0x7FF0000000000000LL) == 0 ? (v & LLONG_MIN) : v;
}
__device__ __forceinline__ double as_f(long long v) { return __longlong_as_double(flush(v)); }
__device__ __forceinline__ long long as_i(double v) { return flush(__double_as_longlong(v)); }

__device__ __forceinline__ long long f2i(double x) {
  if (isnan(x)) return 0;
  if (x >= 9223372036854775808.0) return LLONG_MAX;
  if (x <= -9223372036854775808.0) return LLONG_MIN;
  return static_cast<long long>(x);  // in range: toward zero
}

__device__ __forceinline__ unsigned long long wmul(unsigned long long a, unsigned long long b) {
  return a * b;
}

// jnp.power of two int64 values: six steps of binary exponentiation (jax's _pow_int_int)
__device__ __forceinline__ long long pow_int(long long x, long long y) {
  unsigned long long acc = (x == 0 && y != 0) ? 0ull : 1ull;
  unsigned long long ux = static_cast<unsigned long long>(x);
  unsigned long long uy = static_cast<unsigned long long>(y);
  for (int i = 0; i < 6; ++i) {
    if (uy & 1ull) acc = wmul(acc, ux);
    ux = wmul(ux, ux);
    uy >>= 1;  // logical
  }
  return static_cast<long long>(acc);
}

// lax.integer_pow(x, e), e >= 0, int64: binary exponentiation in jax's order
__device__ __forceinline__ long long ipow_int(long long x, long long e) {
  if (e == 0) return 1;
  unsigned long long ux = static_cast<unsigned long long>(x);
  unsigned long long acc = 0;
  bool have = false;
  while (e > 0) {
    if (e & 1) {
      acc = have ? wmul(acc, ux) : ux;
      have = true;
    }
    e >>= 1;
    if (e > 0) ux = wmul(ux, ux);
  }
  return static_cast<long long>(acc);
}

__device__ __forceinline__ double fmul(double a, double b) { return as_f(as_i(__dmul_rn(a, b))); }

// lax.integer_pow(x, e), float64: the same order, each product flushed; 1 / x^|e| for e < 0
__device__ __forceinline__ double ipow_float(double x, long long e) {
  if (e == 0) return 1.0;
  const bool recip = e < 0;
  unsigned long long m = recip ? 0ull - static_cast<unsigned long long>(e)
                               : static_cast<unsigned long long>(e);
  double acc = 0.0;
  bool have = false;
  while (m > 0) {
    if (m & 1ull) {
      acc = have ? fmul(acc, x) : x;
      have = true;
    }
    m >>= 1;
    if (m > 0) x = fmul(x, x);
  }
  return recip ? as_f(as_i(__ddiv_rn(1.0, acc))) : acc;
}

// v[k] = EXPR for each of the thread's rows (EXPR reads x[k], y[k])
#define EACH(EXPR)                                  \
  _Pragma("unroll") for (int k = 0; k < kRows; ++k) \
    v[k] = (EXPR);                                  \
  break

// The long operations (pow and the integer powers' loops) one row after the other, straight from
// and to the register file: their code is emitted once, not kRows times, which keeps the
// kernel's hot cases together in the instruction cache.
#define ROLLED(EXPR)                                                     \
  _Pragma("unroll 1") for (int k = 0; k < kRows; ++k) {                  \
    const long long xk = OPERAND(a, k);                                  \
    const long long yk = reads_b(op) ? OPERAND(b, k) : 0;                \
    (void)yk; /* the integer powers take a constant */                    \
    mine[d * rb + k * T] = (EXPR);                                       \
  }                                                                      \
  write = false;                                                         \
  break

__device__ __forceinline__ long long column(const uint8_t* in, long long off, int size,
                                            long long row, bool live) {
  if (!live) return 0;
  return size == 8 ? reinterpret_cast<const long long*>(in + off)[row] : in[off + row] != 0;
}

__global__ void __launch_bounds__(kMaxThreads)
expression_vm_kernel(const __grid_constant__ Launch p, const uint8_t* __restrict__ in,
                     uint8_t* __restrict__ out, long long n) {
  // [n_regs + n_in][blockDim.x * kRows]: the registers, then the input columns
  extern __shared__ long long regs[];
  __shared__ long long cst[MAX_CONSTS];
  for (int i = threadIdx.x; i < p.n_consts; i += blockDim.x) cst[i] = p.consts[i];
  __syncthreads();
  const int T = blockDim.x;
  const int rb = T * kRows;                 // rows a block takes per step
  long long* const mine = regs + threadIdx.x;  // register q, row k: mine[q * rb + k * T]
  long long* const cols = mine + p.n_regs * rb;  // input column i, row k: cols[i * rb + k * T]
// operand r of row k (see launch_form): one shared-memory load from an address chosen by a
// uniform select, a row of the register file or a constant, with no branch
#define OPERAND(r, k)                                                 \
  ((r) < kConstOperand ? mine + (r) * rb : cst + ((r) - kConstOperand)) \
      [(k) * ((r) < kConstOperand ? T : 0)]
  for (long long row0 = static_cast<long long>(blockIdx.x) * rb; row0 < n;
       row0 += static_cast<long long>(gridDim.x) * rb) {
    long long row[kRows];
    bool live[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      row[k] = row0 + k * T + threadIdx.x;
      live[k] = row[k] < n;
    }
    // the input columns the program reads, at the thread's rows, into shared memory first: up to
    // kStaged columns' loads in flight at once, where the program would wait for one at a time
    for (int i0 = 0; i0 < p.n_in; i0 += kStaged) {
      const int count = min(kStaged, p.n_in - i0);
      long long staged[kStaged][kRows] = {};
#pragma unroll
      for (int j = 0; j < kStaged; ++j) {
        if (j < count && p.in_size[i0 + j]) {
#pragma unroll
          for (int k = 0; k < kRows; ++k)
            staged[j][k] = column(in, p.in[i0 + j], p.in_size[i0 + j], row[k], live[k]);
        }
      }
#pragma unroll
      for (int j = 0; j < kStaged; ++j) {
        if (j < count) {
#pragma unroll
          for (int k = 0; k < kRows; ++k) cols[(i0 + j) * rb + k * T] = staged[j][k];
        }
      }
    }
    // every thread reads the same instruction from the constant bank; the next one is fetched
    // while this one runs
    int2 ins = p.code[0];
    for (int pc = 0; pc < p.n_insns; ++pc) {
      const int2 next = p.code[pc + 1];
      const int op = ins.x & 0xff, d = ins.x >> 8, a = ins.y & 0x3ff, b = (ins.y >> 10) & 0x3ff,
                c = ins.y >> 20;
      // operands are read before the destination is written: a register may be both
      long long x[kRows], y[kRows], v[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        x[k] = reads_a(op) ? OPERAND(a, k) : 0;
        y[k] = reads_b(op) ? OPERAND(b, k) : 0;
      }
      bool write = true;
      switch (op) {
        case ST8: {
          long long* col = reinterpret_cast<long long*>(out + p.out[b]);
#pragma unroll
          for (int k = 0; k < kRows; ++k)
            if (live[k]) col[row[k]] = x[k];
          write = false;
          break;
        }
        case STB: {
          uint8_t* col = out + p.out[b];
#pragma unroll
          for (int k = 0; k < kRows; ++k)
            if (live[k]) col[row[k]] = x[k] != 0;
          write = false;
          break;
        }
        case ADD_I: EACH(static_cast<long long>(static_cast<unsigned long long>(x[k]) +
                                                static_cast<unsigned long long>(y[k])));
        case SUB_I: EACH(static_cast<long long>(static_cast<unsigned long long>(x[k]) -
                                                static_cast<unsigned long long>(y[k])));
        case MUL_I: EACH(static_cast<long long>(wmul(x[k], y[k])));
        case ADD_F: EACH(as_i(__dadd_rn(as_f(x[k]), as_f(y[k]))));
        case SUB_F: EACH(as_i(__dsub_rn(as_f(x[k]), as_f(y[k]))));
        case MUL_F: EACH(as_i(__dmul_rn(as_f(x[k]), as_f(y[k]))));
        case DIV_F: EACH(as_i(__ddiv_rn(as_f(x[k]), as_f(y[k]))));
        case POW_I: ROLLED(pow_int(xk, yk));
        case POW_F: ROLLED(as_i(pow(as_f(xk), as_f(yk))));
        case IPOW_I: ROLLED(ipow_int(xk, p.consts[b]));
        case IPOW_F: ROLLED(as_i(ipow_float(as_f(xk), p.consts[b])));
        case EQ_I: EACH(x[k] == y[k]);
        case NE_I: EACH(x[k] != y[k]);
        case LT_I: EACH(x[k] < y[k]);
        case LE_I: EACH(x[k] <= y[k]);
        case EQ_F: EACH(as_f(x[k]) == as_f(y[k]));
        case NE_F: EACH(as_f(x[k]) != as_f(y[k]));
        case LT_F: EACH(as_f(x[k]) < as_f(y[k]));
        case LE_F: EACH(as_f(x[k]) <= as_f(y[k]));
        case LT_U: EACH(static_cast<unsigned long long>(x[k]) <
                        static_cast<unsigned long long>(y[k]));
        case LE_U: EACH(static_cast<unsigned long long>(x[k]) <=
                        static_cast<unsigned long long>(y[k]));
        case AND: EACH(x[k] & y[k]);
        case OR: EACH(x[k] | y[k]);
        case XOR: EACH(x[k] ^ y[k]);
        case SHL: EACH((y[k] >= 0 && y[k] < 64)
                           ? static_cast<long long>(static_cast<unsigned long long>(x[k]) << y[k])
                           : 0);
        case SHR: EACH((y[k] >= 0 && y[k] < 64) ? (x[k] >> y[k]) : (x[k] < 0 ? -1 : 0));
        case NEG_I: EACH(static_cast<long long>(0ull - static_cast<unsigned long long>(x[k])));
        case NEG_F: EACH(x[k] ^ LLONG_MIN);  // flip the sign bit, as negation does
        case NOT_I: EACH(~x[k]);
        case NOT_B: EACH(x[k] ^ 1);
        case ABS_I: EACH(x[k] < 0
                             ? static_cast<long long>(0ull - static_cast<unsigned long long>(x[k]))
                             : x[k]);
        case ABS_F: EACH(x[k] & LLONG_MAX);  // clear the sign bit, as fabs does
        case SEL: EACH(x[k] != 0 ? y[k] : OPERAND(c, k));
        case I2F: EACH(as_i(__ll2double_rn(x[k])));
        case F2I: EACH(f2i(as_f(x[k])));
        case I2B: EACH(x[k] != 0);
        case F2B: EACH(as_f(x[k]) != 0.0);  // NaN != 0
        case B2F: EACH(as_i(x[k] != 0 ? 1.0 : 0.0));
        default: EACH(0LL);  // launch_form refuses any other opcode
      }
      if (write) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) mine[d * rb + k * T] = v[k];
      }
      ins = next;
    }
  }
}

#undef OPERAND
#undef ROLLED
#undef EACH

__global__ void expression_vm_empty_kernel() {}

// Threads a block for a program of `slots` = n_regs + n_in rows of shared memory: 128 while they
// fit the budget, halved below that (64 at MAX_REGS + MAX_COLS).
int threads_for(int slots) {
  int threads = kMaxThreads;
  while (threads > 32 && static_cast<long long>(slots) * threads * kRows * 8 > kRegBytes)
    threads /= 2;
  return threads;
}

int blocks_for(long long n, int threads) {
  const long long rb = static_cast<long long>(threads) * kRows;
  const long long blocks = (n + rb - 1) / rb;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

}  // namespace

// code: int32 [n_insns * 5] and consts: int64 [n_consts] in host memory (copied into the
// launch's parameters); n_regs the program's register count; in_off / out_off: host arrays of the
// byte offset of each input and output column inside in / out (device buffers). Returns a CUDA
// error code (0 on success); the launch is asynchronous on `stream`.
extern "C" int expression_vm(const int* code, int n_insns, const long long* consts,
                             int n_consts, int n_regs, const uint8_t* in, const long long* in_off,
                             int n_in, uint8_t* out, const long long* out_off, int n_out,
                             long long n, cudaStream_t stream) {
  if (n_insns < 0 || n_insns > MAX_INSNS || n_consts < 0 || n_consts > MAX_CONSTS ||
      n_regs < 1 || n_regs > MAX_REGS || n_in < 0 || n_in > MAX_COLS || n_out < 0 ||
      n_out > MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || n_insns == 0) return 0;
  // once per process: the register file may take more than the default 48 KB
  static const cudaError_t opened = cudaFuncSetAttribute(
      expression_vm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRegBytes);
  if (opened != cudaSuccess) return static_cast<int>(opened);
  Launch p{};
  p.n_insns = launch_form(code, n_insns, n_regs, &p);
  if (p.n_insns < 0) return static_cast<int>(cudaErrorInvalidValue);
  memcpy(p.consts, consts, sizeof(long long) * n_consts);
  p.n_consts = n_consts;
  memcpy(p.in, in_off, sizeof(long long) * n_in);
  memcpy(p.out, out_off, sizeof(long long) * n_out);
  p.n_in = n_in;
  p.n_regs = n_regs;
  const int threads = threads_for(n_regs + n_in);
  const size_t smem = static_cast<size_t>(n_regs + n_in) * threads * kRows * sizeof(long long);
  expression_vm_kernel<<<blocks_for(n, threads), threads, smem, stream>>>(p, in, out, n);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid expression_vm takes for n rows and a program of `slots` = n_regs +
// n_in rows of shared memory: the launch's own cost, the floor of the machine's time there.
extern "C" int expression_vm_empty(long long n, int slots, cudaStream_t stream) {
  if (n <= 0 || slots < 1 || slots > MAX_REGS + MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_for(slots);
  expression_vm_empty_kernel<<<blocks_for(n, threads), threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
