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
// constants. Each thread walks rows in a grid-stride loop and runs the whole program for its
// row: loads read the packed input columns (8-byte values, or bool bytes), stores write the
// output columns in their dtypes and the chain's mask as bytes. Every thread of a warp runs the
// same instruction at once, so the switch over opcodes does not diverge.
//
// Semantics follow XLA with x64 where C++ leaves them open: integer arithmetic wraps (computed
// unsigned); a shift by a count outside [0, 64) gives 0 for << and the sign for >>; float to
// int64 truncates, saturates, and maps NaN to 0; float + - * / are the _rn intrinsics, so no
// multiply-add is contracted and `x * 2.0 - 1.0` rounds twice as XLA's does; subnormal operands
// and results of float arithmetic and comparisons flush to zero, as on XLA's CPU backend (the
// JAX package pins its expression kernels there); pow is the CUDA math library's.
//
// Bound on the H100: bytes. Each input value is read once and each output written once, and a
// program does a few dozen register operations per row at most. On the engine's path the columns
// come from the host, so the upload and readback around the launch take longer than the kernel.
//
// Design: the program and its constants are copied into shared memory by each block; the
// register file is a per-thread array of MAX_REGS (local memory, cached in L1). A first, simple
// kernel: a program of k instructions costs k dispatches per row.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_INSNS = 256;
constexpr int MAX_REGS = 64;
constexpr int MAX_CONSTS = 64;
constexpr int MAX_COLS = 32;
constexpr int kThreads = 256;

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

struct Offsets {
  long long in[MAX_COLS];
  long long out[MAX_COLS];
};

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

__global__ void __launch_bounds__(kThreads)
expression_vm_kernel(const int* __restrict__ code, int n_insns,
                     const long long* __restrict__ consts, int n_consts,
                     const uint8_t* __restrict__ in, uint8_t* __restrict__ out, Offsets off,
                     long long n) {
  __shared__ int prog[MAX_INSNS * 5];
  __shared__ long long cst[MAX_CONSTS];
  for (int i = threadIdx.x; i < n_insns * 5; i += blockDim.x) prog[i] = code[i];
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x) cst[i] = consts[i];
  __syncthreads();

  long long r[MAX_REGS];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; row < n;
       row += stride) {
    for (int pc = 0; pc < n_insns; ++pc) {
      const int* ins = prog + pc * 5;
      const int op = ins[0], d = ins[1], a = ins[2], b = ins[3], c = ins[4];
      // operands are read before the destination is written: a register may be both
      const long long x = (op == LD8 || op == LDB || op == CONST) ? 0 : r[a];
      const bool binary = !(op == LD8 || op == LDB || op == CONST || op == ST8 || op == STB ||
                            op == IPOW_I || op == IPOW_F || op >= NEG_I) || op == SEL;
      const long long y = binary ? r[b] : 0;
      long long v = 0;
      switch (op) {
        case LD8: v = reinterpret_cast<const long long*>(in + off.in[a])[row]; break;
        case LDB: v = in[off.in[a] + row] != 0; break;
        case CONST: v = cst[a]; break;
        case ST8: reinterpret_cast<long long*>(out + off.out[b])[row] = x; continue;
        case STB: out[off.out[b] + row] = x != 0; continue;
        case ADD_I: v = static_cast<long long>(static_cast<unsigned long long>(x) +
                                               static_cast<unsigned long long>(y)); break;
        case SUB_I: v = static_cast<long long>(static_cast<unsigned long long>(x) -
                                               static_cast<unsigned long long>(y)); break;
        case MUL_I: v = static_cast<long long>(wmul(x, y)); break;
        case ADD_F: v = as_i(__dadd_rn(as_f(x), as_f(y))); break;
        case SUB_F: v = as_i(__dsub_rn(as_f(x), as_f(y))); break;
        case MUL_F: v = as_i(__dmul_rn(as_f(x), as_f(y))); break;
        case DIV_F: v = as_i(__ddiv_rn(as_f(x), as_f(y))); break;
        case POW_I: v = pow_int(x, y); break;
        case POW_F: v = as_i(pow(as_f(x), as_f(y))); break;
        case IPOW_I: v = ipow_int(x, cst[b]); break;
        case IPOW_F: v = as_i(ipow_float(as_f(x), cst[b])); break;
        case EQ_I: v = x == y; break;
        case NE_I: v = x != y; break;
        case LT_I: v = x < y; break;
        case LE_I: v = x <= y; break;
        case EQ_F: v = as_f(x) == as_f(y); break;
        case NE_F: v = as_f(x) != as_f(y); break;
        case LT_F: v = as_f(x) < as_f(y); break;
        case LE_F: v = as_f(x) <= as_f(y); break;
        case LT_U: v = static_cast<unsigned long long>(x) < static_cast<unsigned long long>(y);
          break;
        case LE_U: v = static_cast<unsigned long long>(x) <= static_cast<unsigned long long>(y);
          break;
        case AND: v = x & y; break;
        case OR: v = x | y; break;
        case XOR: v = x ^ y; break;
        case SHL: v = (y >= 0 && y < 64)
                          ? static_cast<long long>(static_cast<unsigned long long>(x) << y)
                          : 0;
          break;
        case SHR: v = (y >= 0 && y < 64) ? (x >> y) : (x < 0 ? -1 : 0); break;
        case NEG_I: v = static_cast<long long>(0ull - static_cast<unsigned long long>(x)); break;
        case NEG_F: v = x ^ LLONG_MIN; break;  // flip the sign bit, as negation does
        case NOT_I: v = ~x; break;
        case NOT_B: v = x ^ 1; break;
        case ABS_I: v = x < 0 ? static_cast<long long>(0ull - static_cast<unsigned long long>(x))
                              : x;
          break;
        case ABS_F: v = x & LLONG_MAX; break;  // clear the sign bit, as fabs does
        case SEL: v = x != 0 ? y : r[c]; break;
        case I2F: v = as_i(__ll2double_rn(x)); break;
        case F2I: v = f2i(as_f(x)); break;
        case I2B: v = x != 0; break;
        case F2B: v = as_f(x) != 0.0; break;  // NaN != 0
        case B2F: v = as_i(x != 0 ? 1.0 : 0.0); break;
        default: v = 0; break;
      }
      r[d] = v;
    }
  }
}

}  // namespace

// code: int32 [n_insns * 5] and consts: int64 [n_consts] on the device; in_off / out_off: host
// arrays of the byte offset of each input and output column inside in / out. Returns a CUDA
// error code (0 on success); the launch is asynchronous on `stream`.
extern "C" int expression_vm(const int* code, int n_insns, const long long* consts,
                             int n_consts, const uint8_t* in, const long long* in_off, int n_in,
                             uint8_t* out, const long long* out_off, int n_out, long long n,
                             cudaStream_t stream) {
  if (n_insns < 0 || n_insns > MAX_INSNS || n_consts < 0 || n_consts > MAX_CONSTS ||
      n_in < 0 || n_in > MAX_COLS || n_out < 0 || n_out > MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || n_insns == 0) return 0;
  Offsets off;
  for (int i = 0; i < MAX_COLS; ++i) {
    off.in[i] = i < n_in ? in_off[i] : 0;
    off.out[i] = i < n_out ? out_off[i] : 0;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  expression_vm_kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      code, n_insns, consts, n_consts, in, out, off, n);
  return static_cast<int>(cudaGetLastError());
}
