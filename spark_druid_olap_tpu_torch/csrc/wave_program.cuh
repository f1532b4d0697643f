// The wave kernel's lane program (wave.cu): the instruction set, typed
// registers and the per-row interpreter. Its semantics are PyTorch's for the
// traced aten ops (ops/cuda_wave.py), so a register holds what the plain
// version's tensor holds, bit for bit:
//   * integer results wrap to their dtype's width, two's complement;
//   * float32 / float64 arithmetic is one correctly rounded operation per
//     instruction (the _rn intrinsics on the device, never contracted into
//     an FMA);
//   * casts, floor division, remainder, minimum / maximum follow c10's
//     definitions (c10/util/generic_math.h): floor division and remainder
//     take the divisor's sign, minimum / maximum propagate NaN.
// Under nvcc every function is __host__ __device__, so the same header can
// also be compiled for the host.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define SDOT_HD __host__ __device__ __forceinline__
#else
#define SDOT_HD inline
#endif

namespace sdot_wave_program {

#if defined(__CUDA_ARCH__)
SDOT_HD float f32_add(float a, float b) { return __fadd_rn(a, b); }
SDOT_HD float f32_sub(float a, float b) { return __fsub_rn(a, b); }
SDOT_HD float f32_mul(float a, float b) { return __fmul_rn(a, b); }
SDOT_HD float f32_div(float a, float b) { return __fdiv_rn(a, b); }
SDOT_HD double f64_add(double a, double b) { return __dadd_rn(a, b); }
SDOT_HD double f64_sub(double a, double b) { return __dsub_rn(a, b); }
SDOT_HD double f64_mul(double a, double b) { return __dmul_rn(a, b); }
SDOT_HD double f64_div(double a, double b) { return __ddiv_rn(a, b); }
SDOT_HD float f64_to_f32(double a) { return __double2float_rn(a); }
SDOT_HD float i64_to_f32(long long a) { return __ll2float_rn(a); }
SDOT_HD double i64_to_f64(long long a) { return __ll2double_rn(a); }
SDOT_HD double bits_to_f64(long long a) { return __longlong_as_double(a); }
#else
SDOT_HD float f32_add(float a, float b) { return a + b; }
SDOT_HD float f32_sub(float a, float b) { return a - b; }
SDOT_HD float f32_mul(float a, float b) { return a * b; }
SDOT_HD float f32_div(float a, float b) { return a / b; }
SDOT_HD double f64_add(double a, double b) { return a + b; }
SDOT_HD double f64_sub(double a, double b) { return a - b; }
SDOT_HD double f64_mul(double a, double b) { return a * b; }
SDOT_HD double f64_div(double a, double b) { return a / b; }
SDOT_HD float f64_to_f32(double a) { return (float)a; }
SDOT_HD float i64_to_f32(long long a) { return (float)a; }
SDOT_HD double i64_to_f64(long long a) { return (double)a; }
SDOT_HD double bits_to_f64(long long a) {
  double d;
  memcpy(&d, &a, sizeof d);
  return d;
}
#endif

constexpr int kMaxInstrs = 1024;
constexpr int kMaxRegs = 128;
constexpr int kMaxCols = 64;
constexpr int kNone = 255;

// register dtypes (ops/cuda_wave.py:DTYPES)
enum DType : int {
  kBool = 0, kI8 = 1, kI16 = 2, kI32 = 3, kI64 = 4, kU8 = 5, kF32 = 6,
  kF64 = 7
};

// opcodes (ops/cuda_wave.py:OPS)
enum Op : int {
  kLoad = 0, kConst, kCast, kAdd, kSub, kMul, kDiv, kFloorDiv, kTruncDiv,
  kRem, kNeg, kAbs, kFloor, kCeil, kRound, kTrunc, kMinimum, kMaximum,
  kEq, kNe, kLt, kLe, kGt, kGe, kAnd, kOr, kXor, kNot, kWhere
};

struct Instr {            // 16 bytes
  uint8_t op, dt, src, dst, a, b, c, pad;
  long long imm;          // kConst: int64, or float64 bits; kLoad: column
};

// a register: integers and bools sign-extended into i, float32 in f,
// float64 in d
union Reg {
  long long i;
  double d;
  float f;
};

SDOT_HD bool is_float_dt(int dt) { return dt >= kF32; }

// wrap a 64-bit integer result into dtype dt (two's complement), as PyTorch
// computes in that dtype
SDOT_HD long long wrap(int dt, long long v) {
  switch (dt) {
    case kBool: return v != 0;
    case kI8: return (long long)(int8_t)(uint8_t)(unsigned long long)v;
    case kI16: return (long long)(int16_t)(uint16_t)(unsigned long long)v;
    case kI32: return (long long)(int32_t)(uint32_t)(unsigned long long)v;
    case kU8: return (long long)(uint8_t)(unsigned long long)v;
    default: return v;
  }
}

SDOT_HD Reg load_col(const void* col, int dt, long long row) {
  Reg r;
  switch (dt) {
    case kBool:
    case kU8: r.i = static_cast<const uint8_t*>(col)[row]; break;
    case kI8: r.i = static_cast<const int8_t*>(col)[row]; break;
    case kI16: r.i = static_cast<const int16_t*>(col)[row]; break;
    case kI32: r.i = static_cast<const int32_t*>(col)[row]; break;
    case kI64: r.i = static_cast<const long long*>(col)[row]; break;
    case kF32: r.f = static_cast<const float*>(col)[row]; break;
    default: r.d = static_cast<const double*>(col)[row]; break;
  }
  if (dt == kBool) r.i = r.i != 0;
  return r;
}

SDOT_HD Reg cast(Reg x, int src, int dst) {
  Reg r;
  if (is_float_dt(src)) {
    const double v = src == kF32 ? (double)x.f : x.d;
    if (dst == kF32) r.f = src == kF32 ? x.f : f64_to_f32(x.d);
    else if (dst == kF64) r.d = v;
    else if (dst == kBool) r.i = v != 0.0;     // NaN -> true, as in C++
    else r.i = wrap(dst, (long long)v);         // truncates toward zero
  } else {
    if (dst == kF32) r.f = i64_to_f32(x.i);
    else if (dst == kF64) r.d = i64_to_f64(x.i);
    else r.i = wrap(dst, x.i);
  }
  return r;
}

// c10::div_floor_floating
template <typename T>
SDOT_HD T floor_div_float(T a, T b) {
  if (b == T(0)) return a / b;
  const T mod = fmod(a, b);
  T div = (a - mod) / b;
  if ((mod != T(0)) && ((b < T(0)) != (mod < T(0)))) div -= T(1);
  T floordiv;
  if (div != T(0)) {
    floordiv = floor(div);
    if (div - floordiv > T(0.5)) floordiv += T(1);
  } else {
    floordiv = copysign(T(0), a / b);
  }
  return floordiv;
}

// c10::div_mod for floating types (torch.remainder)
template <typename T>
SDOT_HD T rem_float(T a, T b) {
  if (b == T(0)) return fmod(a, b);
  T mod = fmod(a, b);
  if (mod == T(0)) mod = copysign(T(0), b);
  else if ((b < T(0)) != (mod < T(0))) mod += b;
  return mod;
}

// c10::div_floor_integer / torch.remainder for integers (a zero divisor
// gives 0; PyTorch raises there on the CPU)
SDOT_HD long long floor_div_int(long long a, long long b) {
  if (b == 0) return 0;
  if (b == -1) return (long long)(0ull - (unsigned long long)a);
  const long long q = a / b;
  const long long r = a % b;
  return (r != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

SDOT_HD long long rem_int(long long a, long long b) {
  if (b == 0 || b == -1) return 0;
  long long r = a % b;
  if (r != 0 && ((b < 0) != (r < 0))) r += b;
  return r;
}

template <typename T>
SDOT_HD T fminimum(T a, T b) {   // torch.minimum
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

template <typename T>
SDOT_HD T fmaximum(T a, T b) {   // torch.maximum
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

template <typename T>
SDOT_HD bool compare(int op, T a, T b) {
  switch (op) {
    case kEq: return a == b;
    case kNe: return a != b;
    case kLt: return a < b;
    case kLe: return a <= b;
    case kGt: return a > b;
    default: return a >= b;
  }
}

SDOT_HD float f32_binary(int op, float a, float b) {
  switch (op) {
    case kAdd: return f32_add(a, b);
    case kSub: return f32_sub(a, b);
    case kMul: return f32_mul(a, b);
    case kDiv: return f32_div(a, b);
    case kFloorDiv: return floor_div_float(a, b);
    case kTruncDiv: return truncf(f32_div(a, b));
    case kRem: return rem_float(a, b);
    case kMinimum: return fminimum(a, b);
    case kMaximum: return fmaximum(a, b);
    default: return a;     // not emitted for floats
  }
}

SDOT_HD double f64_binary(int op, double a, double b) {
  switch (op) {
    case kAdd: return f64_add(a, b);
    case kSub: return f64_sub(a, b);
    case kMul: return f64_mul(a, b);
    case kDiv: return f64_div(a, b);
    case kFloorDiv: return floor_div_float(a, b);
    case kTruncDiv: return trunc(f64_div(a, b));
    case kRem: return rem_float(a, b);
    case kMinimum: return fminimum(a, b);
    case kMaximum: return fmaximum(a, b);
    default: return a;     // not emitted for floats
  }
}

SDOT_HD long long int_binary(int op, int dt, long long a, long long b) {
  const unsigned long long ua = (unsigned long long)a;
  const unsigned long long ub = (unsigned long long)b;
  switch (op) {
    case kAdd: return wrap(dt, (long long)(ua + ub));
    case kSub: return wrap(dt, (long long)(ua - ub));
    case kMul: return wrap(dt, (long long)(ua * ub));
    case kFloorDiv: return wrap(dt, floor_div_int(a, b));
    case kTruncDiv:
      return b == 0 ? 0 : wrap(dt, b == -1 ? (long long)(0ull - ua) : a / b);
    case kRem: return rem_int(a, b);
    case kMinimum: return a < b ? a : b;
    case kMaximum: return a > b ? a : b;
    case kAnd: return a & b;
    case kOr: return a | b;
    case kXor: return a ^ b;
    default: return 0;     // kDiv is not emitted for integers
  }
}

SDOT_HD Reg unary(int op, int dt, Reg x) {
  Reg r;
  if (dt == kF32) {
    switch (op) {
      case kNeg: r.f = -x.f; break;
      case kAbs: r.f = fabsf(x.f); break;
      case kFloor: r.f = floorf(x.f); break;
      case kCeil: r.f = ceilf(x.f); break;
      case kRound: r.f = rintf(x.f); break;
      default: r.f = truncf(x.f); break;
    }
  } else if (dt == kF64) {
    switch (op) {
      case kNeg: r.d = -x.d; break;
      case kAbs: r.d = fabs(x.d); break;
      case kFloor: r.d = floor(x.d); break;
      case kCeil: r.d = ceil(x.d); break;
      case kRound: r.d = rint(x.d); break;
      default: r.d = trunc(x.d); break;
    }
  } else if (op == kNot) {
    r.i = dt == kBool ? !x.i : wrap(dt, ~x.i);
  } else if (op == kNeg) {
    r.i = wrap(dt, (long long)(0ull - (unsigned long long)x.i));
  } else if (op == kAbs) {
    r.i = wrap(dt, x.i < 0 ? (long long)(0ull - (unsigned long long)x.i)
                           : x.i);
  } else {
    r.i = x.i;      // floor / ceil / round / trunc of an integer
  }
  return r;
}

// One row of the lane program.
SDOT_HD void run_program(const Instr* prog, int n_instr,
                         const void* const* cols, long long row, Reg* regs) {
  for (int pc = 0; pc < n_instr; ++pc) {
    const Instr in = prog[pc];
    const int op = in.op;
    const int dt = in.dt;
    Reg r;
    if (op == kLoad) {
      r = load_col(cols[in.imm], dt, row);
    } else if (op == kConst) {
      if (dt == kF32) r.f = (float)bits_to_f64(in.imm);
      else if (dt == kF64) r.d = bits_to_f64(in.imm);
      else r.i = in.imm;
    } else if (op == kCast) {
      r = cast(regs[in.a], in.src, dt);
    } else if (op == kWhere) {
      r = regs[in.a].i ? regs[in.b] : regs[in.c];
    } else if ((op >= kNeg && op <= kTrunc) || op == kNot) {
      r = unary(op, dt, regs[in.a]);
    } else if (op >= kEq && op <= kGe) {
      const Reg a = regs[in.a];
      const Reg b = regs[in.b];
      if (dt == kF32) r.i = compare(op, a.f, b.f);
      else if (dt == kF64) r.i = compare(op, a.d, b.d);
      else r.i = compare(op, a.i, b.i);
    } else {
      const Reg a = regs[in.a];
      const Reg b = regs[in.b];
      if (dt == kF32) r.f = f32_binary(op, a.f, b.f);
      else if (dt == kF64) r.d = f64_binary(op, a.d, b.d);
      else r.i = int_binary(op, dt, a.i, b.i);
    }
    regs[in.dst] = r;
  }
}

}  // namespace sdot_wave_program
