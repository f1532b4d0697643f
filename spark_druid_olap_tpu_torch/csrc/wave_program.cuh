// The wave kernel's lane program (wave.cu): the instruction set, typed
// registers, the register file and the interpreter. Its semantics are
// PyTorch's for the traced aten ops (ops/cuda_wave.py), so a register holds
// what the plain version's tensor holds, bit for bit:
//   * integer results wrap to their dtype's width, two's complement;
//   * float32 / float64 arithmetic is one correctly rounded operation per
//     instruction (the _rn intrinsics on the device, never contracted into
//     an FMA);
//   * casts, floor division, remainder, minimum / maximum follow c10's
//     definitions (c10/util/generic_math.h): floor division and remainder
//     take the divisor's sign, minimum / maximum propagate NaN.
// `exec` runs one instruction over R rows at once, through a specialised
// handler where the host gave the instruction one (Instr.fast) — reading
// every operand of every row before it writes, so one dispatch serves R
// independent rows — else through the generic path one row at a time. A
// binary instruction's second operand may be an immediate (b == kImm).
// `run_program` is the same interpreter for one row. Under nvcc every
// function is __host__ __device__, and without nvcc the header compiles as
// plain C++ (the CPU tests build it with the host compiler and hold it
// against the plain version bit for bit).

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define SDOT_HD __host__ __device__ __forceinline__
#define SDOT_UNROLL _Pragma("unroll")
#else
#define SDOT_HD inline
#define SDOT_UNROLL
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
constexpr int kImm = 254;     // operand b is the instruction's immediate

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
  uint8_t op, dt, src, dst, a, b, c;
  uint8_t fast;           // a Fast handler, or kGeneric
  long long imm;          // kConst: int64, or float64 bits; kLoad: column
};

// Specialised handlers (Instr.fast): the host (ops/cuda_wave.py:fast_code)
// gives an instruction one when its (op, dtype) has one, and the handler
// computes exactly what the generic path computes for that pair, without
// its dispatch on op and dtype.
enum Fast : int {
  kGeneric = 0, kConstInt, kLoadBool, kLoadI8, kLoadU8, kLoadI16, kLoadI32,
  kLoadF32, kAddI32, kSubI32, kMulI32, kFloorDivI32, kEqInt, kNeInt, kLtInt,
  kLeInt, kGtInt, kGeInt, kEqF32, kNeF32, kLtF32, kLeF32, kGtF32, kGeF32,
  kAddF32, kSubF32, kMulF32, kDivF32, kAndInt, kOrInt, kXorInt, kNotBool,
  kWhereAny, kCastIntToI32, kCastIntToF32, kNumFast
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

// A register file of R rows: register i of row r of thread t is word
// (i * R + r) * stride + t, so a warp's threads read one register of one
// row from consecutive words. Word = long long holds every dtype. Word =
// int32_t holds a program whose registers are all 32 bits or narrower:
// integers are stored wrapped to their dtype and read back sign-extended,
// and a float32 sits in the low word, so reading rebuilds the Reg exactly.
template <int R, typename Word>
struct RegFile {
  Word* w;
  int stride;
  int t;
  SDOT_HD Reg get_at(int i, int r, int thread) const {
    Reg x;
    x.i = (long long)w[(i * R + r) * stride + thread];
    return x;
  }
  SDOT_HD Reg get(int i, int r) const { return get_at(i, r, t); }
  SDOT_HD void set(int i, int r, Reg x) const {
    w[(i * R + r) * stride + t] = (Word)x.i;
  }
};

// A constant of dtype dt from its immediate (int64, or float64 bits).
SDOT_HD Reg const_value(int dt, long long imm) {
  Reg c;
  if (dt == kF32) c.f = (float)bits_to_f64(imm);
  else if (dt == kF64) c.d = bits_to_f64(imm);
  else c.i = imm;
  return c;
}

// Operand b of a binary instruction for row r: a register, or (b == kImm)
// the instruction's immediate, in the instruction's dtype.
template <class File>
SDOT_HD Reg operand_b(const Instr& in, const File& f, int r) {
  return in.b == kImm ? const_value(in.dt, in.imm) : f.get(in.b, r);
}

template <int R, class File, class Fn>
SDOT_HD void fast_unary(const Instr& in, const File& f, Fn fn) {
  Reg a[R];
  SDOT_UNROLL
  for (int r = 0; r < R; ++r) a[r] = f.get(in.a, r);
  SDOT_UNROLL
  for (int r = 0; r < R; ++r) f.set(in.dst, r, fn(a[r]));
}

template <int R, class File, class Fn>
SDOT_HD void fast_binary(const Instr& in, const File& f, Fn fn) {
  Reg a[R], b[R];
  SDOT_UNROLL
  for (int r = 0; r < R; ++r) {
    a[r] = f.get(in.a, r);
    b[r] = operand_b(in, f, r);
  }
  SDOT_UNROLL
  for (int r = 0; r < R; ++r) f.set(in.dst, r, fn(a[r], b[r]));
}

template <int R, typename T, bool kBoolCol, class File>
SDOT_HD void fast_load(const Instr& in, const File& f, const void* const* cols,
                       const long long* rows) {
  const T* col = static_cast<const T*>(cols[in.imm]);
  T v[R];
  SDOT_UNROLL
  for (int r = 0; r < R; ++r) v[r] = col[rows[r]];
  SDOT_UNROLL
  for (int r = 0; r < R; ++r) {
    Reg x;
    if (kBoolCol) x.i = v[r] != 0;
    else x.i = (long long)v[r];
    f.set(in.dst, r, x);
  }
}

template <int R, class File>
SDOT_HD void fast_load_f32(const Instr& in, const File& f,
                           const void* const* cols, const long long* rows) {
  const float* col = static_cast<const float*>(cols[in.imm]);
  float v[R];
  SDOT_UNROLL
  for (int r = 0; r < R; ++r) v[r] = col[rows[r]];
  SDOT_UNROLL
  for (int r = 0; r < R; ++r) {
    Reg x;
    x.f = v[r];
    f.set(in.dst, r, x);
  }
}

SDOT_HD Reg int_reg(long long v) {
  Reg r;
  r.i = v;
  return r;
}

SDOT_HD Reg f32_reg(float v) {
  Reg r;
  r.f = v;
  return r;
}

SDOT_HD long long i32(long long v) {
  return (long long)(int32_t)(uint32_t)(unsigned long long)v;
}

// The specialised handler of `in`; false when it has none.
template <int R, class File>
SDOT_HD bool exec_fast(const Instr& in, const File& f,
                       const void* const* cols, const long long* rows) {
  switch (in.fast) {
    case kConstInt: {
      SDOT_UNROLL
      for (int r = 0; r < R; ++r) f.set(in.dst, r, int_reg(in.imm));
      return true;
    }
    case kLoadBool: fast_load<R, uint8_t, true>(in, f, cols, rows);
      return true;
    case kLoadI8: fast_load<R, int8_t, false>(in, f, cols, rows);
      return true;
    case kLoadU8: fast_load<R, uint8_t, false>(in, f, cols, rows);
      return true;
    case kLoadI16: fast_load<R, int16_t, false>(in, f, cols, rows);
      return true;
    case kLoadI32: fast_load<R, int32_t, false>(in, f, cols, rows);
      return true;
    case kLoadF32: fast_load_f32<R>(in, f, cols, rows); return true;
    case kAddI32:
      fast_binary<R>(in, f, [](Reg a, Reg b) {
        return int_reg(i32((long long)((unsigned long long)a.i
                                       + (unsigned long long)b.i)));
      });
      return true;
    case kSubI32:
      fast_binary<R>(in, f, [](Reg a, Reg b) {
        return int_reg(i32((long long)((unsigned long long)a.i
                                       - (unsigned long long)b.i)));
      });
      return true;
    case kMulI32:
      fast_binary<R>(in, f, [](Reg a, Reg b) {
        return int_reg(i32((long long)((unsigned long long)a.i
                                       * (unsigned long long)b.i)));
      });
      return true;
    case kFloorDivI32:
      fast_binary<R>(in, f, [](Reg a, Reg b) {
        return int_reg(i32(floor_div_int(a.i, b.i)));
      });
      return true;
    case kEqInt:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.i == b.i); });
      return true;
    case kNeInt:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.i != b.i); });
      return true;
    case kLtInt:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.i < b.i); });
      return true;
    case kLeInt:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.i <= b.i); });
      return true;
    case kGtInt:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.i > b.i); });
      return true;
    case kGeInt:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.i >= b.i); });
      return true;
    case kEqF32:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.f == b.f); });
      return true;
    case kNeF32:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.f != b.f); });
      return true;
    case kLtF32:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.f < b.f); });
      return true;
    case kLeF32:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.f <= b.f); });
      return true;
    case kGtF32:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.f > b.f); });
      return true;
    case kGeF32:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.f >= b.f); });
      return true;
    case kAddF32:
      fast_binary<R>(in, f, [](Reg a, Reg b) {
        return f32_reg(f32_add(a.f, b.f));
      });
      return true;
    case kSubF32:
      fast_binary<R>(in, f, [](Reg a, Reg b) {
        return f32_reg(f32_sub(a.f, b.f));
      });
      return true;
    case kMulF32:
      fast_binary<R>(in, f, [](Reg a, Reg b) {
        return f32_reg(f32_mul(a.f, b.f));
      });
      return true;
    case kDivF32:
      fast_binary<R>(in, f, [](Reg a, Reg b) {
        return f32_reg(f32_div(a.f, b.f));
      });
      return true;
    case kAndInt:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.i & b.i); });
      return true;
    case kOrInt:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.i | b.i); });
      return true;
    case kXorInt:
      fast_binary<R>(in, f, [](Reg a, Reg b) { return int_reg(a.i ^ b.i); });
      return true;
    case kNotBool:
      fast_unary<R>(in, f, [](Reg a) { return int_reg(!a.i); });
      return true;
    case kWhereAny: {
      Reg a[R], b[R], c[R];
      SDOT_UNROLL
      for (int r = 0; r < R; ++r) {
        a[r] = f.get(in.a, r);
        b[r] = f.get(in.b, r);
        c[r] = f.get(in.c, r);
      }
      SDOT_UNROLL
      for (int r = 0; r < R; ++r) f.set(in.dst, r, a[r].i ? b[r] : c[r]);
      return true;
    }
    case kCastIntToI32:
      fast_unary<R>(in, f, [](Reg a) { return int_reg(i32(a.i)); });
      return true;
    case kCastIntToF32:
      fast_unary<R>(in, f, [](Reg a) { return f32_reg(i64_to_f32(a.i)); });
      return true;
    default:
      return false;
  }
}

// The generic path: one instruction for one row (r of file f).
template <class File>
SDOT_HD Reg exec_row(const Instr& in, const File& f, const void* const* cols,
                     long long row, int r) {
  const int op = in.op;
  const int dt = in.dt;
  Reg out;
  if (op == kLoad) {
    out = load_col(cols[in.imm], dt, row);
  } else if (op == kConst) {
    out = const_value(dt, in.imm);
  } else if (op == kWhere) {
    out = f.get(in.a, r).i ? f.get(in.b, r) : f.get(in.c, r);
  } else if (op == kCast) {
    out = cast(f.get(in.a, r), in.src, dt);
  } else if ((op >= kNeg && op <= kTrunc) || op == kNot) {
    out = unary(op, dt, f.get(in.a, r));
  } else {
    const Reg a = f.get(in.a, r);
    const Reg b = operand_b(in, f, r);
    if (op >= kEq && op <= kGe) {
      if (dt == kF32) out.i = compare(op, a.f, b.f);
      else if (dt == kF64) out.i = compare(op, a.d, b.d);
      else out.i = compare(op, a.i, b.i);
    } else if (dt == kF32) {
      out.f = f32_binary(op, a.f, b.f);
    } else if (dt == kF64) {
      out.d = f64_binary(op, a.d, b.d);
    } else {
      out.i = int_binary(op, dt, a.i, b.i);
    }
  }
  return out;
}

// One instruction over the R rows `rows` of file `f`: its specialised
// handler where it has one (all R rows at once), else the generic path one
// row after another (rows' registers are disjoint, so the order is free).
template <int R, class File>
SDOT_HD void exec(const Instr& in, const File& f, const void* const* cols,
                  const long long* rows) {
  if (exec_fast<R>(in, f, cols, rows)) return;
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int r = 0; r < R; ++r) {
    f.set(in.dst, r, exec_row(in, f, cols, rows[r], r));
  }
}

// The program over R rows. The next instruction is read before the current
// one writes its registers, so its load overlaps the current one's work.
template <int R, class File>
SDOT_HD void run_rows(const Instr* prog, int n_instr, const void* const* cols,
                      const long long* rows, const File& f) {
  if (n_instr <= 0) return;
  Instr next = prog[0];
  for (int pc = 0; pc < n_instr; ++pc) {
    const Instr in = next;
    if (pc + 1 < n_instr) next = prog[pc + 1];
    exec<R>(in, f, cols, rows);
  }
}

// One row of the lane program, registers in `regs`.
SDOT_HD void run_program(const Instr* prog, int n_instr,
                         const void* const* cols, long long row, Reg* regs) {
  const RegFile<1, long long> f{reinterpret_cast<long long*>(regs), 1, 0};
  run_rows<1>(prog, n_instr, cols, &row, f);
}

}  // namespace sdot_wave_program
