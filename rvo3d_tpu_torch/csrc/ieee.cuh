// IEEE-rounded scalar arithmetic in the operation order of PyTorch's CUDA
// kernels, shared by the port's hand-written kernels (vo_pairs.cu,
// env_drones.cu). Every + - * / and sqrt is a round-to-nearest intrinsic
// (__fadd_rn ... __dsqrt_rn), which nvcc never contracts into an FMA, so
// the build's -fmad stays on; asin, acos and nearbyint are the CUDA math
// library's, which PyTorch's CUDA ops call too.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename T> struct Ar;

template <> struct Ar<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float asin(float a) { return asinf(a); }
  static __device__ __forceinline__ float acos(float a) { return acosf(a); }
  static __device__ __forceinline__ float fmin(float a, float b) { return fminf(a, b); }
  // geometry.rnd for float32: round(x * 100) * float32(1 / 100)
  static __device__ __forceinline__ float rnd2(float x) {
    return mul(nearbyintf(mul(x, 100.0f)), (float)(1.0 / 100.0));
  }
};

template <> struct Ar<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double asin(double a) { return ::asin(a); }
  static __device__ __forceinline__ double acos(double a) { return ::acos(a); }
  static __device__ __forceinline__ double fmin(double a, double b) { return ::fmin(a, b); }
  // torch.round(x, decimals=2): nearbyint(x * 100) / 100
  static __device__ __forceinline__ double rnd2(double x) {
    return div(nearbyint(mul(x, 100.0)), 100.0);
  }
};

template <typename T>
__device__ __forceinline__ T inf() { return (T)INFINITY; }

// torch.sum over a contiguous last axis of 3 on CUDA (see the note above)
template <typename T>
__device__ __forceinline__ T sum3(T x0, T x1, T x2) {
  using A = Ar<T>;
  return A::add(A::add(A::add(T(0), x0), A::add(T(0), x2)), A::add(T(0), x1));
}

template <typename T>
__device__ __forceinline__ T dot3(T a0, T a1, T a2, T b0, T b1, T b2) {
  using A = Ar<T>;
  return sum3(A::mul(a0, b0), A::mul(a1, b1), A::mul(a2, b2));
}

// torch.clamp: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return x != x ? x : fmin(fmax(x, lo), hi);
}

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x != x ? x : fmax(x, lo);
}

// geometry.wraptopi
template <typename T>
__device__ __forceinline__ T wraptopi(T th) {
  using A = Ar<T>;
  const T pi = (T)M_PI, two_pi = (T)(2.0 * M_PI);
  th = th > pi ? A::sub(th, two_pi) : th;
  return th < -pi ? A::add(th, two_pi) : th;
}

template <typename T>
__device__ __forceinline__ T round2(T x, bool parity) {
  return parity ? Ar<T>::rnd2(x) : x;
}

// torch.amin's step: NaN propagates
template <typename T>
__device__ __forceinline__ T min_nan(T m, T v) {
  return (v != v || v < m) ? v : m;
}

}  // namespace
