// Frame-invariant column gather for Hopper (sm_90a):
//
//   out[n, t, k] = xs[n, t, col[n, k]]      xs (N, T, C), k < K
//
// written through given output strides, so one kernel writes the layouts of
// three TPU kernels:
//
//   * `_gather_cols_manual_kernel` (scripts/exp_colgather.py:117): explicit
//     columns cols (N, K) int32, out (N, T, K) in xs's dtype;
//   * `_gather_kernel` (scripts/exp_pallas_gather.py:63): the blank and
//     label channels of xs (N, T, U, V), each (N, T, U) fp32;
//   * `_sparse_gather_kernel` (scripts/exp_pallas_gather.py:124): the same
//     two channels from the flat (N, T, U*V) view, laid out (N, U, T).
//
// For the last two the kernel derives the columns from labels_ext (N, U):
// k < U is the blank column u*V + blank, k >= U the label column
// u*V + lab[n, u] (u = k mod U); the output is (2, N, T, U) or (2, N, U, T),
// channel k / U.  A column outside [0, C), or a label outside [0, V), gives
// 0 by a compare and select: nothing is loaded there, so no read leaves the
// buffer, and the wrapper needs no host sync to check the indices.
//
// What bounds it on this card: bytes, and the latency of scattered loads.
// Each gathered value sits in its own 32-byte sector (columns of one frame
// are far apart; one column's frames are C elements apart), so the bound is
// one sector per value plus the outputs: 7.3 MB, 2.2 us at N=32, T=150,
// U=21, V=5000.  Design: one thread per output value, each a single direct
// load and store, with the fastest-varying thread index on the output's
// unit-stride dimension (k, or t for the (N, U, T) layout) so that stores
// coalesce.  The TPU kernels' window DMAs, one-hot lane select and full-V
// stream are workarounds for a machine without cheap per-element offsets;
// here a value is one load.  Element offsets are 64-bit: N*T*U*V passes
// 2^31 at N >= 137 of T=150, U=21, V=5000.  Values are moved and at most
// widened (to fp32; fp64 rounds to nearest), exactly as the plain torch
// versions do, so kernel and plain version agree bit for bit.
//
// Launches on the caller's stream; allocates nothing; returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename O, typename E>
__device__ __forceinline__ O convert(E x);
template <>
__device__ __forceinline__ float convert<float, float>(float x) { return x; }
template <>
__device__ __forceinline__ double convert<double, double>(double x) { return x; }
template <>
__device__ __forceinline__ __half convert<__half, __half>(__half x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16, __nv_bfloat16>(
    __nv_bfloat16 x) {
  return x;
}
template <>
__device__ __forceinline__ float convert<float, double>(double x) {
  return __double2float_rn(x);
}
template <>
__device__ __forceinline__ float convert<float, __half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float convert<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename O>
__device__ __forceinline__ O zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ double zero<double>() { return 0.0; }
template <>
__device__ __forceinline__ __half zero<__half>() { return __ushort_as_half(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// Sizes and output strides of one launch.  Output (n, t, k) with
// k = h * Kh + j goes to n*s_n + t*s_t + j*s_k + h*s_h.
struct Layout {
  long long total;  // N * T * K threads
  long long C;      // columns of a frame
  long long s_n, s_t, s_k, s_h;
  int frames, K, Kh;
  int t_inner;  // 1: t is the fastest thread index, else k
  int V, blank;
};

// kLabels false: idx is cols (N, K), Kh == K.  kLabels true: idx is
// labels_ext (N, Kh), K = 2 * Kh: blank columns, then label columns.
template <typename E, typename O, bool kLabels>
__global__ void __launch_bounds__(kThreads)
column_gather_kernel(const E* __restrict__ xs, const int* __restrict__ idx,
                     O* __restrict__ out, const Layout L) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= L.total) return;
  long long n;
  int t, k;
  if (L.t_inner) {  // i = (n * K + k) * T + t
    t = static_cast<int>(i % L.frames);
    const long long nk = i / L.frames;
    k = static_cast<int>(nk % L.K);
    n = nk / L.K;
  } else {  // i = (n * T + t) * K + k
    k = static_cast<int>(i % L.K);
    const long long nt = i / L.K;
    t = static_cast<int>(nt % L.frames);
    n = nt / L.frames;
  }
  const int h = k / L.Kh;
  const int j = k - h * L.Kh;
  long long col;
  bool valid;
  if (kLabels) {
    const int lab = h ? idx[n * L.Kh + j] : L.blank;
    valid = lab >= 0 && lab < L.V;
    col = static_cast<long long>(j) * L.V + lab;
  } else {
    col = idx[n * L.K + k];
    valid = col >= 0 && col < L.C;
  }
  O v = zero<O>();
  if (valid) v = convert<O, E>(xs[(n * L.frames + t) * L.C + col]);
  out[n * L.s_n + t * L.s_t + j * L.s_k + h * L.s_h] = v;
}

template <typename E, typename O, bool kLabels>
int launch(const void* xs, const int* idx, void* out, const Layout& L,
           cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>((L.total + kThreads - 1) / kThreads));
  column_gather_kernel<E, O, kLabels><<<grid, kThreads, 0, s>>>(
      static_cast<const E*>(xs), idx, static_cast<O*>(out), L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 float16, 3 bfloat16.  xs (N, T, C),
// cols (N, K) -> out (N, T, K) in xs's dtype.
extern "C" int rnnt_gather_columns(const void* xs, int dtype, const int* cols,
                                   void* out, int N, int frames, long long C,
                                   int K, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Layout L{};
  L.total = static_cast<long long>(N) * frames * K;
  L.C = C;
  L.s_n = static_cast<long long>(frames) * K;
  L.s_t = K;
  L.s_k = 1;
  L.frames = frames;
  L.K = L.Kh = K;
  switch (dtype) {
    case 0:
      return launch<float, float, false>(xs, cols, out, L, s);
    case 1:
      return launch<double, double, false>(xs, cols, out, L, s);
    case 2:
      return launch<__half, __half, false>(xs, cols, out, L, s);
    case 3:
      return launch<__nv_bfloat16, __nv_bfloat16, false>(xs, cols, out, L, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The blank and label channels of xs (N, T, U*V), labels_ext (N, U), as
// fp32 into out: (2, N, T, U) when ut_layout is 0, (2, N, U, T) when 1.
extern "C" int rnnt_gather_blank_label(const void* xs, int dtype,
                                       const int* labels_ext, float* out,
                                       int N, int frames, int U, int V,
                                       int blank, int ut_layout, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Layout L{};
  L.total = static_cast<long long>(N) * frames * 2 * U;
  L.C = static_cast<long long>(U) * V;
  L.s_n = static_cast<long long>(frames) * U;
  L.s_t = ut_layout ? 1 : U;
  L.s_k = ut_layout ? frames : 1;
  L.s_h = static_cast<long long>(N) * frames * U;
  L.frames = frames;
  L.K = 2 * U;
  L.Kh = U;
  L.t_inner = ut_layout;
  L.V = V;
  L.blank = blank;
  switch (dtype) {
    case 0:
      return launch<float, float, true>(xs, labels_ext, out, L, s);
    case 1:
      return launch<double, float, true>(xs, labels_ext, out, L, s);
    case 2:
      return launch<__half, float, true>(xs, labels_ext, out, L, s);
    case 3:
      return launch<__nv_bfloat16, float, true>(xs, labels_ext, out, L, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rnnt_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
