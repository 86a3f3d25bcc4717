// Frame-invariant column gather for Hopper (sm_90a):
//
//   out[n, t, k] = xs[n, t, col[n, k]]      xs (N, T, C), k < K
//
// written through given output strides, so one kernel writes the main
// path's lattice and the layouts of three TPU kernels:
//
//   * the loss's blank/label lattice (N, T, U, 2) in xs's dtype, channel 0
//     the blank and 1 the label of row u (functional/gather.py; the JAX
//     package forms it with XLA gathers);
//   * `_gather_cols_manual_kernel` (scripts/exp_colgather.py:117): explicit
//     columns cols (N, K) int32, out (N, T, K) in xs's dtype;
//   * `_gather_kernel` (scripts/exp_pallas_gather.py:63): the blank and
//     label channels of xs (N, T, U, V), (2, N, T, U) fp32;
//   * `_sparse_gather_kernel` (scripts/exp_pallas_gather.py:124): the same
//     two channels from the flat (N, T, U*V) view, laid out (2, N, U, T).
//
// For the last three the kernel derives the columns from labels_ext (N, U):
// column (u, h) is u*V + blank for h = 0 and u*V + lab[n, u] for h = 1.  A
// column outside [0, C), or a label outside [0, V), gives 0 by a compare and
// select: nothing is loaded there, so no read leaves the buffer, and the
// wrapper needs no host sync to check the indices.
//
// What bounds it on this card: bytes, and how the memory serves scattered
// loads.  Each gathered value sits in its own 32-byte sector (columns of
// one frame are far apart; one column's frames are C elements apart), so
// the bound is one sector per value plus the outputs: 7.3 MB, 2.2 us at
// N=32, T=150, U=21, V=5000.  Design: a thread owns one column (n, k) of
// kF = 8 frames and issues its 8 loads before its first store.  On an H100
// that runs as fast as one load a thread did (18-24 % of the bound at
// N=32..144), so a thread's latency is not what bounds it; the memory's
// rate for scattered sectors is the likely limit (untested).  Consecutive
// threads take consecutive k, or consecutive frames for the (N, U, T)
// layout, so that for each of the 8 frames a warp's stores land on the
// output's unit-stride dimension together.  Blocks are numbered
// sample-major; the block and thread indices split with 32-bit divisions
// once a thread, and element offsets are 64-bit (N*T*U*V passes 2^31 at
// N >= 137 of T=150, U=21, V=5000).  The TPU kernels' window DMAs, one-hot
// lane select and full-V stream are workarounds for a machine without
// cheap per-element offsets; here a value is one load.  Values are moved,
// and in the two fp32 layouts widened (fp64 rounds to nearest), exactly as
// the plain torch versions do, so kernel and plain version agree bit for
// bit.
//
// Launches on the caller's stream; allocates nothing; returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kF = 8;  // frames (independent loads) a thread

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

// Sizes and output strides of one launch.  Column k is (j, h): with labels
// j = k % Kh, h = k / Kh (planar), or j = k / 2, h = k % 2 (interleaved);
// without, j = k, h = 0.  Output (n, t, j, h) goes to
// n*s_n + t*s_t + j*s_k + h*s_h.
struct Layout {
  long long C;  // columns of a frame
  long long s_n, s_t, s_k, s_h;
  int frames, K, Kh;
  int groups;       // frame groups of kF: ceil(frames / kF)
  int blocks;       // blocks a sample: ceil(groups * K / kThreads)
  int t_inner;      // 1: consecutive threads take consecutive frames
  int interleave;   // 1: (j, h) = (k / 2, k % 2)
  int V, blank;
};

// kLabels false: idx is cols (N, K).  kLabels true: idx is labels_ext
// (N, Kh), K = 2 * Kh.
template <typename E, typename O, bool kLabels>
__global__ void __launch_bounds__(kThreads)
column_gather_kernel(const E* __restrict__ xs, const int* __restrict__ idx,
                     O* __restrict__ out, const Layout L) {
  const int n = blockIdx.x / L.blocks;
  const int s = (blockIdx.x - n * L.blocks) * kThreads + threadIdx.x;
  if (s >= L.groups * L.K) return;
  int k, t0, dt;
  if (L.t_inner) {  // s = k * groups + t0; frames t0, t0 + groups, ...
    k = s / L.groups;
    t0 = s - k * L.groups;
    dt = L.groups;
  } else {  // s = g * K + k; frames g*kF .. g*kF + kF - 1
    const int g = s / L.K;
    k = s - g * L.K;
    t0 = g * kF;
    dt = 1;
  }
  int j = k, h = 0;
  if (kLabels) {
    if (L.interleave) {
      h = k & 1;
      j = k >> 1;
    } else {
      h = k >= L.Kh;
      j = k - h * L.Kh;
    }
  }
  long long col;
  bool valid;
  if (kLabels) {
    const int lab = h ? idx[static_cast<long long>(n) * L.Kh + j] : L.blank;
    valid = lab >= 0 && lab < L.V;
    col = static_cast<long long>(j) * L.V + lab;
  } else {
    col = idx[static_cast<long long>(n) * L.K + k];
    valid = col >= 0 && col < L.C;
  }
  const E* src = xs + static_cast<long long>(n) * L.frames * L.C;
  O* dst = out + n * L.s_n + j * L.s_k + h * L.s_h;
  O v[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) {  // every load issued before any store
    const int t = t0 + f * dt;
    v[f] = zero<O>();
    if (valid && t < L.frames) v[f] = convert<O, E>(src[t * L.C + col]);
  }
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    const int t = t0 + f * dt;
    if (t < L.frames) dst[t * L.s_t] = v[f];
  }
}

template <typename E, typename O, bool kLabels>
int launch(const void* xs, const int* idx, void* out, int N, Layout L,
           cudaStream_t s) {
  L.groups = (L.frames + kF - 1) / kF;
  L.blocks = static_cast<int>(
      (static_cast<long long>(L.groups) * L.K + kThreads - 1) / kThreads);
  const long long grid = static_cast<long long>(N) * L.blocks;
  if (grid >= (1LL << 31) || static_cast<long long>(L.groups) * L.K >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  column_gather_kernel<E, O, kLabels>
      <<<static_cast<unsigned int>(grid), kThreads, 0, s>>>(
          static_cast<const E*>(xs), idx, static_cast<O*>(out), L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 float16, 3 bfloat16.  xs (N, T, C),
// cols (N, K) -> out (N, T, K) in xs's dtype.
static int gather_columns(const void* xs, int dtype, const int* cols,
                          void* out, int N, int frames, long long C, int K,
                          cudaStream_t s) {
  Layout L{};
  L.C = C;
  L.s_n = static_cast<long long>(frames) * K;
  L.s_t = K;
  L.s_k = 1;
  L.frames = frames;
  L.K = L.Kh = K;
  switch (dtype) {
    case 0:
      return launch<float, float, false>(xs, cols, out, N, L, s);
    case 1:
      return launch<double, double, false>(xs, cols, out, N, L, s);
    case 2:
      return launch<__half, __half, false>(xs, cols, out, N, L, s);
    case 3:
      return launch<__nv_bfloat16, __nv_bfloat16, false>(xs, cols, out, N, L, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The blank and label channels of xs (N, T, U*V), labels_ext (N, U), into
// out: layout 0 (2, N, T, U) fp32, 1 (2, N, U, T) fp32, 2 the lattice
// (N, T, U, 2) in xs's dtype.
static int gather_blank_label(const void* xs, int dtype,
                              const int* labels_ext, void* out, int N,
                              int frames, int U, int V, int blank, int layout,
                              cudaStream_t s) {
  Layout L{};
  L.C = static_cast<long long>(U) * V;
  L.frames = frames;
  L.K = 2 * U;
  L.Kh = U;
  L.V = V;
  L.blank = blank;
  if (layout == 2) {
    L.s_n = static_cast<long long>(frames) * U * 2;
    L.s_t = 2LL * U;
    L.s_k = 2;
    L.s_h = 1;
    L.interleave = 1;
    switch (dtype) {
      case 0:
        return launch<float, float, true>(xs, labels_ext, out, N, L, s);
      case 1:
        return launch<double, double, true>(xs, labels_ext, out, N, L, s);
      case 2:
        return launch<__half, __half, true>(xs, labels_ext, out, N, L, s);
      case 3:
        return launch<__nv_bfloat16, __nv_bfloat16, true>(xs, labels_ext, out,
                                                          N, L, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (layout != 0 && layout != 1) return static_cast<int>(cudaErrorInvalidValue);
  L.s_n = static_cast<long long>(frames) * U;
  L.s_t = layout ? 1 : U;
  L.s_k = layout ? frames : 1;
  L.s_h = static_cast<long long>(N) * frames * U;
  L.t_inner = layout;
  switch (dtype) {
    case 0:
      return launch<float, float, true>(xs, labels_ext, out, N, L, s);
    case 1:
      return launch<double, float, true>(xs, labels_ext, out, N, L, s);
    case 2:
      return launch<__half, float, true>(xs, labels_ext, out, N, L, s);
    case 3:
      return launch<__nv_bfloat16, float, true>(xs, labels_ext, out, N, L, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One launch from a packed argument block, so that the host's ctypes call
// converts one argument, not eleven:
//   a[0] xs, a[1] dtype, a[2] idx, a[3] out, a[4] N, a[5] frames,
//   a[6] layout, a[7] K (layout 3) or U, a[8] C (layout 3) or V,
//   a[9] blank, a[10] stream.
// Layout 3 is the column gather; 0, 1 and 2 are gather_blank_label's.
extern "C" int rnnt_gather(const long long* a) {
  const void* xs = reinterpret_cast<const void*>(a[0]);
  const int dtype = static_cast<int>(a[1]);
  const int* idx = reinterpret_cast<const int*>(a[2]);
  void* out = reinterpret_cast<void*>(a[3]);
  const int N = static_cast<int>(a[4]);
  const int frames = static_cast<int>(a[5]);
  const int layout = static_cast<int>(a[6]);
  const int K = static_cast<int>(a[7]);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a[10]);
  if (layout == 3) return gather_columns(xs, dtype, idx, out, N, frames, a[8], K, s);
  return gather_blank_label(xs, dtype, idx, out, N, frames, K,
                            static_cast<int>(a[8]), static_cast<int>(a[9]),
                            layout, s);
}

extern "C" const char* rnnt_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
