// Data movement of the compact (packed) RNN-T layout for Hopper (sm_90a).
//
// In the packed layout each sample n's (xn[n], yn[n] + 1) lattice is
// flattened row-major and the samples are concatenated: lattice cell
// (n, t, u) is packed row
//
//   row = mem_pref[n] + t * (yn[n] + 1) + u,   mem_pref = exclusive cumsum of
//                                              xn * (yn + 1)
//
// of the (rows, V) log-probs.  Rows past sum(xn * (yn + 1)) are padding (a
// bucketed buffer): never read, and their gradient is exactly zero.
//
// packed_gather replaces the Pallas TPU kernel `_gather_kernel`
// (warp_rnnt_tpu/ops/packed_kernels.py:130): packed (rows, V) -> blank and
// emit lattices (N, T, U) fp32, 0 at cells with t >= xn or u > yn.
//   What bounds it on this card: latency, and 2 sectors read per packed row
//   (the blank entry and the label entry); its byte bound is microseconds.
//   Design: one thread per (n, t, u) cell computes its own packed row in
//   64-bit arithmetic and reads the two entries in the input dtype.  The
//   TPU kernel's DMA windows and one-hot MXU permutation exist because the
//   TPU has no cheap per-element offsets; a GPU thread has them.
//
// packed_scatter replaces the Pallas TPU kernel `_scatter_kernel`
// (warp_rnnt_tpu/ops/packed_kernels.py:193): (N, T, U) fp32 cotangents ->
// the dense (rows, V) gradient in the output dtype,
//
//   d[row, v] = ct0[n, t, u] * (v == blank) + ct1[n, t, u] * (v == loc[n, u])
//
// (both terms add where loc == blank, the row u == yn), and zero rows past
// sum(xn * (yn + 1)).  Every element is written exactly once, so the output
// needs no zero fill.
//   What bounds it on this card: bytes, the rows * V * sizeof(out) written.
//   Design: one block per (n, t) frame, whose yn + 1 rows are one contiguous
//   span of (yn + 1) * V elements; 16-byte stores on the aligned body of the
//   span, scalar stores on its head and tail (V * sizeof(out) need not be a
//   multiple of 16).  Each 16-byte group takes one integer division to find
//   its row.  Frames past xn exit at once.  A second range of blocks zeroes
//   the pad rows; the first valid-row count they need is read on the device
//   from the last sample's prefix, so the wrapper needs no host sync.  The
//   arithmetic is the multiply form above, as in the plain torch version, so
//   the two agree bit for bit.
//
// Both kernels compute offsets in 64-bit arithmetic and never touch a row at
// or past `rows` (the buffer's row count).  They launch on the caller's
// stream, allocate nothing and return cudaGetLastError() so the caller can
// raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPadBlocks = 1024;  // most blocks that zero pad rows

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(double x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The bits of a float stored as the output type.
template <typename E>
struct Out;
template <>
struct Out<float> {
  using B = unsigned int;
  static __device__ __forceinline__ B bits(float x) { return __float_as_uint(x); }
};
template <>
struct Out<double> {
  using B = unsigned long long;
  static __device__ __forceinline__ B bits(float x) {
    return static_cast<B>(__double_as_longlong(static_cast<double>(x)));
  }
};
template <>
struct Out<__half> {
  using B = unsigned short;
  static __device__ __forceinline__ B bits(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};
template <>
struct Out<__nv_bfloat16> {
  using B = unsigned short;
  static __device__ __forceinline__ B bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float term(float c0, float c1, int v, int blank,
                                      int loc) {
  return c0 * static_cast<float>(v == blank) + c1 * static_cast<float>(v == loc);
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
packed_gather_kernel(const E* __restrict__ xs, const int* __restrict__ loc,
                     const int* __restrict__ xn, const int* __restrict__ yn,
                     const long long* __restrict__ mem_pref,
                     float* __restrict__ blank_out, float* __restrict__ emit_out,
                     long long cells, int frames, int U, int V, int blank,
                     long long rows) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= cells) return;
  const int u = static_cast<int>(i % U);
  const long long nt = i / U;
  const int t = static_cast<int>(nt % frames);
  const int n = static_cast<int>(nt / frames);
  const int ynn = yn[n];
  float b = 0.0f;
  float e = 0.0f;
  if (t < xn[n] && u <= ynn) {
    const long long row = mem_pref[n] + static_cast<long long>(t) * (ynn + 1) + u;
    const int l = loc[static_cast<long long>(n) * U + u];
    if (row < rows && l >= 0 && l < V) {
      const E* r = xs + row * V;
      b = to_float(r[blank]);
      e = to_float(r[l]);
    } else {  // a buffer too short or a label outside [0, V): never silent
      b = e = __int_as_float(0x7fc00000);
    }
  }
  blank_out[i] = b;
  emit_out[i] = e;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
packed_scatter_kernel(const float* __restrict__ ct0,
                      const float* __restrict__ ct1,
                      const int* __restrict__ loc, const int* __restrict__ xn,
                      const int* __restrict__ yn,
                      const long long* __restrict__ mem_pref,
                      typename Out<E>::B* __restrict__ out, int N, int frames,
                      int U, int V, int blank, long long rows,
                      int frame_blocks) {
  using B = typename Out<E>::B;
  constexpr int kVec = 16 / sizeof(B);

  if (static_cast<int>(blockIdx.x) >= frame_blocks) {
    // pad rows [valid, rows): zero, grid-strided over the pad blocks
    const long long valid =
        mem_pref[N - 1] + static_cast<long long>(xn[N - 1]) * (yn[N - 1] + 1);
    const long long begin = (valid < 0 ? 0 : valid) * V;
    const long long end = rows * V;
    const long long step =
        static_cast<long long>(gridDim.x - frame_blocks) * kThreads;
    for (long long j = begin + (blockIdx.x - frame_blocks) * kThreads +
                       threadIdx.x;
         j < end; j += step) {
      out[j] = B(0);
    }
    return;
  }

  const int n = blockIdx.x / frames;
  const int t = blockIdx.x - n * frames;
  if (t >= xn[n]) return;
  const int stride = yn[n] + 1;
  const long long row0 = mem_pref[n] + static_cast<long long>(t) * stride;
  const long long nrows = min(static_cast<long long>(stride), rows - row0);
  if (nrows <= 0) return;
  const long long start = row0 * V;
  const int len = static_cast<int>(nrows * V);
  const long long cell = (static_cast<long long>(n) * frames + t) * U;
  const float* c0 = ct0 + cell;
  const float* c1 = ct1 + cell;
  const int* lc = loc + static_cast<long long>(n) * U;
  B* dst = out + start;

  const int head = min(len, static_cast<int>((kVec - start % kVec) % kVec));
  const int nvec = (len - head) / kVec;
  const int tail = head + nvec * kVec;
  for (int j = threadIdx.x; j < len - nvec * kVec; j += kThreads) {
    const int jj = j < head ? j : tail + (j - head);  // head, then tail
    const int u = jj / V;
    const int v = jj - u * V;
    dst[jj] = Out<E>::bits(term(c0[u], c1[u], v, blank, lc[u]));
  }
  for (int q = threadIdx.x; q < nvec; q += kThreads) {
    const int j0 = head + q * kVec;
    int u = j0 / V;
    int v = j0 - u * V;
    alignas(16) B pack[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      pack[k] = Out<E>::bits(term(c0[u], c1[u], v, blank, lc[u]));
      if (++v == V) {
        v = 0;
        ++u;
      }
    }
    *reinterpret_cast<uint4*>(dst + j0) = *reinterpret_cast<const uint4*>(pack);
  }
}

template <typename E>
int launch_gather(const void* xs, const int* loc, const int* xn, const int* yn,
                  const long long* mem_pref, float* blank_out, float* emit_out,
                  int N, int frames, int U, int V, int blank, long long rows,
                  cudaStream_t s) {
  const long long cells = static_cast<long long>(N) * frames * U;
  const dim3 grid(static_cast<unsigned int>((cells + kThreads - 1) / kThreads));
  packed_gather_kernel<E><<<grid, kThreads, 0, s>>>(
      static_cast<const E*>(xs), loc, xn, yn, mem_pref, blank_out, emit_out,
      cells, frames, U, V, blank, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_scatter(const float* ct0, const float* ct1, const int* loc,
                   const int* xn, const int* yn, const long long* mem_pref,
                   void* out, int N, int frames, int U, int V, int blank,
                   long long rows, cudaStream_t s) {
  const int frame_blocks = N * frames;
  const long long per_block = static_cast<long long>(kThreads) * 8;
  const long long want = (rows * V + per_block - 1) / per_block;
  const int pad_blocks = static_cast<int>(want < kPadBlocks ? want : kPadBlocks);
  const dim3 grid(static_cast<unsigned int>(frame_blocks + pad_blocks));
  packed_scatter_kernel<E><<<grid, kThreads, 0, s>>>(
      ct0, ct1, loc, xn, yn, mem_pref,
      static_cast<typename Out<E>::B*>(out), N, frames, U, V, blank, rows,
      frame_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 float16, 3 bfloat16.
extern "C" int rnnt_packed_gather(const void* xs, int dtype, const int* loc,
                                  const int* xn, const int* yn,
                                  const long long* mem_pref, float* blank_out,
                                  float* emit_out, int N, int frames, int U,
                                  int V, int blank, long long rows,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_gather<float>(xs, loc, xn, yn, mem_pref, blank_out,
                                  emit_out, N, frames, U, V, blank, rows, s);
    case 1:
      return launch_gather<double>(xs, loc, xn, yn, mem_pref, blank_out,
                                   emit_out, N, frames, U, V, blank, rows, s);
    case 2:
      return launch_gather<__half>(xs, loc, xn, yn, mem_pref, blank_out,
                                   emit_out, N, frames, U, V, blank, rows, s);
    case 3:
      return launch_gather<__nv_bfloat16>(xs, loc, xn, yn, mem_pref, blank_out,
                                          emit_out, N, frames, U, V, blank,
                                          rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int rnnt_packed_scatter(const float* ct0, const float* ct1,
                                   const int* loc, const int* xn,
                                   const int* yn, const long long* mem_pref,
                                   void* out, int dtype, int N, int frames,
                                   int U, int V, int blank, long long rows,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_scatter<float>(ct0, ct1, loc, xn, yn, mem_pref, out, N,
                                   frames, U, V, blank, rows, s);
    case 1:
      return launch_scatter<double>(ct0, ct1, loc, xn, yn, mem_pref, out, N,
                                    frames, U, V, blank, rows, s);
    case 2:
      return launch_scatter<__half>(ct0, ct1, loc, xn, yn, mem_pref, out, N,
                                    frames, U, V, blank, rows, s);
    case 3:
      return launch_scatter<__nv_bfloat16>(ct0, ct1, loc, xn, yn, mem_pref,
                                           out, N, frames, U, V, blank, rows,
                                           s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rnnt_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
