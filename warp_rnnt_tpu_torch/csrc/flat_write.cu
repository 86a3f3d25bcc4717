// Dense gradient write of the blank/label gather for Hopper (sm_90a):
//
//   d[r, v] = ct0[r] * (v == blank) + ct1[r] * (v == loc[r])
//
// for rows r = (n, t, u) of the (N, T, U*V) output, loc[r] = loc_rows[n, u].
// Where loc == blank (the last lattice row) both terms land on one element
// and add.  Every element is written, so the output needs no zero fill.
//
// Replaces the Pallas TPU kernel `_flat_write_kernel`
// (warp_rnnt_tpu/ops/flat_kernels.py).  The TPU kernel exists to avoid a
// relayout between the tiled 4-D and the packed flat layout; in torch a
// contiguous (N, T, U, V) tensor is the same memory as (N, T, U*V), so one
// kernel serves both backward passes.
//
// What bounds it on this card: bytes.  It reads 8 B per row and writes
// V * sizeof(out) per row: 2.02 GB at N=32, T=150, U=21, V=5000 fp32.
// Design: one block per row, threads striding along the row so neighbouring
// threads store neighbouring addresses; fp32 rows whose length is a multiple
// of 4 are stored as float4 (16 B per thread), other rows and other output
// types element by element.  The arithmetic is the multiply form above, so
// the result is bit-identical to the plain torch version.
//
// Launches on the caller's stream; allocates nothing; returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ double from_float<double>(float x) {
  return static_cast<double>(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float term(float c0, float c1, int v, int blank,
                                      int loc) {
  return c0 * static_cast<float>(v == blank) + c1 * static_cast<float>(v == loc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flat_write_kernel(const float* __restrict__ ct0, const float* __restrict__ ct1,
                  const int* __restrict__ loc_rows, T* __restrict__ out,
                  int frames, int U, int V, int blank) {
  const long long r = blockIdx.x;
  const long long n = r / ((long long)frames * U);
  const int u = static_cast<int>(r % U);
  const float c0 = ct0[r];
  const float c1 = ct1[r];
  const int loc = loc_rows[n * U + u];
  T* row = out + r * V;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    row[v] = from_float<T>(term(c0, c1, v, blank, loc));
  }
}

__global__ void __launch_bounds__(kThreads)
flat_write_kernel_f32x4(const float* __restrict__ ct0,
                        const float* __restrict__ ct1,
                        const int* __restrict__ loc_rows,
                        float4* __restrict__ out, int frames, int U, int V4,
                        int blank) {
  const long long r = blockIdx.x;
  const long long n = r / ((long long)frames * U);
  const int u = static_cast<int>(r % U);
  const float c0 = ct0[r];
  const float c1 = ct1[r];
  const int loc = loc_rows[n * U + u];
  float4* row = out + r * V4;
  for (int q = threadIdx.x; q < V4; q += kThreads) {
    const int v = 4 * q;
    float4 d;
    d.x = term(c0, c1, v, blank, loc);
    d.y = term(c0, c1, v + 1, blank, loc);
    d.z = term(c0, c1, v + 2, blank, loc);
    d.w = term(c0, c1, v + 3, blank, loc);
    row[q] = d;
  }
}

}  // namespace

// out_dtype: 0 float32, 1 float64, 2 float16, 3 bfloat16.
extern "C" int rnnt_flat_grad_write(const float* ct0, const float* ct1,
                                    const int* loc_rows, void* out,
                                    int out_dtype, long long rows, int frames,
                                    int U, int V, int blank, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(rows));
  switch (out_dtype) {
    case 0:
      if (V % 4 == 0) {
        flat_write_kernel_f32x4<<<grid, kThreads, 0, s>>>(
            ct0, ct1, loc_rows, static_cast<float4*>(out), frames, U, V / 4,
            blank);
      } else {
        flat_write_kernel<float><<<grid, kThreads, 0, s>>>(
            ct0, ct1, loc_rows, static_cast<float*>(out), frames, U, V, blank);
      }
      break;
    case 1:
      flat_write_kernel<double><<<grid, kThreads, 0, s>>>(
          ct0, ct1, loc_rows, static_cast<double*>(out), frames, U, V, blank);
      break;
    case 2:
      flat_write_kernel<__half><<<grid, kThreads, 0, s>>>(
          ct0, ct1, loc_rows, static_cast<__half*>(out), frames, U, V, blank);
      break;
    case 3:
      flat_write_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          ct0, ct1, loc_rows, static_cast<__nv_bfloat16*>(out), frames, U, V,
          blank);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rnnt_flat_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
