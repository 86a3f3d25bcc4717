// Dense gradient write of the blank/label gather for Hopper (sm_90a):
//
//   d[r, v] = ct0[r] * (v == blank) + ct1[r] * (v == loc[r])
//
// for rows r = (n, t, u) of the (N, T, U*V) output, loc[r] = loc_rows[n, u].
// Where loc == blank (the last lattice row) both terms land on one element
// and add.  Every element is written, so the output needs no zero fill, and
// every element is the multiply form above: a non-finite cotangent makes
// its whole row NaN (inf * 0), as in the JAX reference and the plain torch
// version, and the result is bit-identical to the plain version's.
//
// Replaces the Pallas TPU kernel `_flat_write_kernel`
// (warp_rnnt_tpu/ops/flat_kernels.py) and, through `scatter_bwd`, the
// gather experiment's `_scatter_kernel` (scripts/exp_pallas_gather.py).
// The TPU kernel exists to avoid a relayout between the tiled 4-D and the
// packed flat layout; in torch a contiguous (N, T, U, V) tensor is the same
// memory as (N, T, U*V), so one kernel serves both backward passes.
//
// What bounds it on this card: bytes.  It reads 8 B a row (and the label
// rows) and writes V * sizeof(out) a row: 2.02 GB at N=32, T=150, U=21,
// V=5000 fp32; 11.6 GB in 50-column rows at T=1500, U=301, N=128.
//
// Design: the output is one flat span of rows * V elements, tiled by rows.
// A block takes R consecutive rows (`block_rows`: about kSpanBytes of
// output, at least 1 and at most kMaxRows rows, rounded up so that
// R * V * sizeof(out) is a multiple of 16), so a 50-column row costs no
// block of its own and a 5000-column row is one block, as before.  The
// block stages its rows' ct0, ct1 and label in shared memory (12 B a row;
// the cotangents are read at an element stride: 1 for two planes, 2 for the
// channels of the interleaved (N, T, U, 2) cotangent, a row's two then one
// 8-byte load),
// then stores its span as 16-byte vectors indexed in the span, not in the
// row: 4 fp32, 8 fp16/bf16 or 2 fp64 elements a store, neighbouring threads
// on neighbouring vectors.  A vector may straddle rows (V need not be a
// multiple of the vector); each element takes its own row's coefficients.
// Each thread finds its first vector's (row, column) with one 32-bit divide
// and then steps by a fixed (rows, columns) with one carry, so no element
// pays a divide.  Block bases are 64-bit (the N=144 main path's output has
// more than 2^31 elements); offsets inside a span are 32-bit.  Only the
// grid's last block can end off a vector: it stores its last elements one
// by one.  fp16 and bf16 are rounded once from the fp32 sum, as the plain
// version's `.to(out_dtype)` is.
//
// Launches on the caller's stream; allocates nothing; returns
// cudaGetLastError() (or cudaErrorInvalidValue / cudaErrorMisalignedAddress
// for arguments it does not take) so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSpanBytes = 32768;
constexpr int kMaxRows = 1024;

// An output element's bits from the fp32 value, rounded once.
template <typename T>
struct Out;
template <>
struct Out<float> {
  using Bits = unsigned int;
  static __device__ __forceinline__ Bits bits(float x) { return __float_as_uint(x); }
};
template <>
struct Out<double> {
  using Bits = unsigned long long;
  static __device__ __forceinline__ Bits bits(float x) {
    return static_cast<Bits>(__double_as_longlong(static_cast<double>(x)));
  }
};
template <>
struct Out<__half> {
  using Bits = unsigned short;
  static __device__ __forceinline__ Bits bits(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};
template <>
struct Out<__nv_bfloat16> {
  using Bits = unsigned short;
  static __device__ __forceinline__ Bits bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float term(float c0, float c1, int v, int blank,
                                      int loc) {
  return c0 * static_cast<float>(v == blank) + c1 * static_cast<float>(v == loc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flat_write_kernel(const float* __restrict__ ct0, const float* __restrict__ ct1,
                  long long ct_stride, bool ct_pair,
                  const int* __restrict__ loc_rows, T* __restrict__ out,
                  long long rows, int frames, int U, int V, int blank, int R) {
  using Bits = typename Out<T>::Bits;
  constexpr int kSize = static_cast<int>(sizeof(Bits));
  constexpr int W = 16 / kSize;  // elements a 16-byte vector
  constexpr int kPerLane = 8 / kSize;  // elements a 64-bit half of it
  extern __shared__ __align__(16) unsigned char smem[];
  float* s0 = reinterpret_cast<float*>(smem);
  float* s1 = s0 + R;
  int* sl = reinterpret_cast<int*>(s1 + R);

  // stage the block's rows: r = n * frames * U + t * U + u
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int nr = static_cast<int>(min(static_cast<long long>(R), rows - r0));
  const unsigned fu = static_cast<unsigned>(frames) * U;
  const long long n0 = r0 / fu;
  const unsigned rem0 = static_cast<unsigned>(r0 - n0 * fu);
  for (int i = threadIdx.x; i < nr; i += kThreads) {
    const unsigned rem = rem0 + i;
    if (ct_pair) {
      const float2 c = reinterpret_cast<const float2*>(ct0)[r0 + i];
      s0[i] = c.x;
      s1[i] = c.y;
    } else {
      s0[i] = ct0[(r0 + i) * ct_stride];
      s1[i] = ct1[(r0 + i) * ct_stride];
    }
    sl[i] = loc_rows[(n0 + rem / fu) * U + rem % U];
  }
  __syncthreads();

  const unsigned len = static_cast<unsigned>(nr) * V;  // the span's elements
  const unsigned nv = len / W;                          // its whole vectors
  T* span = out + r0 * V;
  // the thread's first vector's (row, column), then a fixed step a vector
  const unsigned first = threadIdx.x * W;
  int row = first / V, col = first % V;
  constexpr unsigned kStride = kThreads * W;
  const int drow = kStride / V, dcol = kStride % V;
  for (unsigned q = threadIdx.x; q < nv; q += kThreads) {
    int rr = row, cc = col;
    float c0 = s0[rr], c1 = s1[rr];
    int loc = sl[rr];
    unsigned long long lane[2] = {0ull, 0ull};
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const unsigned long long b = Out<T>::bits(term(c0, c1, cc, blank, loc));
      lane[j / kPerLane] |= b << (8 * kSize * (j % kPerLane));
      if (++cc == V && j + 1 < W) {  // the vector runs into the next row
        cc = 0;
        ++rr;
        c0 = s0[rr];
        c1 = s1[rr];
        loc = sl[rr];
      }
    }
    reinterpret_cast<uint4*>(span)[q] =
        make_uint4(static_cast<unsigned>(lane[0]), static_cast<unsigned>(lane[0] >> 32),
                   static_cast<unsigned>(lane[1]), static_cast<unsigned>(lane[1] >> 32));
    col += dcol;
    row += drow;
    if (col >= V) {
      col -= V;
      ++row;
    }
  }
  // the grid's last block may end off a vector: its last elements one by one
  Bits* tail = reinterpret_cast<Bits*>(span);
  for (unsigned e = nv * W + threadIdx.x; e < len; e += kThreads) {
    const unsigned rr = e / V;
    tail[e] = Out<T>::bits(term(s0[rr], s1[rr], static_cast<int>(e % V), blank,
                                sl[rr]));
  }
}

int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

int out_size(int out_dtype) {
  switch (out_dtype) {
    case 0: return 4;  // float32
    case 1: return 8;  // float64
    case 2: return 2;  // float16
    case 3: return 2;  // bfloat16
    default: return 0;
  }
}

// Rows a block: about kSpanBytes of output, 1 <= R <= kMaxRows, rounded up
// to a multiple of W / gcd(V, W) so that each block's span starts on 16 B.
int block_rows(int V, int size) {
  const int w = 16 / size;
  const int step = w / gcd(V, w);
  int r = kSpanBytes / size / V;
  r = r < 1 ? 1 : (r > kMaxRows ? kMaxRows : r);
  return (r + step - 1) / step * step;
}

template <typename T>
cudaError_t launch(const float* ct0, const float* ct1, int ct_stride,
                   const int* loc_rows, void* out, long long rows, int frames,
                   int U, int V, int blank, int R, cudaStream_t s) {
  const long long grid = (rows + R - 1) / R;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(R) * 12;
  const bool pair = ct_stride == 2 && ct1 == ct0 + 1 &&
                    reinterpret_cast<uintptr_t>(ct0) % 8 == 0;
  flat_write_kernel<T><<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      ct0, ct1, ct_stride, pair, loc_rows, static_cast<T*>(out), rows, frames,
      U, V, blank, R);
  return cudaGetLastError();
}

}  // namespace

// The rows a block takes for V columns of out_dtype (0 float32, 1 float64,
// 2 float16, 3 bfloat16); -1 for an argument the kernel does not take.
extern "C" int rnnt_flat_write_block_rows(int V, int out_dtype) {
  const int size = out_size(out_dtype);
  if (size == 0 || V < 1) return -1;
  return block_rows(V, size);
}

// out_dtype: 0 float32, 1 float64, 2 float16, 3 bfloat16.  out must start on
// 16 bytes (torch's allocations do).  ct0 and ct1 are read at an element
// stride of ct_stride floats.
extern "C" int rnnt_flat_grad_write(const float* ct0, const float* ct1,
                                    int ct_stride, const int* loc_rows,
                                    void* out, int out_dtype, long long rows,
                                    int frames, int U, int V, int blank,
                                    void* stream) {
  const int R = rnnt_flat_write_block_rows(V, out_dtype);
  if (R < 0 || rows < 1 || frames < 1 || U < 1 || ct_stride < 1 ||
      static_cast<long long>(frames) * U > 0x7fffffffLL ||
      static_cast<long long>(R) * V > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return static_cast<int>(launch<float>(ct0, ct1, ct_stride, loc_rows,
                                            out, rows, frames, U, V, blank, R,
                                            s));
    case 1:
      return static_cast<int>(launch<double>(ct0, ct1, ct_stride, loc_rows,
                                             out, rows, frames, U, V, blank, R,
                                             s));
    case 2:
      return static_cast<int>(launch<__half>(ct0, ct1, ct_stride, loc_rows,
                                             out, rows, frames, U, V, blank, R,
                                             s));
    default:
      return static_cast<int>(launch<__nv_bfloat16>(
          ct0, ct1, ct_stride, loc_rows, out, rows, frames, U, V, blank, R, s));
  }
}

extern "C" const char* rnnt_flat_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
