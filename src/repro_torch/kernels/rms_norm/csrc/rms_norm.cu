// The RMS norm over a tensor's last dim, forward, for sm_90a (NVIDIA H100).
//
// Replaces no TPU kernel.  The reference computes the norm with jnp
// (src/repro/models/layers.py::rms_norm), and XLA fuses it into its
// neighbours under `jax.jit`.  Run eagerly in PyTorch (`ref.rms_norm`) it
// is ~9 ATen launches a norm (the casts, the square, the mean, the add and
// rsqrt, two products, the cast back), each a full float32 pass over
// [rows, d].  One launch here computes, for each row of x,
//
//   r      = rsqrt(sum_c x[c]^2 * f + eps)    (float32)
//   out[c] = T((x[c] * r) * w[c])             (float32, one rounding to T)
//
// with T x's type, f ATen's factor for the mean (rows / (rows d), as
// ATen's mean kernel forms it), each square, sum and product rounded on its
// own (`__fmul_rn`, `__fadd_rn`: no contraction into FMAs) and `rsqrtf`,
// as ATen computes them.  Only the order of the float32 sum of squares
// differs from ATen's reduction.
//
// What bounds it on this card: bytes.  A row reads x once and writes the
// output once, 2 d sizeof(T) bytes, for ~5 instructions a value.  A call of
// the benchmark's mixes moves, in bf16, at phi3-mini-3.8b's width (3,072;
// 7,712 tokens, 65 norms) ~6.16 GB, 1.84 ms at 3.35 TB/s; at mamba2-2.7b's
// (2,560; 7,776 tokens, 65 norms) ~5.18 GB, 1.55 ms; at
// granite-4.0-h-small's (4,096; 7,776 tokens, 81 norms) ~10.3 GB, 3.08 ms.
//
// What the design does about it: each byte of x is read once and each
// byte of the output written once, with enough rows in flight on each SM
// to cover the memory's latency.
//   * A group of G threads (a multiple of 32) normalises one row; a block
//     holds R groups (R G <= 256).  Each thread loads its N values into
//     registers, ITEMS accesses of VT values each, G accesses apart (a
//     warp reads 512 consecutive bytes an access), sums their squares,
//     and after the group's sum writes its N outputs from the registers.
//   * N (8, 16 or 32) follows d: the fewest that keep G within 256 threads
//     (512 above d = 8,192), so a block is small and an SM holds many rows
//     at once: at d 2,560-4,096 in bf16, N = 16 and G = 160-256.  R
//     follows G: rows of d <= 1,024 share a block (R = 256 / G).
//   * The group's sum: a warp shuffle tree, then (G > 32) one float a warp
//     in shared memory, summed in the same order by every thread.
//   * Every access moves 16 bytes (8 bf16 or 4 float32 values) of x, of
//     the weight and of the output: the wrapper hands the kernel a d that
//     is a multiple of them, and a copy of any x or weight whose start or
//     row strides break the 16-byte rule (`kernel.py`).  No model's norm
//     needs the copy.
// Supported: 1 <= d <= MAX_D, d a multiple of 16 bytes' values; x bf16 or
// float32 with unit stride along d and row strides (two levels: [outer,
// inner] rows) of 16-byte multiples; w [d] contiguous and out [rows, d]
// contiguous, of x's type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int MAX_THREADS = 512;    // a block at most (one group of d > 8192)
constexpr int BLOCK = 256;          // threads a block of several rows
constexpr int MAX_VALUES = 32;      // values a thread at most
constexpr int MAX_D = MAX_VALUES * MAX_THREADS;   // 16,384

struct Args {
  const void* x;    // [outer, inner, d] through (s_outer, s_inner)
  const void* w;    // [d], contiguous
  void* out;        // [outer inner, d], contiguous
  long long rows, inner;       // rows = outer * inner
  long long s_outer, s_inner;  // x's row strides, in elements
  int d;
  float eps, factor;
};

__host__ __device__ constexpr int ceil_div(int v, int m) {
  return (v + m - 1) / m;
}

// bf16 is the top half of a float32: the low and high element of a word
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// 16 bytes at p as floats (p aligned to them)
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  v[0] = lo_bf16(r.x); v[1] = hi_bf16(r.x);
  v[2] = lo_bf16(r.y); v[3] = hi_bf16(r.y);
  v[4] = lo_bf16(r.z); v[5] = hi_bf16(r.z);
  v[6] = lo_bf16(r.w); v[7] = hi_bf16(r.w);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// 16 bytes' values to p, rounded to p's type
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// blockDim.x = G threads a row, blockDim.y = R rows a block
template <typename T, int N>
__global__ void __launch_bounds__(MAX_THREADS)
    rms_norm_kernel(const Args a) {
  constexpr int VT = 16 / static_cast<int>(sizeof(T));
  constexpr int ITEMS = N / VT;     // accesses a thread
  static_assert(N % VT == 0, "N a multiple of an access's values");
  __shared__ float part[MAX_THREADS / WARP];
  const int G = blockDim.x;
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = row < a.rows;

  float v[ITEMS][VT];
  float ss = 0.f;
  if (live) {
    const T* __restrict__ x = static_cast<const T*>(a.x) +
                              (row / a.inner) * a.s_outer +
                              (row % a.inner) * a.s_inner;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c0 = (threadIdx.x + k * G) * VT;
      if (c0 >= a.d) break;
      load16(x + c0, v[k]);
#pragma unroll
      for (int i = 0; i < VT; ++i)
        ss = __fadd_rn(ss, __fmul_rn(v[k][i], v[k][i]));
    }
  }
  // the row's sum: a warp's by shuffles, then the group's warps' in order
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  const int warps = G / WARP;
  if (warps > 1) {
    float* gp = part + threadIdx.y * warps;
    if ((threadIdx.x & (WARP - 1)) == 0) gp[threadIdx.x / WARP] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < warps; ++i) ss = __fadd_rn(ss, gp[i]);
  }
  if (!live) return;
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, a.factor), a.eps));

  const T* __restrict__ w = static_cast<const T*>(a.w);
  T* __restrict__ out = static_cast<T*>(a.out) + row * a.d;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int c0 = (threadIdx.x + k * G) * VT;
    if (c0 >= a.d) break;
    float wv[VT], o[VT];
    load16(w + c0, wv);
#pragma unroll
    for (int i = 0; i < VT; ++i) o[i] = __fmul_rn(__fmul_rn(v[k][i], r), wv[i]);
    store16(out + c0, o);
  }
}

template <typename T>
cudaError_t launch(const Args& a, int n, dim3 grid, dim3 block,
                   cudaStream_t s) {
  if (n == 8)
    rms_norm_kernel<T, 8><<<grid, block, 0, s>>>(a);
  else if (n == 16)
    rms_norm_kernel<T, 16><<<grid, block, 0, s>>>(a);
  else
    rms_norm_kernel<T, 32><<<grid, block, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x [outer, inner, d] read through the row strides (s_outer, s_inner) in
// elements, unit stride along d; w [d] and out [outer inner, d]
// contiguous; all three bf16 when `bf16`, else float32.  d is a multiple
// of 16 bytes' values, and x's start and row strides (of dims longer than
// 1) and w's start are multiples of 16 bytes (the wrapper sees to it).
// -> 0 without a launch for no rows, cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int rms_norm_fwd(const void* x, const void* w, void* out,
                            int bf16, long long outer, long long inner,
                            long long s_outer, long long s_inner, int d,
                            float eps, void* stream) {
  const int vt = bf16 ? 8 : 4;
  if (outer < 0 || inner < 0 || d < 1 || d > MAX_D || d % vt)
    return cudaErrorInvalidValue;
  const long long rows = outer * inner;
  if (rows == 0) return cudaSuccess;
  // values a thread: the fewest that keep a row's group within BLOCK
  // threads (MAX_THREADS above d = 8,192)
  const int n = d <= 8 * BLOCK ? 8 : d <= 16 * BLOCK ? 16 : MAX_VALUES;
  const int group = ceil_div(ceil_div(d / vt, n / vt), WARP) * WARP;
  const int per_block = group >= BLOCK ? 1 : BLOCK / group;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // ATen's mean: the float sum times rows / (rows d), formed in float
  const float factor =
      static_cast<float>(rows) / static_cast<float>(rows * d);
  Args a{x, w, out, rows, inner, s_outer, s_inner, d, eps, factor};
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(group, per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, n, grid, block, s)
              : launch<float>(a, n, grid, block, s);
}
