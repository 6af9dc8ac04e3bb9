// Mamba2's gate chain, forward, for sm_90a (NVIDIA H100).
//
// Replaces no TPU kernel.  The reference leaves this chain to XLA under
// `jax.jit` (src/repro/models/ssm.py::mamba2_forward: the D skip, the cast
// to the compute type, `y * silu(z)` and the RMS norm), where it is fused.
// Run eagerly in PyTorch it is ~14 ATen launches a layer, each a full pass
// over [B, T, d_inner].  One launch here computes, for each token row,
//
//   a[c]   = T(y[c] + xh[c] * D[c / P])                 (float32, rounded)
//   g[c]   = T(silu(z[c]))                              (float32, rounded)
//   v[c]   = T(a[c] * g[c])
//   out[c] = T(v[c] * rsqrt(mean_c v[c]^2 + eps) * w[c])  (float32)
//
// with T the compute type (bf16, or float32 where every rounding is the
// identity): the eager chain's rounding points, each product and sum
// rounded on its own (`__fmul_rn`, `__fadd_rn`: no contraction into FMAs),
// `expf`, an IEEE division and `rsqrtf`, as ATen computes them.  Only the
// order of the float32 sum of squares differs from ATen's reduction.
//
// What bounds it on this card: bytes.  A token reads y and xh (float32)
// and z (the compute type) and writes the output (the compute type) once:
// 12 bytes a channel in bf16, for ~40 instructions (an accurate exp and an
// IEEE division among them).  At mamba2-2.7b's layer (d_inner 5,120) a
// call of the benchmark's code-4k mix (7,776 tokens on average, 64 layers)
// moves ~30.6 GB: 9.1 ms at 3.35 TB/s; at granite-4.0-h-small's (8,192,
// 36 layers) ~27.5 GB, 8.2 ms.  The instructions are not negligible: a
// row's take ~40-50% of an SM's issue slots in the time its bytes take.
//
// What the design does about it: each input byte is read once and each
// output byte written once, and a row's loads run while the row before it
// computes.
//   * Blocks are persistent, one an SM, each walking rows gridDim.x apart.
//     A row's y, xh and z land in one of two shared-memory stages by three
//     bulk copies (`cp.async.bulk`, completing on the stage's mbarrier),
//     issued by one thread a row ahead: the copies hold no registers, so
//     the bytes in flight are set by shared memory, not by the register
//     file, and the threads spend their issue slots on the arithmetic.
//   * A thread owns ITEMS chunks of CH = 8 consecutive channels,
//     blockDim.x chunks apart (ITEMS follows d_inner: the fewest that keep
//     a block within MAX_THREADS).  The head size P is a multiple of CH,
//     so a chunk lies in one head.  The row's gated values stay in its
//     registers between the sum of squares and the scaled write.
//   * The sum of squares: a warp shuffle tree, then one float a warp in
//     shared memory (two sets, by row parity), summed by every thread in
//     the same order.  The barrier in it also frees the row's stage, so
//     the copy of the row two ahead is issued right after it.
//   * There is one path: the wrapper (`kernel.py`) hands over a
//     contiguous copy of any input whose start or row stride is off 16
//     bytes (only the reduced test models' in_proj rows are), so every
//     row is bulk-copied and every out_norm and output access is 16 bytes.
//   * Measured on the H100 (bf16, cold L2): 0.1738 ms at mamba2's layer
//     at [4, 2048], 86.5% of the bytes' bound, and 85-89% at every
//     code-4k shape of both models.  A first design that kept the loads
//     in registers (a block a row, no staging) reached 50-67%: a row's
//     loads and its arithmetic and write took turns.  Two blocks an SM,
//     four stages, or 512 threads a block were within 2% of this.
// Supported: d_inner <= MAX_D_INNER (one stage within the shared memory of
// an SM); P a multiple of CH; bf16 or float32 z, D, w and output (all of
// one type); float32 y and xh.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int CH = 8;               // channels a chunk: 16 bytes of bf16
constexpr int MAX_THREADS = 1024;
constexpr int MAX_ITEMS = 2;        // chunks a thread at most
constexpr int MAX_D_INNER = MAX_ITEMS * MAX_THREADS * CH;   // 16,384
constexpr int MAX_STAGES = 2;
// dynamic shared memory a block may use: the 227 KB of an SM a block may
// opt into, less room for the static barriers and partial sums
constexpr int SMEM_DYN = 232448 - 1024;
constexpr int ALIGN = 128;          // bytes: each array of a stage

struct Args {
  const float* y;     // [B, T, d_inner], channel stride 1
  const float* xh;    // [B, T, d_inner], channel stride 1
  const void* z;      // [B, T, d_inner], channel stride 1
  const void* D;      // [d_inner / P], contiguous
  const void* w;      // [d_inner], contiguous
  void* out;          // [B, T, d_inner], contiguous
  long long rows;     // B T
  int T, di, P, stages;
  int x_off, z_off, stage_bytes;  // byte offsets in a stage, its size
  float eps, inv_n;
  long long y_sb, y_st, x_sb, x_st, z_sb, z_st;  // strides, in elements
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to T and back: the eager chain's cast to the compute type
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16 is the top half of a float32: the low and high element of a word
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// CH values at p, 16-byte aligned (a stage in shared memory, or out_norm)
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[CH]) {
  static_assert(CH == 8, "a chunk is 16 bytes of bf16");
  if constexpr (sizeof(T) == 2) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    v[0] = lo_bf16(r.x); v[1] = hi_bf16(r.x);
    v[2] = lo_bf16(r.y); v[3] = hi_bf16(r.y);
    v[4] = lo_bf16(r.z); v[5] = hi_bf16(r.z);
    v[6] = lo_bf16(r.w); v[7] = hi_bf16(r.w);
  } else {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// CH values to p, 16-byte aligned
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[CH]) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename T>
struct Row {
  const float* y;
  const float* xh;
  const T* z;
};

template <typename T>
__device__ __forceinline__ Row<T> row_at(const Args& a, long long row) {
  const long long b = row / a.T, t = row % a.T;
  return {a.y + b * a.y_sb + t * a.y_st, a.xh + b * a.x_sb + t * a.x_st,
          static_cast<const T*>(a.z) + b * a.z_sb + t * a.z_st};
}

// Thread 0: the three bulk copies of `row` into the stage at `st`.
template <typename T>
__device__ __forceinline__ void issue_row(const Args& a, long long row,
                                          uint32_t st, uint32_t bar) {
  const Row<T> r = row_at<T>(a, row);
  const uint32_t fbytes = a.di * 4, zbytes = a.di * sizeof(T);
  mbar_expect_tx(bar, 2 * fbytes + zbytes);
  bulk_load(st, r.y, fbytes, bar);
  bulk_load(st + a.x_off, r.xh, fbytes, bar);
  bulk_load(st + a.z_off, r.z, zbytes, bar);
}

// The block's sum of `v`, the same float in every thread.
__device__ __forceinline__ float block_sum(float v, float* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, warps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < warps; ++i) s += part[i];
  return s;
}

template <typename T, int ITEMS>
__global__ void __launch_bounds__(MAX_THREADS) ssm_gate_kernel(const Args a) {
  extern __shared__ __align__(ALIGN) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ float part[2][MAX_THREADS / 32];
  const long long first = blockIdx.x, step = gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < a.stages; ++s) {
      const long long row = first + s * step;
      if (row < a.rows)
        issue_row<T>(a, row, smem_u32(smem + s * a.stage_bytes),
                     smem_u32(&full[s]));
    }
  }
  __syncthreads();

  const T* __restrict__ D = static_cast<const T*>(a.D);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  long long j = 0;
  for (long long row = first; row < a.rows; row += step, ++j) {
    const int s = static_cast<int>(j % a.stages);
    unsigned char* base = smem + s * a.stage_bytes;
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>(j / a.stages) & 1);
    const float* sy = reinterpret_cast<const float*>(base);
    const float* sx = reinterpret_cast<const float*>(base + a.x_off);
    const T* sz = reinterpret_cast<const T*>(base + a.z_off);

    float v[ITEMS][CH];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c0 = (threadIdx.x + k * blockDim.x) * CH;
      if (c0 >= a.di) continue;
      float yv[CH], xv[CH], zv[CH];
      load8(sy + c0, yv);
      load8(sx + c0, xv);
      load8(sz + c0, zv);
      const float d = to_float(D[c0 / a.P]);
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float sk = round_to<T>(__fadd_rn(yv[i], __fmul_rn(xv[i], d)));
        const float g = round_to<T>(zv[i] / (1.f + expf(-zv[i])));
        v[k][i] = round_to<T>(__fmul_rn(sk, g));
        ss = __fadd_rn(ss, __fmul_rn(v[k][i], v[k][i]));
      }
    }
    // after this barrier no thread reads the stage again: refill it
    const float total = block_sum(ss, part[j & 1]);
    if (threadIdx.x == 0 && row + a.stages * step < a.rows)
      issue_row<T>(a, row + a.stages * step, smem_u32(base),
                   smem_u32(&full[s]));
    const float r = rsqrtf(__fadd_rn(__fmul_rn(total, a.inv_n), a.eps));

    T* out = static_cast<T*>(a.out) + row * a.di;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int c0 = (threadIdx.x + k * blockDim.x) * CH;
      if (c0 >= a.di) continue;
      float wv[CH], o[CH];
      load8(w + c0, wv);
#pragma unroll
      for (int i = 0; i < CH; ++i)
        o[i] = __fmul_rn(__fmul_rn(v[k][i], r), wv[i]);
      store8(out + c0, o);
    }
  }
}

template <typename T, int ITEMS>
cudaError_t launch_one(const Args& a, int blocks, int threads, int smem,
                       cudaStream_t s) {
  // Above 48 KB of dynamic shared memory needs an opt-in, once per device
  // and instantiation, at the most any launch asks for
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(ssm_gate_kernel<T, ITEMS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_DYN);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in[dev] = true;
  }
  ssm_gate_kernel<T, ITEMS><<<blocks, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int items, int blocks, int threads,
                   int smem, cudaStream_t s) {
  return items == 1 ? launch_one<T, 1>(a, blocks, threads, smem, s)
                    : launch_one<T, 2>(a, blocks, threads, smem, s);
}

}  // namespace

// y, xh: float32 [B, T, d_inner] read through the strides (y_sb, y_st),
// (x_sb, x_st) in elements, unit stride along channels (the SSD kernel's
// output and the conv kernel's first d_inner columns); z [B, T, d_inner]
// through (z_sb, z_st) (in_proj's output); D [d_inner / P], w [d_inner]
// contiguous; out [B, T, d_inner] contiguous.  z, D, w and out are bf16
// when `bf16`, else float32.  Every start and row stride of y, xh, z, w
// and out is a multiple of 16 bytes (the wrapper sees to it), and P a
// multiple of CH.  -> cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int ssm_gate_fwd(const void* y, const void* xh, const void* z,
                            const void* D, const void* w, void* out,
                            int bf16, int B, int T, int di, int P,
                            float eps, long long y_sb, long long y_st,
                            long long x_sb, long long x_st, long long z_sb,
                            long long z_st, void* stream) {
  if (B <= 0 || T <= 0 || di <= 0 || di > MAX_D_INNER || P <= 0 || P % CH ||
      di % P)
    return cudaErrorInvalidValue;
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < 64) sms[dev] = n_sm;
  }
  const int esize = bf16 ? 2 : 4;
  const int chunks = (di + CH - 1) / CH;
  const int items = (chunks + MAX_THREADS - 1) / MAX_THREADS;
  const int threads = round_up((chunks + items - 1) / items, 32);
  // a stage: y and xh (float32) and z, each padded to ALIGN bytes; one
  // block an SM, with two stages where they fit
  const int f_bytes = round_up(di * 4, ALIGN);
  const int stage = 2 * f_bytes + round_up(di * esize, ALIGN);
  const int stages = std::min(MAX_STAGES, SMEM_DYN / stage);
  if (stages < 1) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(B) * T;
  const int blocks = static_cast<int>(std::min<long long>(rows, n_sm));
  Args a{static_cast<const float*>(y), static_cast<const float*>(xh), z, D,
         w, out, rows, T, di, P, stages, f_bytes, 2 * f_bytes, stage, eps,
         1.f / static_cast<float>(di), y_sb, y_st, x_sb, x_st, z_sb, z_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, items, blocks, threads,
                                      stages * stage, s)
              : launch<float>(a, items, blocks, threads, stages * stage, s);
}
