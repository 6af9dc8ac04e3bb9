// Mamba2's causal depthwise conv chain, forward, for sm_90a (NVIDIA H100).
//
// Replaces no TPU kernel.  The reference leaves this chain to XLA under
// `jax.jit` (src/repro/models/ssm.py::mamba2_forward: the split of
// in_proj's output, the concat of x, B and C, the causal conv with its bias
// and SiLU, the cast to float32, and dt's softplus), where it is fused.
// Run eagerly in PyTorch it is ~21 ATen launches a layer, each a full pass
// over [B, T, C] or a copy of it.  One launch here computes
//
//   out[b, t, c] = silu(bias[c] + sum_{j<K} w[j, c] xbc[b, t - K + 1 + j, c])
//   dt[b, t, h]  = softplus(dtr[b, t, h] + dt_bias[h])
//
// in float32, reading xbc (the C columns of zxbcdt from d_inner on) and dtr
// (the H columns after them) in place, with xbc[b, t < 0, :] = 0.
//
// What bounds it on this card: bytes.  At mamba2-2.7b's layer (C = 5,376,
// H = 80, bf16 in, float32 out) a token reads 2 (5,376 + 80) B and writes
// 4 (5,376 + 80) B, 32.7 KB, for K = 4 multiply-adds and one exp a channel:
// ~0.3 operations a byte, far below the ridge.  A call of the benchmark's
// code-4k mix (7,776 tokens on average, 64 layers) moves ~16.3 GB: 4.9 ms
// at 3.35 TB/s.
//
// What the design does about it: each input byte is read once and each
// output byte written once; every intermediate stays in registers.
//   * A thread owns CH = 4 consecutive channels of one batch row and walks a
//     tile of TILE = 32 time steps: one 8-byte load a row for bf16 (16 for
//     float32) and one 16-byte store, neighbouring threads on neighbouring
//     channels, so a warp reads 256 and writes 512 contiguous bytes of a
//     row.  UNROLL rows are loaded before any is used, and a whole tile is
//     unrolled, so loads can be issued ahead of the arithmetic.
//   * The K - 1 previous rows stay in registers: each row is read once a
//     tile, plus a halo of K - 1 rows a tile (3 of 32).  A tile never
//     crosses a batch row, and the history before t = 0 is zero.
//   * The tap weights and bias of its channels sit in registers as float32;
//     the products accumulate in float32 FMAs, then the bias and SiLU
//     (`__expf`, `__fdividef`).
//   * dt's H columns go to the launch's last blocks, DT_PER_THREAD (row,
//     head) elements a thread.
//   * The last group of a channel count that is not a multiple of CH, and
//     every group where the wrapper finds the addresses unfit for vector
//     accesses (`vec` = 0: a row stride that is not a multiple of 16
//     bytes, as at the reduced models' H = 2), take scalar loads and
//     stores.
//   * Occupancy sets the pace: 64 registers a thread, 8 blocks of 128 an
//     SM.  Measured on the H100 (mamba2's layer at [4, 2048]), 8 channels
//     a thread (16-byte loads, 99-137 registers), 4 or 8 rows loaded ahead,
//     a second row buffer, tiles of 16, 64 or 128 steps, 256 threads a
//     block, streaming stores and a register cap (spills) were all as fast
//     or slower: 0.117 ms is ~68% of the bytes' bound, where a float32 copy
//     of the same bytes reaches ~91%.
// Supported: K = 4 (every configuration's d_conv); bf16 or float32 inputs
// (all of one type); float32 outputs, contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int K = 4;              // conv taps
constexpr int CH = 4;             // channels a thread owns
constexpr int TILE = 32;          // time steps a thread walks
constexpr int UNROLL = 2;         // rows loaded before any is used
constexpr int DT_PER_THREAD = 4;  // dt elements a thread

struct Args {
  const void* x;        // xbc[0, 0, 0]: zxbcdt at column d_inner
  const void* dtr;      // dtr[0, 0, 0]: zxbcdt at column 2 d_inner + 2 G N
  const void* w;        // [K, C], contiguous
  const void* bias;     // [C]
  const void* dt_bias;  // [H]
  float* out;           // [B, T, C], contiguous
  float* dt;            // [B, T, H], contiguous
  int T, C, H, groups, tiles;
  long long sb, st;     // zxbcdt's batch and time strides, in elements
  long long conv_threads, dt_elems;
  int conv_blocks;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// bf16 is the top half of a float32: the low and high element of a word
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The CH channels of one row at p, of which n exist (n < CH only in the
// last group); zeros for the rest.
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int n,
                                         float (&v)[CH]) {
  static_assert(CH == 4, "a vector access is 4 channels");
  if (VEC && n == CH) {
    if constexpr (sizeof(T) == 2) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = lo_bf16(r.x); v[1] = hi_bf16(r.x);
      v[2] = lo_bf16(r.y); v[3] = hi_bf16(r.y);
    } else {
      const float4 r = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CH; ++i) v[i] = i < n ? to_float(p[i]) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ p, int n,
                                          const float (&v)[CH]) {
  if (VEC && n == CH) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if (i < n) p[i] = v[i];
  }
}

// Rows [t, min(t + UNROLL, t1)): load them all, then compute, store and
// shift each into the history.
template <typename T, bool VEC>
__device__ __forceinline__ void conv_rows(
    const T* __restrict__ x, float* __restrict__ out, long long st, int C,
    int n, int t, int t1, const float (&wk)[K][CH], const float (&bk)[CH],
    float (&hist)[K - 1][CH]) {
  float rows[UNROLL][CH];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (t + u < t1) {
      load_row<T, VEC>(x + (t + u) * st, n, rows[u]);
    } else {
#pragma unroll
      for (int i = 0; i < CH; ++i) rows[u][i] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (t + u < t1) {
      float y[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        float acc = wk[0][i] * hist[0][i];
#pragma unroll
        for (int j = 1; j < K - 1; ++j) acc = fmaf(wk[j][i], hist[j][i], acc);
        acc = fmaf(wk[K - 1][i], rows[u][i], acc) + bk[i];
        y[i] = __fdividef(acc, 1.f + __expf(-acc));
      }
      store_row<VEC>(out + static_cast<long long>(t + u) * C, n, y);
    }
#pragma unroll
    for (int j = 0; j < K - 2; ++j)
#pragma unroll
      for (int i = 0; i < CH; ++i) hist[j][i] = hist[j + 1][i];
#pragma unroll
    for (int i = 0; i < CH; ++i) hist[K - 2][i] = rows[u][i];
  }
}

// Thread `idx` of the conv: channel group fastest, then time tile, then
// batch row.
template <typename T, bool VEC>
__device__ __forceinline__ void conv_part(const Args& a, long long idx) {
  const int g = static_cast<int>(idx % a.groups);
  const long long rest = idx / a.groups;
  const int tile = static_cast<int>(rest % a.tiles);
  const long long b = rest / a.tiles;
  const int c0 = g * CH;
  const int n = min(CH, a.C - c0);

  const T* __restrict__ w = static_cast<const T*>(a.w) + c0;
  const T* __restrict__ bias = static_cast<const T*>(a.bias) + c0;
  float wk[K][CH], bk[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      wk[j][i] = i < n ? to_float(w[static_cast<long long>(j) * a.C + i])
                       : 0.f;
    bk[i] = i < n ? to_float(bias[i]) : 0.f;
  }

  const T* __restrict__ x = static_cast<const T*>(a.x) + b * a.sb + c0;
  float* __restrict__ out = a.out + b * a.T * a.C + c0;
  const int t0 = tile * TILE;
  const int t1 = min(t0 + TILE, a.T);

  float hist[K - 1][CH];  // rows t - K + 1 .. t - 1, oldest first
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int t = t0 - (K - 1) + j;
    if (t >= 0) {
      load_row<T, VEC>(x + t * a.st, n, hist[j]);
    } else {
#pragma unroll
      for (int i = 0; i < CH; ++i) hist[j][i] = 0.f;
    }
  }

  // a whole tile unrolled, so later rows' loads can be issued early
  if (t1 - t0 == TILE) {
#pragma unroll
    for (int t = t0; t < t0 + TILE; t += UNROLL)
      conv_rows<T, VEC>(x, out, a.st, a.C, n, t, t0 + TILE, wk, bk, hist);
  } else {
    for (int t = t0; t < t1; t += UNROLL)
      conv_rows<T, VEC>(x, out, a.st, a.C, n, t, t1, wk, bk, hist);
  }
}

// Block `blk` of dt's part: DT_PER_THREAD elements (row-major over [B, T,
// H]) a thread, THREADS apart.
template <typename T>
__device__ __forceinline__ void dt_part(const Args& a, long long blk) {
  const T* __restrict__ dtr = static_cast<const T*>(a.dtr);
  const T* __restrict__ dtb = static_cast<const T*>(a.dt_bias);
  const long long first = blk * THREADS * DT_PER_THREAD + threadIdx.x;
#pragma unroll
  for (int k = 0; k < DT_PER_THREAD; ++k) {
    const long long e = first + static_cast<long long>(k) * THREADS;
    if (e >= a.dt_elems) return;
    const int h = static_cast<int>(e % a.H);
    const long long bt = e / a.H;
    const long long b = bt / a.T, t = bt % a.T;
    const float v = to_float(dtr[b * a.sb + t * a.st + h]) + to_float(dtb[h]);
    // F.softplus's default: beta 1, linear above the threshold 20
    a.dt[e] = v > 20.f ? v : log1pf(expf(v));
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) ssm_conv_kernel(const Args a) {
  if (blockIdx.x < a.conv_blocks) {
    const long long idx =
        static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    if (idx < a.conv_threads) conv_part<T, VEC>(a, idx);
  } else {
    dt_part<T>(a, blockIdx.x - a.conv_blocks);
  }
}

template <typename T>
cudaError_t launch(const Args& a, int vec, unsigned blocks, cudaStream_t s) {
  if (vec)
    ssm_conv_kernel<T, true><<<blocks, THREADS, 0, s>>>(a);
  else
    ssm_conv_kernel<T, false><<<blocks, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: zxbcdt at its column d_inner, dtr: at column 2 d_inner + 2 G N, both
// read through the strides sb, st (elements; unit stride along columns);
// w [4, C], bias [C], dt_bias [H] contiguous, of zxbcdt's type (bf16 when
// `bf16`, else float32); out [B, T, C] and dt [B, T, H] contiguous float32.
// `vec`: x, its strides and out allow 16-byte accesses (the wrapper checks).
// -> cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// what the kernel does not take.
extern "C" int ssm_conv_fwd(const void* x, const void* dtr, const void* w,
                            const void* bias, const void* dt_bias, void* out,
                            void* dt, int bf16, int vec, int B, int T, int C,
                            int H, long long sb, long long st, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || H <= 0) return cudaErrorInvalidValue;
  Args a{x, dtr, w, bias, dt_bias, static_cast<float*>(out),
         static_cast<float*>(dt), T, C, H, (C + CH - 1) / CH,
         (T + TILE - 1) / TILE, sb, st, 0, 0, 0};
  a.conv_threads = static_cast<long long>(B) * a.tiles * a.groups;
  const long long conv_blocks = (a.conv_threads + THREADS - 1) / THREADS;
  a.dt_elems = static_cast<long long>(B) * T * H;
  const long long dt_blocks =
      (a.dt_elems + THREADS * DT_PER_THREAD - 1) / (THREADS * DT_PER_THREAD);
  if (conv_blocks + dt_blocks > INT_MAX) return cudaErrorInvalidValue;
  a.conv_blocks = static_cast<int>(conv_blocks);
  const unsigned blocks = static_cast<unsigned>(conv_blocks + dt_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, vec, blocks, s)
              : launch<float>(a, vec, blocks, s);
}
