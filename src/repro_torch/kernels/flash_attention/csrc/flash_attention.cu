// Causal flash attention, forward, for sm_90a (NVIDIA H100).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py, called through
// `flash_attention_fwd`): attention with an online softmax whose running
// max, denominator and output accumulator stay in fp32 and never touch
// device memory, skipping the key tiles that the causal mask hides
// entirely, and dividing by max(l, 1e-30) at the end.
//
// What bounds it on this card.  Causal attention does 2*B*H*S^2*D
// floating-point operations (two products over half the square) on
// 2*B*S*(H + Hkv)*D elements, so at the serving prefill's shape (B=4,
// S=2048, H=9, Hkv=3, D=64) it is bound by operations: ~19 GFLOP against
// ~25 MB, about 20 us at the tensor cores' bf16 peak against 7.5 us of
// HBM traffic.  This first kernel computes on the CUDA cores in fp32
// (67 TFLOP/s peak), so its own ceiling is ~0.3 ms at that shape; moving
// the two products to the tensor cores (mma.sync or wgmma) is later work.
//
// What the design does about it.
//   * One block of 256 threads per (q head, batch row, q tile of 64 rows).
//     The TPU's sequential k grid axis becomes a loop inside the block over
//     the 64-wide key tiles up to the diagonal.  The q tile is the grid's
//     slowest axis, counted from the last tile, so blocks are handed out
//     heaviest first across all heads and batch rows and the light tiles
//     fill the tail.
//   * Q (once per block) and each K/V tile are read from device memory
//     once into shared memory, converted to fp32; Q and K are stored
//     transposed so that each thread reads its 4 rows and 4 columns as two
//     16-byte loads per depth step and does 16 fused multiply-adds for
//     them (a 4 x 4 register tile of the 64 x 64 score tile).
//   * Row max and row sum reduce across the 16 threads that share a row
//     with warp shuffles; the probabilities go through shared memory
//     (transposed) into the P.V product, where each thread owns 4 rows by
//     D/16 output columns of the fp32 accumulator in registers.
//   * GQA without copies: the block reads K/V head `q_head / group` with
//     the strides it is given.  A ragged last tile is masked in the block
//     (rows and keys past S read as zero and are never stored), so any
//     S >= 1 works.
// Inputs fp32 or bf16 (accumulation always fp32), output in the input's
// type.  Head dims 64, 80, 96 and 128 are instantiated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int LD = BQ + 4;     // padded leading dim of the transposed tiles
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 scores each
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

constexpr int smem_floats(int d) { return 2 * d * LD + BK * d + BK * LD; }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int group, long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh, long long vsb,
                 long long vss, long long vsh, float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][LD]   Q transposed
  float* Kt = Qt + D * LD;                       // [D][LD]   K transposed
  float* Vs = Kt + D * LD;                       // [BK][D]
  float* Pt = Vs + BK * D;                       // [BK][LD]  P transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = static_cast<int>(gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, row = q0 + r;
    Qt[d * LD + r] = row < S ? to_f(qb[row * qss + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (S + BK - 1) / BK;
  const int kt_end = causal ? min(n_kt, (q0 + BQ - 1) / BK + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the last tile's Kt/Vs/Pt reads are done (and Qt)
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D, col = k0 + c;
      const bool in = col < S;
      Kt[d * LD + c] = in ? to_f(kb[col * kss + d]) : 0.f;
      Vs[c * D + d] = in ? to_f(vb[col * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LD + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += av[i] * cv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = col < S && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // the 16 threads of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_cur);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[c * LD + ty * 4]);
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = Vs[c * D + tx + 16 * cc];
        acc[0][cc] += p.x * vv;
        acc[1][cc] += p.y * vv;
        acc[2][cc] += p.z * vv;
        acc[3][cc] += p.w * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) put(&orow[tx + 16 * cc], acc[i][cc] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int Hkv, int causal,
                   const long long* st, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  // Above 48 KB of dynamic shared memory needs an opt-in, once per device
  // and instantiation: the call is not free, so it stays off the hot path.
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in[dev] = true;
  }
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, H / Hkv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      1.0f / sqrtf(static_cast<float>(D)), causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int H, int Hkv, int causal,
                     const long long* st, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hkv, causal, st, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, S, H, Hkv, causal, st, stream);
    case 96: return launch<T, 96>(q, k, v, o, B, S, H, Hkv, causal, st, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, Hkv, causal, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,S,H,D], k/v [B,S,Hkv,D] with unit stride in D and the given strides
// (in elements) for B, S and the head; o contiguous [B,S,H,D].
// dtype: 0 float32, 1 bfloat16.  -> cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int Hkv, int D, int dtype,
                                   int causal, long long qsb, long long qss,
                                   long long qsh, long long ksb,
                                   long long kss, long long ksh,
                                   long long vsb, long long vss,
                                   long long vsh, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || (S + BQ - 1) / BQ > 65535 ||
      Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, B, S, H, Hkv, causal, st, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, B, S, H, Hkv, causal, st,
                                   s);
  return cudaErrorInvalidValue;
}
