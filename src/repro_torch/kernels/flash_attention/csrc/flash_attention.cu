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
// HBM traffic.  This kernel (`flash_fwd_kernel`, the SIMT route) computes
// on the CUDA cores in fp32 (67 TFLOP/s peak), so its own ceiling is ~0.3 ms
// at that shape.  It serves float32 inputs (every D) and bf16 at D = 80 and
// 96; bf16 at D = 64 and 128 goes to `flash_fwd_tc_kernel` further down,
// which runs both products on the tensor cores.
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
#include <cuda.h>   // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

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

// ===========================================================================
// Tensor-core route: `flash_fwd_tc_kernel<D>`, bf16 at D = 64 and 128.
//
// Replaces the same Pallas TPU kernel, `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:27), for bf16 inputs: causal
// or full attention with an online softmax whose running max, denominator
// and accumulator stay in fp32 registers, key tiles above the diagonal
// skipped, the result divided by max(l, 1e-30).
//
// What bounds it.  At the serving prefill's shape (B=4, S=2048, 9 query on
// 3 KV heads, D=64) causal attention is 4*B*H*D*S(S+1)/2 = 19.3 GFLOP on
// 25 MB: 19.3 GFLOP over 989 TFLOP/s (bf16, dense) = 19.6 us against 7.5 us
// of HBM traffic, so it is bound by operations, and only the tensor cores
// reach that rate.
//
// What the design does about it.
//   * Both products on the tensor cores with `wgmma` (sm_90a): S = Q K^T
//     with Q and K from shared memory (K-major, 128-byte swizzle), and
//     O += P V with P from registers: the m64nN fp32 accumulator fragment
//     of S is the k16 A-register fragment, so P is rounded to bf16 in
//     place and never touches shared memory.  V is the B operand in
//     MN-major order (the transpose bit), read as TMA left it.
//   * Block = one producer warpgroup (one thread issues every copy) and
//     two consumer warpgroups of 64 query rows each: a 128-row q tile of
//     one (q head, batch row).  `setmaxnreg` hands the producer's registers
//     to the consumers (40 / 232 of the 168 a thread gets at launch).
//   * TMA copies Q once and K/V tiles of 128 keys into a ring of two
//     stages, each guarded by a full/empty mbarrier pair, so the next
//     tile's loads overlap this tile's products.  The tensor maps are 4-D
//     over the model's [B, S, heads, D] layout with the strides the wrapper
//     gives ({D, heads, S, B}, innermost first); GQA is the coordinate
//     h / group, with no copy.  A box is one 64-column (128-byte) panel, so
//     D = 128 is two panels.  TMA's zero fill past S replaces the masked
//     loads of a ragged last tile.
//   * Softmax in the accumulator's registers: log2(e) folded into the scale
//     (one FFMA and one exp2 an element), row max across the four threads
//     of a row (quad shuffles), the row sum kept per thread and reduced
//     once at the end.  Only the diagonal tile and the ragged tile past S
//     are masked, j <= i before the exponent.
//   * The q tile is the grid's slowest axis, counted from the last tile, so
//     the heaviest blocks of every head start first.
//
// Why D = 64 is also bound by the exponentials.  A consumer warpgroup does,
// per 128-key tile, 64 x 128 exponentials on the SM's 16-a-clock MUFU units
// against 2 x (2 x 64 x 128 x 64) tensor-core FLOPs at ~4096 a clock: the
// two take about as long.  Here a warpgroup's softmax and its products run
// one after the other, and only the other warpgroup's work can fill the
// gap; overlapping the softmax of one tile with the next tile's Q K^T
// (FA3's ping-pong between warpgroups, and inside one) and a persistent
// grid are later work.
// ===========================================================================
namespace tc {

constexpr int BQ = 128;        // q rows per block, 64 per consumer warpgroup
constexpr int BK = 128;        // keys per tile
constexpr int STAGES = 2;      // K/V ring depth
constexpr int PANEL = 64;      // bf16 columns in one 128-byte swizzle panel
constexpr int ROW_BYTES = PANEL * 2;
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float NEG_BIG = -1e30f;   // initial running max, finite

template <int D>
struct Layout {
  static constexpr int PANELS = D / PANEL;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // K or V, one stage
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // full[STAGES], empty[STAGES], q; + slack to align the base to 1024 B
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
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

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units).  The tile base must be
// 1024-byte aligned; a k step inside a swizzle panel moves the start by
// 32 bytes and the hardware applies the swizzle to the sum.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue / wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, fp32) = [d +] A (64 x 16) B (16 x 128), A and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n\t}"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, fp32) += A (64 x 16, bf16 in registers) B (16 x N), B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, int S, int H, int group,
                    float scale_log2, int causal) {
  static_assert(D == 64 || D == 128, "the tensor-core route takes D 64, 128");
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::Q_OFF, k_s = base + L::K_OFF,
                 v_s = base + L::V_OFF, bars = base + L::BAR_OFF;
  const uint32_t q_bar = bars + 16 * STAGES;   // full[s] = bars + 8 s,
                                               // empty[s] = full[s] + 8 STAGES

  const int qt = static_cast<int>(gridDim.z - 1 - blockIdx.z);
  const int q0 = qt * BQ;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int n_kt = (S + BK - 1) / BK;
  const int kt_end = causal ? min(n_kt, (q0 + BQ - 1) / BK + 1) : n_kt;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                     // producer + bytes
      mbar_init(bars + 8 * (STAGES + s), 2 * 128);    // every consumer
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p)
        tma_load(q_s + p * BQ * ROW_BYTES, &tm_q, q_bar, p * PANEL, h, q0, b);
      for (int kt = 0; kt < kt_end; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(bars + 8 * (STAGES + s), ((kt / STAGES) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * L::KV_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          const uint32_t off = s * L::KV_BYTES + p * BK * ROW_BYTES;
          tma_load(k_s + off, &tm_k, full, p * PANEL, hk, kt * BK, b);
          tma_load(v_s + off, &tm_v, full, p * PANEL, hk, kt * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32;
    const int row_lo = q0 + cw * 64;              // this warpgroup's first row
    const int row0 = row_lo + warp * 16 + lane / 4;   // rows row0, row0 + 8
    const int colq = 2 * (lane % 4);              // columns colq, colq + 1
                                                  // of every 8-wide block
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

    mbar_wait(q_bar, 0);
    for (int kt = 0; kt < kt_end; ++kt) {
      const int s = kt % STAGES, k0 = kt * BK;
      mbar_wait(bars + 8 * s, (kt / STAGES) & 1);

      // S = Q K^T: 64 x 128 fp32, D / 16 k steps
      float sc[BK / 2];
      wg_fence();
#pragma unroll
      for (int t = 0; t < D / 16; ++t) {
        const uint32_t off = (t * 16 / PANEL) * BQ * ROW_BYTES +
                             (t * 16 % PANEL) * 2;
        const uint32_t koff = s * L::KV_BYTES +
                              (t * 16 / PANEL) * BK * ROW_BYTES +
                              (t * 16 % PANEL) * 2;
        wgmma_ss_n128(sc,
                      desc_sw128(q_s + cw * 64 * ROW_BYTES + off, 16, 1024),
                      desc_sw128(k_s + koff, 16, 1024), t > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);

      // mask (diagonal tile, ragged tile), then the online softmax; element
      // 4j + e is row row0 + 8 (e >> 1), key k0 + 8j + colq + (e & 1)
      if (k0 + BK > S || (causal && k0 + BK - 1 > row_lo)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + colq + (e & 1);
            const int row = row0 + 8 * (e >> 1);
            if (col >= S || (causal && col > row))
              sc[4 * j + e] = -CUDART_INF_F;
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * scale_log2);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * r + e];
            x = exp2f(fmaf(x, scale_log2, -m_new));
            sum += x;
          }
        l[r] = l[r] * alpha[r] + sum;   // this thread's part of the row
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // P as bf16 A fragments: k step t covers S's 8-wide blocks 2t, 2t + 1
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int t = 0; t < BK / 16; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[t][i] = pack_bf16(sc[8 * t + 2 * i], sc[8 * t + 2 * i + 1]);

      // O += P V: V's rows are keys, D contiguous (MN-major), 16 keys a step
      pin(acc);
      wg_fence();
#pragma unroll
      for (int t = 0; t < BK / 16; ++t)
        wgmma_rs(acc, pa[t],
                 desc_sw128(v_s + s * L::KV_BYTES + t * 16 * ROW_BYTES,
                            BK * ROW_BYTES, 1024));
      wg_commit();
      wg_wait_all();
      pin(acc);
      mbar_arrive(bars + 8 * (STAGES + s));
    }

    // epilogue: the row sums across the quad, divide, store rows < S
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float denom = fmaxf(l[r], 1e-30f);
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      __nv_bfloat16* orow =
          o + ((static_cast<long long>(b) * S + row) * H + h) * D + colq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] / denom,
                      acc[4 * j + 2 * r + 1] / denom);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so the library
// needs no -lcuda.  nullptr where the driver does not have it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, S, heads, D] bf16 with strides sb, ss, sh (elements) and unit stride
// in D -> a 4-D map {D, heads, S, B}, box one 64-column panel x 128 rows,
// 128-byte swizzle, zeros past the edges.  A dimension of extent 1 is only
// read at coordinate 0, so its stride is replaced by the packed one.
CUresult encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                    int B, int S, int heads, int D, long long sb,
                    long long ss, long long sh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const long long given[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  cuuint64_t packed = static_cast<cuuint64_t>(D) * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed
                                  : static_cast<cuuint64_t>(given[i]) * 2;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {PANEL, 1, BQ, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// -> 0, a cudaError_t, or minus the CUresult of a tensor map that the
// driver refused.
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, int causal, const long long* st,
           cudaStream_t stream) {
  static_assert(BQ == BK, "one q tile per key tile on the diagonal");
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  CUresult r = encode_map(enc, &mq, q, B, S, H, D, st[0], st[1], st[2]);
  if (r == CUDA_SUCCESS)
    r = encode_map(enc, &mk, k, B, S, Hkv, D, st[3], st[4], st[5]);
  if (r == CUDA_SUCCESS)
    r = encode_map(enc, &mv, v, B, S, Hkv, D, st[6], st[7], st[8]);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  constexpr size_t smem = Layout<D>::BYTES;
  static bool opted_in[64] = {};   // once per device, off the hot path
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in[dev] = true;
  }
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_fwd_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, H, H / Hkv, scale_log2,
      causal);
  return cudaGetLastError();
}

}  // namespace tc

// Dynamic shared memory of the tensor-core kernel at head dim D (64, 128).
extern "C" int flash_attention_tc_smem_bytes(int D) {
  return D == 64 ? tc::Layout<64>::BYTES
                 : D == 128 ? tc::Layout<128>::BYTES : 0;
}

// q [B,S,H,D], k/v [B,S,Hkv,D] with unit stride in D and the given strides
// (in elements) for B, S and the head; o contiguous [B,S,H,D].
// dtype: 0 float32, 1 bfloat16.  route: 0 the SIMT kernel (any dtype, D
// 64/80/96/128), 1 the tensor-core kernel (bfloat16, D 64/128, pointers and
// strides 16-byte aligned); the caller chooses, and a route that does not
// take the input is an error, never a fallback.
// -> cudaGetLastError() after the launch, or minus a CUresult (tensor map).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int Hkv, int D, int dtype,
                                   int causal, int route, long long qsb,
                                   long long qss, long long qsh,
                                   long long ksb, long long kss,
                                   long long ksh, long long vsb,
                                   long long vss, long long vsh,
                                   void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || (S + BQ - 1) / BQ > 65535 ||
      Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return cudaErrorInvalidValue;
    if (D == 64) return tc::launch<64>(q, k, v, o, B, S, H, Hkv, causal, st, s);
    if (D == 128)
      return tc::launch<128>(q, k, v, o, B, S, H, Hkv, causal, st, s);
    return cudaErrorInvalidValue;
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, B, S, H, Hkv, causal, st, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, B, S, H, Hkv, causal, st,
                                   s);
  return cudaErrorInvalidValue;
}
