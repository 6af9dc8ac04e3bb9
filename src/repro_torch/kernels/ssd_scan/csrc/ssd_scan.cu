// Mamba2 SSD chunked scan, forward, for sm_90a (NVIDIA H100).
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan/kernel.py, called through `ssd_scan_fwd`).
// Per head h, over chunks of Q steps with cs = the in-chunk cumulative sum
// of dA = dt * a[h] and the fp32 state S [N, P] carried across chunks:
//
//   y  = (C B^T o L o dt) X + (C o exp(cs)) S,  L[i,j] = exp(cs[i]-cs[j]), j <= i
//   S <- S exp(cs[Q-1]) + (B o exp(cs[Q-1]-cs) o dt)^T X
//
// all in fp32; y has no D skip term (the model adds it).
//
// What bounds it on this card.  At mamba2-2.7b's prefill layer (B=4,
// T=2048, H=80, P=64, G=1, N=128, Q=128) the work is ~27 GFLOP (C B^T once
// per (batch, group, chunk), the causal half of the Q x Q products) against
// ~0.35 GB of fp32 x and y: 0.40 ms at the 67 TFLOP/s fp32 peak outside the
// tensor cores against 0.10 ms of HBM traffic, so operations.  This first
// kernel computes on the CUDA cores in fp32; TF32 `wgmma` tiles would move
// the bound to bytes and are later work, as is sharing C B^T across the
// heads of a group (here each block forms it again).
//
// What the design does about it.
//   * The TPU's sequential chunk grid axis becomes a loop inside the block:
//     one block of 256 threads owns one (column slab of P, head, batch row)
//     and walks the chunks in order with its [N, PS] slice of the state in
//     shared memory.  Columns of P are independent (y[:, p] needs only
//     x[:, p] and S[:, p]), so P = 64 is split exactly into two slabs of
//     PS = 32: twice the blocks (640 at the prefill shape, ~5 per SM) and
//     half the state and x tiles.
//   * Every product's output is cut into 4 x 4 micro-tiles, one per thread
//     (at most 256 for Q, N <= 128 and PS <= 32); C and B sit transposed in
//     shared memory, so each depth step is two 16-byte loads for 16 fused
//     multiply-adds.  The Q x Q weights are never held whole: they are
//     formed 32 keys at a time into a [32, Q] tile, masked and scaled, and
//     applied to X before the next 32; row groups that lie wholly above a
//     key tile skip it.  At Q = N = 128 the block uses 183 KB of dynamic
//     shared memory (opt-in done once per device and size).
//   * Groups without copies: B and C of group h / (H / G) are read from the
//     model's [B, T, G, N] tensors through the strides given, and x from
//     the strided [B, T, H, P] view; dA = dt * a[h] is formed in the block,
//     so neither B/C repeated to H heads nor dA is ever materialised.
//   * The j <= i mask is applied before the exp, so exp never sees a large
//     positive difference (inf * 0 would give NaN).  The cumulative sum runs
//     in double precision in one thread (Q additions a chunk), so the
//     exponents cs[i] - cs[j] keep float32's relative accuracy where |cs|
//     reaches ~1e3 (the model's A goes down to -16): formed in float32, as
//     the plain version forms them, they lose up to ~1e-4 absolute, which
//     puts outputs of unit-scale inputs past 2e-4 of the float64 result.
// Supported: P in {8, 16, 32, 64}, N in {16, 32, 64, 128}, Q in {16, 32,
// 64, 128}, T a multiple of Q; fp32 in and out.
//
// This kernel is route "simt".  Route "tc" (the `tc` namespace further
// down) computes the same function on the tensor cores, chunk-parallel.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SLAB = 32;   // columns of P per block
constexpr int MAX_KT = 32;     // keys per tile of the Q x Q weights

struct Args {
  const float* x;
  const float* dt;
  const float* a;
  const float* bm;
  const float* cm;
  float* y;
  int T, H, G, P, N, Q, PS, KT;
  long long sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, sbg, scb, sct, scg, sa;
};

__host__ __device__ constexpr int ld_of(int q) { return q + 4; }

__host__ __device__ constexpr int smem_floats(int q, int n, int ps, int kt) {
  return 2 * q + 2 * n * ld_of(q) + q * ps + n * ps + kt * ld_of(q) + 3 * q;
}

__global__ void __launch_bounds__(THREADS) ssd_fwd_kernel(const Args A) {
  extern __shared__ float4 smem4[];
  const int Q = A.Q, N = A.N, PS = A.PS, KT = A.KT, LD = ld_of(A.Q);
  double* cs = reinterpret_cast<double*>(smem4); // [Q] cumulative dA
  float* Ct = reinterpret_cast<float*>(cs + Q);  // [N][LD]  C transposed
  float* Bt = Ct + N * LD;                       // [N][LD]  B transposed
  float* Xs = Bt + N * LD;                       // [Q][PS]
  float* Ss = Xs + Q * PS;                       // [N][PS]  the state
  float* Wt = Ss + N * PS;                       // [KT][LD] weights, transposed
  float* dtv = Wt + KT * LD;                     // [Q] dt
  float* win = dtv + Q;                          // [Q] exp(cs)
  float* wout = win + Q;                         // [Q] exp(cs[Q-1]-cs) dt

  const int tid = threadIdx.x;
  const int n_slab = A.P / PS;
  const int h = blockIdx.x / n_slab, slab = blockIdx.x % n_slab;
  const int b = blockIdx.y, g = h / (A.H / A.G);
  const int p_base = slab * PS;
  const float a_h = A.a[h * A.sa];
  const float* xb = A.x + b * A.sxb + h * A.sxh + p_base;
  const float* dtb = A.dt + b * A.sdb + h * A.sdh;
  const float* bb = A.bm + b * A.sbb + g * A.sbg;
  const float* cb = A.cm + b * A.scb + g * A.scg;
  const long long y_row = static_cast<long long>(A.H) * A.P;
  float* yb = A.y + static_cast<long long>(b) * A.T * y_row +
              static_cast<long long>(h) * A.P + p_base;

  // micro-tiles: y [Q][PS] and S [N][PS] by (row group, column group), the
  // weights [Q][KT] by (row group, key group)
  const int cgs = PS / 4, kgs = KT / 4;
  const bool y_on = tid < (Q / 4) * cgs;
  const bool s_on = tid < (N / 4) * cgs;
  const bool w_on = tid < (Q / 4) * kgs;
  const int r0 = (tid / cgs) * 4, p0 = (tid % cgs) * 4;   // y rows / S rows
  const int wi0 = (tid / kgs) * 4, wj0 = (tid % kgs) * 4;

  for (int e = tid; e < N * PS; e += THREADS) Ss[e] = 0.f;

  const int n_chunks = A.T / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const long long t0 = static_cast<long long>(c) * Q;
    __syncthreads();   // the last chunk's reads of every tile are done
    for (int e = tid; e < Q * N; e += THREADS) {
      const int j = e / N, n = e % N;
      Ct[n * LD + j] = cb[(t0 + j) * A.sct + n];
      Bt[n * LD + j] = bb[(t0 + j) * A.sbt + n];
    }
    for (int e = tid; e < Q * PS; e += THREADS) {
      const int j = e / PS, p = e % PS;
      Xs[j * PS + p] = xb[(t0 + j) * A.sxt + p];
    }
    if (tid < Q) dtv[tid] = dtb[(t0 + tid) * A.sdt];
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int j = 0; j < Q; ++j) {
        s += static_cast<double>(dtv[j]) * a_h;
        cs[j] = s;
      }
    }
    __syncthreads();
    if (tid < Q) {
      win[tid] = expf(static_cast<float>(cs[tid]));
      wout[tid] = expf(static_cast<float>(cs[Q - 1] - cs[tid])) * dtv[tid];
    }

    // intra-chunk: y = (C B^T o L o dt) X, 32 keys at a time
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[i][p] = 0.f;
    for (int jb = 0; jb < Q; jb += KT) {
      if (w_on) {
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        if (wi0 + 3 >= jb + wj0) {   // some j <= i in this micro-tile
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            const float4 cv =
                *reinterpret_cast<const float4*>(&Ct[n * LD + wi0]);
            const float4 bv =
                *reinterpret_cast<const float4*>(&Bt[n * LD + jb + wj0]);
            const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
            const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) s[i][j] += ca[i] * ba[j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int ii = wi0 + i, jj = jb + wj0 + j;
              const float d = static_cast<float>(cs[ii] - cs[jj]);
              s[i][j] = jj <= ii ? s[i][j] * dtv[jj] * expf(d) : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(&Wt[(wj0 + j) * LD + wi0]) =
              make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      }
      __syncthreads();
      if (y_on && r0 + 3 >= jb) {   // rows above the tile see only zeros
        const int kt_end = min(KT, r0 + 4 - jb);
        for (int k = 0; k < kt_end; ++k) {
          const float4 wv = *reinterpret_cast<const float4*>(&Wt[k * LD + r0]);
          const float4 xv =
              *reinterpret_cast<const float4*>(&Xs[(jb + k) * PS + p0]);
          const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int p = 0; p < 4; ++p) acc[i][p] += wa[i] * xa[p];
        }
      }
      __syncthreads();   // Wt is rewritten by the next key tile
    }

    // inter-chunk: y += (C o exp(cs)) S with the state before this chunk
    if (y_on) {
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < 4; ++p) o[i][p] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&Ct[n * LD + r0]);
        const float4 sv = *reinterpret_cast<const float4*>(&Ss[n * PS + p0]);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int p = 0; p < 4; ++p) o[i][p] += ca[i] * sa[p];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = win[r0 + i];
        *reinterpret_cast<float4*>(&yb[(t0 + r0 + i) * y_row + p0]) =
            make_float4(acc[i][0] + o[i][0] * e, acc[i][1] + o[i][1] * e,
                        acc[i][2] + o[i][2] * e, acc[i][3] + o[i][3] * e);
      }
    }
    __syncthreads();   // every read of the old state is done

    // state: S <- S exp(cs[Q-1]) + (B o wout)^T X, each thread its own tile
    if (s_on) {
      float u[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int p = 0; p < 4; ++p) u[k][p] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float w = wout[j];
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[j * PS + p0]);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float bw = Bt[(r0 + k) * LD + j] * w;
#pragma unroll
          for (int p = 0; p < 4; ++p) u[k][p] += bw * xa[p];
        }
      }
      const float dec = expf(static_cast<float>(cs[Q - 1]));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float4* sp = reinterpret_cast<float4*>(&Ss[(r0 + k) * PS + p0]);
        const float4 sv = *sp;
        *sp = make_float4(sv.x * dec + u[k][0], sv.y * dec + u[k][1],
                          sv.z * dec + u[k][2], sv.w * dec + u[k][3]);
      }
    }
  }
}

bool supported(int v, int lo, int hi) {   // a power of two in [lo, hi]
  return v >= lo && v <= hi && (v & (v - 1)) == 0;
}

}  // namespace

// x [B,T,H,P], B/C [B,T,G,N] with unit stride in P and N, dt [B,T,H], a [H],
// all float32, with the given strides (in elements) for the other axes;
// y contiguous [B,T,H,P].  -> cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, void* y, int B,
                            int T, int H, int G, int P, int N, int Q,
                            long long sxb, long long sxt, long long sxh,
                            long long sdb, long long sdt, long long sdh,
                            long long sbb, long long sbt, long long sbg,
                            long long scb, long long sct, long long scg,
                            long long sa, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || G <= 0 || H <= 0 || H % G != 0 ||
      !supported(P, 8, 64) || !supported(N, 16, 128) ||
      !supported(Q, 16, 128) || T % Q != 0)
    return cudaErrorInvalidValue;
  Args args{static_cast<const float*>(x), static_cast<const float*>(dt),
            static_cast<const float*>(a), static_cast<const float*>(bm),
            static_cast<const float*>(cm), static_cast<float*>(y),
            T, H, G, P, N, Q, P < MAX_SLAB ? P : MAX_SLAB,
            Q < MAX_KT ? Q : MAX_KT,
            sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, sbg, scb, sct, scg, sa};
  const size_t smem = smem_floats(Q, N, args.PS, args.KT) * sizeof(float);
  // Above 48 KB of dynamic shared memory needs an opt-in; it is not free,
  // so it is made once per device for the largest size asked so far.
  static size_t opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(ssd_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in[dev] = smem;
  }
  const dim3 grid(H * (P / args.PS), B);
  ssd_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      args);
  return cudaGetLastError();
}

// ===========================================================================
// Tensor-core route "tc": the same function as `ssd_fwd_kernel`, chunk-
// parallel, for Q in {64, 128}, P in {32, 64}, N in {32, 64, 128}, with x,
// B and C 16-byte aligned (pointers and strides).
//
// Replaces the same Pallas TPU kernel, `_ssd_kernel`
// (src/repro/kernels/ssd_scan/kernel.py:26, called at :77).
//
// What bounds it.  At mamba2-2.7b's prefill layer (B=4, T=2048, H=80,
// P=64, G=1, N=128, Q=128) the products are ~27 GFLOP: 0.40 ms on the CUDA
// cores' float32 peak, but 3 x 27 / 495 TFLOP/s = 0.16 ms as three TF32
// passes on the tensor cores.  The chunk decomposition below moves ~1.2 GB
// (x twice, the [B, nc, H, N, P] chunk states four times, y once): ~0.36 ms
// at 3.35 TB/s, so this route is bound by bytes, the states' most of all.
//
// What the design does about it.  The SSD block decomposition
// (arXiv:2405.21060 sec. 6-7; `ref.py` has each step's plain version), in
// five launches on one stream, every one independent across chunks but
// step 3:
//   0. `ssd_prep_kernel`: cs = the in-chunk cumulative sum of dA = dt a[h]
//      in double precision, as a warp scan (shuffles), -> cs [B, H, T] as
//      float pairs (hi = float(cs), lo = float(cs - hi)) and dt transposed
//      [B, H, T].  Exponents cs[i] - cs[j] are formed from the pairs as
//      (hi_i - hi_j) + (lo_i - lo_j), correct to float32's accuracy in the
//      difference: float32 sums lose ~1e-4 where |cs| reaches ~1e3 (A down
//      to -16), which puts unit-scale outputs past the 2e-4 gate against
//      float64.
//   1. `ssd_cb_kernel`: C B^T once per (batch row, chunk, group, 64-row
//      tile) -> cb [B, nc, G, Q, Q] (4.2 MB at the mamba2 layer, read back
//      from L2 by step 4): no head forms it again.
//   2. `ssd_states_kernel`: each chunk's own state
//      s_c = (B o exp(cs_last - cs) o dt)^T X per (batch row, chunk < nc-1,
//      head) -> st [B, nc-1, H, N, P].
//   3. `ssd_pass_kernel`: S_{c+1} = S_c exp(cs_last, c) + s_c, in place,
//      element-wise over (N, P) per (batch row, head), sequential in c.
//   4. `ssd_out_kernel`: y = (CB o L o dt) X + (C o exp(cs)) S_c per (batch
//      row, chunk, head), written once into y.
// Float32 accuracy on the tensor cores: every product runs as three TF32
// passes, a = hi + lo with hi = tf32(a) rounded to nearest and
// lo = tf32(a - hi), summing lo.hi + hi.lo + hi.hi into fp32 accumulators
// (the lo.lo term, ~2^-22 relative, is dropped).  Plain TF32 keeps ~3
// decimal digits, ~100x the 2e-4 gate on unit-scale inputs.
// Every product is a `wgmma` (m64nNk8, A from registers, B from shared
// memory).  TF32 `wgmma` reads B only K-major, so the products are chosen
// with K contiguous in B: step 1 computes C B^T with B's rows as loaded;
// step 4 computes y^T = X^T W^T + diag-scaled S^T C^T, with W (formed by the
// threads) and C (as loaded) as B, and X^T, S^T split in registers as A.
// Step 2's operands are both time-major (B [t][n], X [t][p]), so it takes
// (B o w)^T as A and builds X^T as B through registers into a swizzled
// panel.  The B operands' split halves go into two 128-byte-swizzled panels
// (hi, lo).
// Copies: every tile moves by `cp.async` (16 bytes a thread) into a ring of
// two stages along the product's K dimension, so the next 32-wide K panel
// lands while this one is split and multiplied.  Blocks are one warpgroup
// with ~70 KB of shared memory at Q = N = 128 (three blocks an SM), on
// grids of (head, chunk, batch row): 5,120 blocks of step 4 at the mamba2
// layer, 1,280 at zamba2's B = 1.
// ===========================================================================
namespace {
namespace tc {

constexpr int WG = 128;         // one warpgroup: steps 1, 2 and 4
constexpr int KP = 32;          // fp32 values in one 128-byte swizzle row
constexpr int PREP_THREADS = 256;
constexpr int PASS_THREADS = 256;

struct Args {
  const float* x;
  const float* dt;
  const float* a;
  const float* bm;
  const float* cm;
  float* y;
  float2* cs;    // [B, H, T] in-chunk cumulative dA: double as hi + lo
  float* dtT;    // [B, H, T] dt
  float* cb;     // [B, nc, G, Q, Q]
  float* st;     // [B, nc - 1, H, N, P]
  int B, T, H, G, nc;
  long long sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, sbg, scb, sct, scg, sa;
};

__host__ __device__ constexpr int round1k(int v) { return (v + 1023) & ~1023; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most one group (the newest) is still in flight.
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Writes of this thread to shared memory (st.shared, cp.async) become
// visible to the tensor cores' asynchronous proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits), half away from zero, with two
// integer operations (finite x): cheaper than cvt.rna.tf32.f32.
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x = hi + lo, both TF32 (low 13 bits zero), hi rounded to nearest.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(x - h));
}

// Byte offset of 16-byte chunk `ch` (0..7) of row `row` in a panel of
// 128-byte rows with the 128-byte swizzle (`wgmma`'s and TMA's): chunk
// position ch ^ (row % 8) inside each 1,024-byte group of 8 rows.
__device__ __forceinline__ uint32_t sw128(int row, int ch) {
  return static_cast<uint32_t>(row * 128 + ((ch ^ (row & 7)) << 4));
}

// wgmma shared-memory descriptor for a K-major operand in 128-byte-swizzled
// panels: start address, leading offset 16 B (unused), 1,024 B between
// 8-row groups.  A k step of 8 TF32 values moves the start by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
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
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x NG, fp32; NG / 2 registers from `d` on) += A (64 x 8, TF32 in
// registers) B (8 x NG, TF32, K-major in shared memory).
template <int NG>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t (&a)[4],
                                           uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n\t}"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float* d, const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %53, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n\t}"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n\t}"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %21, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n\t}"
      : F8(0), F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F8

// Split a whole panel of ROWS 128-byte rows in place: hi = tf32(x) over x,
// lo = tf32(x - hi) into `lo` at the same offsets.
template <int ROWS>
__device__ __forceinline__ void split_panel(float* hi, float* lo) {
  static_assert(ROWS * 8 % WG == 0, "whole passes of the warpgroup");
#pragma unroll
  for (int pass = 0; pass < ROWS * 8 / WG; ++pass) {
    const int e = threadIdx.x + pass * WG;
    float4 v = reinterpret_cast<float4*>(hi)[e];
    const float4 h = make_float4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
    reinterpret_cast<float4*>(hi)[e] = h;
    reinterpret_cast<float4*>(lo)[e] =
        make_float4(tf32(v.x - h.x), tf32(v.y - h.y), tf32(v.z - h.z),
                    tf32(v.w - h.w));
  }
}

// Issue the three-pass product of one 32-deep K panel, asynchronously:
// acc (64 x NG, from `acc` on) += A B, A's fragments (m64k8 per k step:
// rows 16 warp + lane/4 (+8), columns lane%4 (+4)) given split in
// registers, B the hi and lo panels' NG rows from byte addresses `hi` and
// `lo` on.  Neither acc nor the fragments may be touched until
// `product_wait`.
template <int NG>
__device__ __forceinline__ void product_issue(float* acc,
                                              const uint32_t (&ah)[4][4],
                                              const uint32_t (&al)[4][4],
                                              uint32_t hi, uint32_t lo) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t dh = desc_sw128(hi + 32 * ks), dl = desc_sw128(lo + 32 * ks);
    wgmma_tf32<NG>(acc, al[ks], dh);
    wgmma_tf32<NG>(acc, ah[ks], dl);
    wgmma_tf32<NG>(acc, ah[ks], dh);
  }
  wg_commit();
}

// Wait for the products issued; the fragments stay allocated until then
// (the tensor cores read them asynchronously).
template <int N>
__device__ __forceinline__ void product_wait(float (&acc)[N],
                                             uint32_t (&ah)[4][4],
                                             uint32_t (&al)[4][4]) {
  wg_wait_all();
  pin(acc);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      asm volatile("" : "+r"(ah[ks][r]), "+r"(al[ks][r])::"memory");
}

// ---- step 0: cumulative sums --------------------------------------------
// Block = (8 heads, chunk, batch row), one warp a head; dt's tile read
// along heads (the contiguous axis of [B, T, H]), transposed in shared
// memory; each lane sums Q / 32 values in order, then a warp scan of the
// lane totals by shuffles, all in double.
template <int Q>
__global__ void __launch_bounds__(PREP_THREADS) ssd_prep_kernel(const Args A) {
  constexpr int HEADS = PREP_THREADS / 32, PER = Q / 32;
  __shared__ float tile[HEADS][Q + 1];
  const int h0 = blockIdx.x * HEADS, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long t0 = static_cast<long long>(c) * Q;
#pragma unroll
  for (int l = 0; l < HEADS * Q / PREP_THREADS; ++l) {   // all in flight
    const int e = tid + l * PREP_THREADS;
    const int hh = e % HEADS, tt = e / HEADS, h = h0 + hh;
    tile[hh][tt] = h < A.H ? A.dt[b * A.sdb + (t0 + tt) * A.sdt + h * A.sdh]
                           : 0.f;
  }
  __syncthreads();
  const int h = h0 + warp;
  if (h >= A.H) return;
  const double ah = static_cast<double>(A.a[h * A.sa]);
  double v[PER], run = 0.0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    run += static_cast<double>(tile[warp][lane * PER + k]) * ah;
    v[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const double excl = incl - run;
  const long long row = (static_cast<long long>(b) * A.H + h) * A.T + t0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const double d = excl + v[k];
    const float hi = static_cast<float>(d);
    A.cs[row + lane * PER + k] =
        make_float2(hi, static_cast<float>(d - static_cast<double>(hi)));
    A.dtT[row + lane * PER + k] = tile[warp][lane * PER + k];
  }
}

// ---- step 1: C B^T ------------------------------------------------------
// Block = (group x 64-row tile m of C, chunk, batch row), one warpgroup:
// cb[i, j] = sum_n C[i, n] B[j, n] for its 64 rows i and the columns
// j < 64 (m + 1), the only ones step 4 reads (it needs j <= i); the other
// columns of these rows are left unwritten.  K = n in panels of 32: B's
// rows (the K-major B operand) into a swizzled panel, C's rows (A, split
// in registers) into a padded tile.
template <int Q>
struct CbLayout {
  static constexpr int PANEL = Q * 128;
  static constexpr int A_LD = KP + 4;        // conflict-free fragment reads
  static constexpr int STAGE = PANEL + round1k(64 * A_LD * 4);
  static constexpr int LO_OFF = 2 * STAGE;
  static constexpr int BYTES = LO_OFF + PANEL + 1024;
};

template <int Q, int N>
__global__ void __launch_bounds__(WG) ssd_cb_kernel(const Args A) {
  using L = CbLayout<Q>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(base);
  const int tiles = Q / 64;
  const int g = blockIdx.x / tiles, m = blockIdx.x % tiles;
  const int cols = 64 * (m + 1);             // the causal columns j
  const int c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const long long t0 = static_cast<long long>(c) * Q;
  const float* bsrc = A.bm + b * A.sbb + g * A.sbg + t0 * A.sbt;
  const float* csrc = A.cm + b * A.scb + g * A.scg + (t0 + 64 * m) * A.sct;

  auto issue = [&](int u) {
    const uint32_t hi = sb + (u & 1) * L::STAGE, as = hi + L::PANEL;
    for (int e = tid; e < cols * 8; e += WG) {
      const int r = e / 8, ch = e % 8;
      cp16(hi + sw128(r, ch), bsrc + r * A.sbt + KP * u + 4 * ch);
    }
    for (int e = tid; e < 64 * 8; e += WG) {
      const int r = e / 8, ch = e % 8;
      cp16(as + (r * L::A_LD + 4 * ch) * 4, csrc + r * A.sct + KP * u + 4 * ch);
    }
  };

  float acc[Q / 2];
#pragma unroll
  for (int i = 0; i < Q / 2; ++i) acc[i] = 0.f;
  pin(acc);   // zeroed before the first product, whichever width it takes
  issue(0);
  cp_commit();
  constexpr int n_pan = N / KP;
  for (int u = 0; u < n_pan; ++u) {
    if (u + 1 < n_pan) issue(u + 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    float* hi = reinterpret_cast<float*>(base + (u & 1) * L::STAGE);
    const float* as = hi + L::PANEL / 4;
    float* lo = reinterpret_cast<float*>(base + L::LO_OFF);
    if (cols == Q)
      split_panel<Q>(hi, lo);
    else
      split_panel<64>(hi, lo);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * warp + gq + 8 * (r & 1);
        const int k = 8 * ks + tq + 4 * (r >> 1);
        split(as[row * L::A_LD + k], ah[ks][r], al[ks][r]);
      }
    fence_async_smem();
    __syncthreads();
    const uint32_t b_hi = sb + (u & 1) * L::STAGE, b_lo = sb + L::LO_OFF;
    if (cols == Q)
      product_issue<Q>(acc, ah, al, b_hi, b_lo);
    else
      product_issue<64>(acc, ah, al, b_hi, b_lo);
    product_wait(acc, ah, al);
    __syncthreads();
  }
  float* out = A.cb + ((static_cast<long long>(b) * A.nc + c) * A.G + g) *
                          Q * Q + (64 * m) * Q;
#pragma unroll
  for (int r = 0; r < Q / 2; r += 2) {
    const int row = 16 * warp + gq + 8 * ((r >> 1) & 1);
    const int col = 8 * (r >> 2) + 2 * tq;
    if (col < cols)
      *reinterpret_cast<float2*>(&out[row * Q + col]) =
          make_float2(acc[r], acc[r + 1]);
  }
}

// ---- step 2: chunk states -----------------------------------------------
// Block = (head, chunk < nc - 1, batch row), one warpgroup: s [N, P] =
// (B o w)^T X with w = exp(cs_last - cs) dt, K = the chunk's Q positions
// in panels of 32.  Both operands arrive time-major; TF32 `wgmma` takes B
// only K-major, so X's 32 x P panel is transposed by the threads into
// swizzled hi and lo panels [P rows][32 positions] (16 values a thread),
// and (B o w)^T is split in registers as A, read from B's tile as copied,
// one 64-row tile of N at a time.  The accumulators are s in its [N, P]
// layout.  Copies land while the panel before is transformed and
// multiplied, as in step 4.
template <int Q, int N, int P>
struct StLayout {
  static constexpr int B_LD = N + 8;         // conflict-free fragment reads
  static constexpr int X_LD = P + 4;         // conflict-free column reads
  static constexpr int XS = KP * B_LD * 4;   // X's tile, after B's
  static constexpr int STAGE = round1k(XS + KP * X_LD * 4);
  static constexpr int PANEL = P * 128;      // X^T, [P rows][32 positions]
  static constexpr int HI_OFF = 2 * STAGE, LO_OFF = HI_OFF + PANEL;
  static constexpr int W_OFF = LO_OFF + PANEL;
  static constexpr int BYTES = W_OFF + Q * 4 + 1024;
  static constexpr int MT = (N + 63) / 64;   // 64-row tiles of s (N = 32:
                                             // one, half of it zeros)
};

template <int Q, int N, int P>
__global__ void __launch_bounds__(WG) ssd_states_kernel(const Args A) {
  using L = StLayout<Q, N, P>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(base);
  float* w_s = reinterpret_cast<float*>(base + L::W_OFF);
  float* xhi = reinterpret_cast<float*>(base + L::HI_OFF);
  float* xlo = reinterpret_cast<float*>(base + L::LO_OFF);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int g = h / (A.H / A.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const long long t0 = static_cast<long long>(c) * Q;
  const float* bsrc = A.bm + b * A.sbb + g * A.sbg + t0 * A.sbt;
  const float* xsrc = A.x + b * A.sxb + h * A.sxh + t0 * A.sxt;
  {
    const long long row = (static_cast<long long>(b) * A.H + h) * A.T + t0;
    const float2 last = A.cs[row + Q - 1];
    for (int j = tid; j < Q; j += WG) {
      const float2 cj = A.cs[row + j];
      w_s[j] = expf((last.x - cj.x) + (last.y - cj.y)) * A.dtT[row + j];
    }
  }

  auto issue = [&](int u) {
    const uint32_t bs = sb + (u & 1) * L::STAGE, xs = bs + L::XS;
    for (int e = tid; e < KP * (N / 4); e += WG) {
      const int r = e / (N / 4), ch = e % (N / 4);
      cp16(bs + (r * L::B_LD + 4 * ch) * 4, bsrc + (KP * u + r) * A.sbt + 4 * ch);
    }
    for (int e = tid; e < KP * (P / 4); e += WG) {
      const int r = e / (P / 4), ch = e % (P / 4);
      cp16(xs + (r * L::X_LD + 4 * ch) * 4, xsrc + (KP * u + r) * A.sxt + 4 * ch);
    }
  };

  float acc[L::MT][P / 2];
#pragma unroll
  for (int m = 0; m < L::MT; ++m)
#pragma unroll
    for (int i = 0; i < P / 2; ++i) acc[m][i] = 0.f;
  issue(0);
  cp_commit();
  constexpr int n_pan = Q / KP;
  for (int u = 0; u < n_pan; ++u) {
    if (u + 1 < n_pan) issue(u + 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();   // this panel's copies (and w_s) are visible
    const float* bs = reinterpret_cast<const float*>(base + (u & 1) * L::STAGE);
    const float* xs = reinterpret_cast<const float*>(base + (u & 1) * L::STAGE +
                                                     L::XS);
    // X^T: row p, chunk ch holds X[4 ch .. 4 ch + 3][p]
#pragma unroll
    for (int pass = 0; pass < P * 8 / WG; ++pass) {
      const int e = tid + pass * WG, pr = e % P, ch = e / P;
      const float v[4] = {xs[(4 * ch) * L::X_LD + pr],
                          xs[(4 * ch + 1) * L::X_LD + pr],
                          xs[(4 * ch + 2) * L::X_LD + pr],
                          xs[(4 * ch + 3) * L::X_LD + pr]};
      const float4 hv = make_float4(tf32(v[0]), tf32(v[1]), tf32(v[2]),
                                    tf32(v[3]));
      const uint32_t off = sw128(pr, ch);
      *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(xhi) + off) = hv;
      *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(xlo) + off) =
          make_float4(tf32(v[0] - hv.x), tf32(v[1] - hv.y), tf32(v[2] - hv.z),
                      tf32(v[3] - hv.w));
    }
    fence_async_smem();
    __syncthreads();
#pragma unroll
    for (int m = 0; m < L::MT; ++m) {
      // A = (B o w)^T: rows n = 64 m + 16 warp + lane/4 (+8), columns j
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 64 * m + 16 * warp + gq + 8 * (r & 1);
          const int k = 8 * ks + tq + 4 * (r >> 1);
          split(n < N ? bs[k * L::B_LD + n] * w_s[KP * u + k] : 0.f,
                ah[ks][r], al[ks][r]);
        }
      product_issue<P>(acc[m], ah, al, sb + L::HI_OFF, sb + L::LO_OFF);
      product_wait(acc[m], ah, al);
    }
    __syncthreads();   // every read of this stage and of the X^T panels done
  }
  float* out = A.st + ((static_cast<long long>(b) * (A.nc - 1) + c) * A.H + h) *
                          static_cast<long long>(N * P);
#pragma unroll
  for (int m = 0; m < L::MT; ++m)
#pragma unroll
    for (int r = 0; r < P / 2; r += 2) {
      const int n = 64 * m + 16 * warp + gq + 8 * ((r >> 1) & 1);
      const int col = 8 * (r >> 2) + 2 * tq;
      if (n < N)
        *reinterpret_cast<float2*>(&out[n * P + col]) =
            make_float2(acc[m][r], acc[m][r + 1]);
    }
}

// ---- step 3: state passing ----------------------------------------------
// One thread per 4 consecutive (n, p) of one (batch row, head), walking the
// chunks in order: st[c] <- S_{c+1} = S_c exp(cs_last, c) + s_c.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass_kernel(float* st, const float2* cs, int H, int T, int Q, int nc,
                int np4, long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * PASS_THREADS +
                      threadIdx.x;
  if (e >= total) return;
  const int q4 = static_cast<int>(e % np4);
  const long long bh = e / np4;
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  float4* p = reinterpret_cast<float4*>(st) + (b * (nc - 1) * H + h) * np4 + q4;
  const long long step = static_cast<long long>(H) * np4;
  const float2* last = cs + (b * H + h) * T + Q - 1;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc - 1; ++c) {
    const float2 l = last[static_cast<long long>(c) * Q];
    const float d = expf(l.x + l.y);
    const float4 s = p[c * step];
    run = make_float4(fmaf(run.x, d, s.x), fmaf(run.y, d, s.y),
                      fmaf(run.z, d, s.z), fmaf(run.w, d, s.w));
    p[c * step] = run;
  }
}

// ---- step 4: chunk outputs ----------------------------------------------
// Block = (head, chunk, batch row), one warpgroup, y^T [P, Q] in the
// accumulators (rows P padded to the 64 of a wgmma tile; at P = 32 the
// upper half is zeros and never stored).  Panels u < n_off (chunk > 0): the
// off-diagonal part S^T C^T, K = n: C's rows into the swizzled panel, S's
// rows n into the A tile; then the columns are scaled by exp(cs[i]).  Then
// the diagonal part X^T W^T, K = j: the threads form W[i, j] =
// cb[i, j] exp(cs[i] - cs[j]) dt[j] (j <= i, else 0) into the panel, X's
// rows j into the A tile; cb's rows i >= 32 k come through the ring into
// the panel and are turned into W in place, and the product runs on those
// rows only (the columns of y^T that see a j <= i).  Each panel's copies
// land while the one before is transformed and multiplied; copies,
// transform and products of one block run in turn, and the three blocks an
// SM overlap them.  (Overlapping them inside the block, with a lo panel per
// stage, takes 87 KB and two blocks an SM, and measured slower.)
template <int Q, int P>
struct OutLayout {
  static constexpr int PANEL = Q * 128;
  static constexpr int A_LD = P + 8;         // conflict-free fragment reads
  static constexpr int HI = 0, AS = PANEL;   // in a stage
  static constexpr int STAGE = round1k(PANEL + KP * A_LD * 4);
  static constexpr int LO_OFF = 2 * STAGE;
  static constexpr int CS_OFF = LO_OFF + PANEL;    // Q float pairs
  static constexpr int DT_OFF = CS_OFF + Q * 8;    // Q floats
  static constexpr int E_OFF = DT_OFF + Q * 4;     // Q floats
  static constexpr int BYTES = E_OFF + Q * 4 + 1024;
};

template <int Q, int N, int P>
__global__ void __launch_bounds__(WG) ssd_out_kernel(const Args A) {
  using L = OutLayout<Q, P>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(base);
  float2* cs_s = reinterpret_cast<float2*>(base + L::CS_OFF);
  float* dt_s = reinterpret_cast<float*>(base + L::DT_OFF);
  float* e_s = reinterpret_cast<float*>(base + L::E_OFF);
  float* lo = reinterpret_cast<float*>(base + L::LO_OFF);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int g = h / (A.H / A.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const long long t0 = static_cast<long long>(c) * Q;
  {
    const long long row = (static_cast<long long>(b) * A.H + h) * A.T + t0;
    for (int i = tid; i < Q; i += WG) {
      const float2 v = A.cs[row + i];
      cs_s[i] = v;
      dt_s[i] = A.dtT[row + i];
      e_s[i] = expf(v.x + v.y);
    }
  }
  const float* csrc = A.cm + b * A.scb + g * A.scg + t0 * A.sct;
  const float* xsrc = A.x + b * A.sxb + h * A.sxh + t0 * A.sxt;
  const float* ssrc =
      c > 0 ? A.st + ((static_cast<long long>(b) * (A.nc - 1) + c - 1) * A.H +
                      h) * static_cast<long long>(N * P)
            : nullptr;
  const float* cbg = A.cb + ((static_cast<long long>(b) * A.nc + c) * A.G + g) *
                                Q * Q;
  const int n_off = c > 0 ? N / KP : 0;
  const int n_pan = n_off + Q / KP;

  // panel u's copies into stage u % 2: the raw B operand into the hi panel
  // (C, or cb's rows i >= j0), the A source (S's or X's 32 rows) into its
  // tile
  auto issue = [&](int u) {
    const uint32_t hi = sb + (u & 1) * L::STAGE + L::HI, as = hi + L::AS;
    const float* src;
    if (u < n_off) {
      for (int e = tid; e < Q * 8; e += WG) {
        const int r = e / 8, ch = e % 8;
        cp16(hi + sw128(r, ch), csrc + r * A.sct + KP * u + 4 * ch);
      }
      src = ssrc + (KP * u) * P;
      for (int e = tid; e < KP * (P / 4); e += WG) {
        const int r = e / (P / 4), ch = e % (P / 4);
        cp16(as + (r * L::A_LD + 4 * ch) * 4, src + r * P + 4 * ch);
      }
    } else {
      const int j0 = KP * (u - n_off);
      for (int e = tid + j0 * 8; e < Q * 8; e += WG) {
        const int r = e / 8, ch = e % 8;
        cp16(hi + sw128(r, ch), cbg + r * Q + j0 + 4 * ch);
      }
      src = xsrc + j0 * A.sxt;
      for (int e = tid; e < KP * (P / 4); e += WG) {
        const int r = e / (P / 4), ch = e % (P / 4);
        cp16(as + (r * L::A_LD + 4 * ch) * 4, src + r * A.sxt + 4 * ch);
      }
    }
  };

  // panel u's B operand split into hi (in place) and lo: C as copied, or W
  // formed from cb in place, on rows i >= j0; WG = 16 rows x 8 chunks a
  // pass.  The exponent cs[i] - cs[j] = (hi_i - hi_j) + (lo_i - lo_j) of
  // the float pairs carrying the double sums: float32's accuracy in the
  // difference, with no conversion from double
  auto transform = [&](int u) {
    float* hi = reinterpret_cast<float*>(base + (u & 1) * L::STAGE + L::HI);
    if (u < n_off) {
      split_panel<Q>(hi, lo);
      return;
    }
    const int j0 = KP * (u - n_off);
#pragma unroll 2
    for (int pass = j0 / 16; pass < Q / 16; ++pass) {
      const int e = tid + pass * WG;
      const int i = e / 8, ch = e % 8, j = j0 + 4 * ch;
      const uint32_t off = sw128(i, ch);
      float4* hp = reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(hi) +
                                             off);
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      if (j <= i) {
        const float4 v = *hp;   // cb[i, j .. j + 3], as copied
        const float cv[4] = {v.x, v.y, v.z, v.w};
        const float2 ci = cs_s[i];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 cj = cs_s[j + q];
          if (j + q <= i)
            w[q] = cv[q] * expf((ci.x - cj.x) + (ci.y - cj.y)) * dt_s[j + q];
        }
      }
      const float4 hv = make_float4(tf32(w[0]), tf32(w[1]), tf32(w[2]),
                                    tf32(w[3]));
      *hp = hv;
      *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(lo) + off) =
          make_float4(tf32(w[0] - hv.x), tf32(w[1] - hv.y), tf32(w[2] - hv.z),
                      tf32(w[3] - hv.w));
    }
  };

  float acc[Q / 2];
#pragma unroll
  for (int i = 0; i < Q / 2; ++i) acc[i] = 0.f;
  issue(0);
  cp_commit();
  for (int u = 0; u < n_pan; ++u) {
    if (u + 1 < n_pan) issue(u + 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();   // panel u's copies (and cs_s, dt_s, e_s) visible
    transform(u);
    const float* as =
        reinterpret_cast<const float*>(base + (u & 1) * L::STAGE + L::AS);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = 16 * warp + gq + 8 * (r & 1);
        const int k = 8 * ks + tq + 4 * (r >> 1);
        split(p < P ? as[k * L::A_LD + p] : 0.f, ah[ks][r], al[ks][r]);
      }
    fence_async_smem();
    __syncthreads();
    const uint32_t hi = sb + (u & 1) * L::STAGE + L::HI, lo_s = sb + L::LO_OFF;
    if (u < n_off) {
      product_issue<Q>(acc, ah, al, hi, lo_s);
    } else {
      // diagonal panel k: only columns i >= 32 k see a j <= i, so the
      // product runs on rows 32 k.. of the panels and accumulators 16 k..
      const int k = u - n_off;
      const uint32_t row = 32 * 128 * k;
      if (k == 0) product_issue<Q>(acc, ah, al, hi, lo_s);
      if (k == 1) product_issue<Q - 32>(acc + 16, ah, al, hi + row, lo_s + row);
      if constexpr (Q == 128) {
        if (k == 2) product_issue<64>(acc + 32, ah, al, hi + row, lo_s + row);
        if (k == 3) product_issue<32>(acc + 48, ah, al, hi + row, lo_s + row);
      }
    }
    product_wait(acc, ah, al);
    if (u == n_off - 1) {
#pragma unroll
      for (int r = 0; r < Q / 2; ++r)
        acc[r] *= e_s[8 * (r >> 2) + 2 * tq + (r & 1)];
    }
    __syncthreads();   // every read of this stage and of the lo panel done
  }
  float* yb = A.y + ((static_cast<long long>(b) * A.T + t0) * A.H + h) * P;
  const long long y_row = static_cast<long long>(A.H) * P;
#pragma unroll
  for (int r = 0; r < Q / 2; ++r) {
    const int p = 16 * warp + gq + 8 * ((r >> 1) & 1);
    const int i = 8 * (r >> 2) + 2 * tq + (r & 1);
    if (p < P) yb[i * y_row + p] = acc[r];
  }
}

// Opt in to `bytes` of dynamic shared memory for `kern`, once per device
// and call site (`done`): the call is not free, so it stays off the hot
// path.
template <typename Kernel>
cudaError_t opt_in(Kernel kern, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int Q, int N, int P>
int launch(const Args& A, int last_step, cudaStream_t stream) {
  const int B = A.B, H = A.H, nc = A.nc;
  constexpr int prep_heads = PREP_THREADS / 32;
  ssd_prep_kernel<Q><<<dim3((H + prep_heads - 1) / prep_heads, nc, B),
                       PREP_THREADS, 0, stream>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static bool cb_in[64] = {}, st_in[64] = {}, out_in[64] = {};
  constexpr size_t cb_smem = CbLayout<Q>::BYTES;
  if ((err = opt_in(ssd_cb_kernel<Q, N>, cb_smem, cb_in)) != cudaSuccess)
    return err;
  ssd_cb_kernel<Q, N><<<dim3(A.G * (Q / 64), nc, B), WG, cb_smem, stream>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (last_step < 2) return cudaSuccess;

  if (nc > 1) {
    constexpr size_t st_smem = StLayout<Q, N, P>::BYTES;
    if ((err = opt_in(ssd_states_kernel<Q, N, P>, st_smem, st_in)) !=
        cudaSuccess)
      return err;
    ssd_states_kernel<Q, N, P><<<dim3(H, nc - 1, B), WG, st_smem, stream>>>(
        A);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (last_step < 3) return cudaSuccess;
    const long long total = static_cast<long long>(B) * H * (N * P / 4);
    ssd_pass_kernel<<<static_cast<unsigned>((total + PASS_THREADS - 1) /
                                            PASS_THREADS),
                      PASS_THREADS, 0, stream>>>(A.st, A.cs, H, A.T, Q, nc,
                                                 N * P / 4, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (last_step < 4) return cudaSuccess;

  constexpr size_t out_smem = OutLayout<Q, P>::BYTES;
  if ((err = opt_in(ssd_out_kernel<Q, N, P>, out_smem, out_in)) !=
      cudaSuccess)
    return err;
  ssd_out_kernel<Q, N, P><<<dim3(H, nc, B), WG, out_smem, stream>>>(A);
  return cudaGetLastError();
}

// The instantiations route "tc" has: f(Shape<Q, N, P>{}) for the given
// (Q, N, P), or `fail` for a shape it does not take.
template <int Q_, int N_, int P_>
struct Shape {
  static constexpr int Q = Q_, N = N_, P = P_;
};

template <int Q, int N, typename F>
int dispatch_p(int P, int fail, F&& f) {
  if (P == 32) return f(Shape<Q, N, 32>{});
  if (P == 64) return f(Shape<Q, N, 64>{});
  return fail;
}

template <int Q, typename F>
int dispatch_n(int N, int P, int fail, F&& f) {
  if (N == 32) return dispatch_p<Q, 32>(P, fail, f);
  if (N == 64) return dispatch_p<Q, 64>(P, fail, f);
  if (N == 128) return dispatch_p<Q, 128>(P, fail, f);
  return fail;
}

template <typename F>
int dispatch(int Q, int N, int P, int fail, F&& f) {
  if (Q == 64) return dispatch_n<64>(N, P, fail, f);
  if (Q == 128) return dispatch_n<128>(N, P, fail, f);
  return fail;
}

template <int Q, int N, int P>
int smem_bytes(int which) {
  return which == 1   ? CbLayout<Q>::BYTES
         : which == 2 ? StLayout<Q, N, P>::BYTES
         : which == 4 ? OutLayout<Q, P>::BYTES
                      : 0;
}

}  // namespace tc
}  // namespace

// Dynamic shared memory of a tensor-core sub-kernel: which 1 = C B^T,
// 2 = chunk states, 4 = chunk outputs; 0 for what the route does not take.
extern "C" int ssd_tc_smem_bytes(int which, int Q, int N, int P) {
  return tc::dispatch(Q, N, P, 0, [which](auto shape) {
    using S = decltype(shape);
    return tc::smem_bytes<S::Q, S::N, S::P>(which);
  });
}

// Route "tc".  x [B,T,H,P], B/C [B,T,G,N], dt [B,T,H], a [H] as for
// `ssd_scan_fwd`, with x, B and C 16-byte aligned (pointers and the strides
// given, in elements); y contiguous [B,T,H,P]; scratch from the caller,
// all float32: cs [B,H,T,2], dtT [B,H,T], cb [B,T/Q,G,Q,Q],
// st [B,T/Q-1,H,N,P].  Runs the steps up to `last_step` (1: cumulative sums and C B^T;
// 2: + chunk states; 3: + state passing; 4: + outputs, the whole op).
// -> cudaGetLastError() after the last launch, or cudaErrorInvalidValue for
// shapes the route does not take.
extern "C" int ssd_scan_tc(const void* x, const void* dt, const void* a,
                           const void* bm, const void* cm, void* y, void* cs,
                           void* dtT, void* cb, void* st, int B, int T, int H,
                           int G, int P, int N, int Q, long long sxb,
                           long long sxt, long long sxh, long long sdb,
                           long long sdt, long long sdh, long long sbb,
                           long long sbt, long long sbg, long long scb,
                           long long sct, long long scg, long long sa,
                           int last_step, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || G <= 0 || H <= 0 || H % G != 0 ||
      (Q != 64 && Q != 128) || T % Q != 0 || T / Q > 65535 ||
      last_step < 1 || last_step > 4)
    return cudaErrorInvalidValue;
  const tc::Args args{
      static_cast<const float*>(x),  static_cast<const float*>(dt),
      static_cast<const float*>(a),  static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<float*>(y),
      static_cast<float2*>(cs),      static_cast<float*>(dtT),
      static_cast<float*>(cb),       static_cast<float*>(st),
      B, T, H, G, T / Q,
      sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, sbg, scb, sct, scg, sa};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tc::dispatch(Q, N, P, cudaErrorInvalidValue, [&](auto shape) {
    using S = decltype(shape);
    return tc::launch<S::Q, S::N, S::P>(args, last_step, s);
  });
}
