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
#include <cuda_runtime.h>

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
