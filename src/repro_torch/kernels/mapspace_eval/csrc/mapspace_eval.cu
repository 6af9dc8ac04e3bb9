// TRIM mapspace scoring on Hopper (sm_90a): one thread per mapping row.
//
// Replaces the JAX package's Pallas TPU kernels in
// src/repro/kernels/mapspace_eval/kernel.py: `_score_kernel` (single
// architecture, hardware constants baked in) and `_score_kernel_multi`
// (per-row hardware constants, so rows of several architectures sharing a
// structural BatchSig fuse into one launch), both built on `_score_body`.
// It computes what `_score_body` computes for one row — the per-chain-pair
// innermost-relevant-loop scan (V, D), input halo credit through `fresh`,
// the output psum read-modify-write, NoC words x per-word energy, zero-skip
// factors; cycles = max(compute, per-level bandwidth, NoC) and energy =
// dynamic + leakage x cycles — but not in its [BLOCK, SLOTS] vector layout:
// the row's slots and per-level sums live in registers and the slot search
// is an integer bit scan (no float equality on slot positions).
//
// What bounds it on an H100: bytes.  A row's inputs hold 816 B (single) or
// 904 B (multi), but of `fresh` [L1, S] it reads one float per level, so it
// needs about 564 B (652 B) plus at most three 32-B sectors of `fresh`, and
// writes 8 B.  Its float work is about 330 operations: some 245 arithmetic
// (at most 42 of them the psum products) and 84 compares.  At 3.35 TB/s a
// 10k-row mapspace moves in about 2 us.  At the main path's sizes launch
// overhead and the host-side numpy packer (ops._mapping_rows) set the pace,
// not this kernel.
//
// What the simple design leaves for later: each thread reads its own row,
// so a warp's loads are strided by the row pitch (uncoalesced).  Staging a
// block's rows through shared memory with coalesced (or TMA) copies is
// later work.  The ragged tail is masked; nothing is padded to a block.
//
// Build (see kernel.py): nvcc -gencode arch=compute_90a,code=sm_90a -O3
// --fmad=false -shared -Xcompiler -fPIC.  --fmad=false keeps a*b+c as two
// roundings, as the plain PyTorch version computes it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxMem = 3;   // memory levels: make_spatial_arch 3, make_fpga_arch 2
constexpr int kBlock = 256;

// Single-architecture constants (PER_ROW=false), passed by value.  The
// host fills it from a float array in exactly this order.
struct HwConst {
  float zsf[kMaxMem][3];     // zero-skip factor per chain pair per tensor
  float mem_bw[kMaxMem];
  float e_read[kMaxMem];
  float e_write[kMaxMem];
  float macs;
  float macs_per_pe;
  float pipeline;
  float dyn0;                // effective MACs x pJ/MAC
  float leak;                // total leakage pJ/cycle
  float noc_bw;              // 1e30 when there is no routing level
};

struct Rows {
  const float* __restrict__ bounds;   // [B, S] slot loop bounds (nest order)
  const float* __restrict__ cum;      // [B, S] cumprod of bounds
  const float* __restrict__ rel_i;    // [B, S] relevance per tensor (0/1)
  const float* __restrict__ rel_w;
  const float* __restrict__ rel_o;
  const float* __restrict__ tw_u;     // [B, L1, 3] union tile words
  const float* __restrict__ tw_p;     // [B, L1, 3] per-instance tile words
  const float* __restrict__ fresh;    // [B, L1, S] input fresh words
  const float* __restrict__ ia;       // [B, L1] parent instances
  const float* __restrict__ ib;       // [B, L1] child instances
  const float* __restrict__ noc_e;    // [B, L1, 3] NoC pJ/word
  const float* __restrict__ noc_m;    // [B, L1] 1 if the pair crosses a NoC
  const float* __restrict__ zsf;      // [B, L1, 3]   PER_ROW only
  const float* __restrict__ mem_par;  // [B, Lm, 3]   PER_ROW only
  const float* __restrict__ hw_row;   // [B, 4]       PER_ROW only
};

template <bool PER_ROW, int N_MEM>
__global__ void __launch_bounds__(kBlock)
score_kernel(Rows in, HwConst hc, float* __restrict__ cycles_out,
             float* __restrict__ energy_out, int n_rows) {
  constexpr int S = 7 * N_MEM;
  constexpr int L1 = N_MEM;
  const int row = blockIdx.x * kBlock + threadIdx.x;
  if (row >= n_rows) return;
  const size_t r0 = static_cast<size_t>(row);

  float bnd[S];
  float cum[S];
  uint32_t rel[3] = {0u, 0u, 0u};     // bit s: slot s relevant and active
#pragma unroll
  for (int s = 0; s < S; ++s) {
    bnd[s] = in.bounds[r0 * S + s];
    cum[s] = in.cum[r0 * S + s];
    const uint32_t act = bnd[s] > 1.0f ? (1u << s) : 0u;
    if (in.rel_i[r0 * S + s] > 0.0f) rel[0] |= act;
    if (in.rel_w[r0 * S + s] > 0.0f) rel[1] |= act;
    if (in.rel_o[r0 * S + s] > 0.0f) rel[2] |= act;
  }

  float reads[N_MEM], writes[N_MEM], raw[N_MEM];
#pragma unroll
  for (int m = 0; m < N_MEM; ++m) reads[m] = writes[m] = raw[m] = 0.0f;
  float noc_words = 0.0f;
  float dyn = PER_ROW ? in.hw_row[r0 * 4 + 1] : hc.dyn0;

#pragma unroll
  for (int j = 0; j < L1; ++j) {
    // the child of pair j sees the slots of memory levels 0..j
    const uint32_t visible = (1u << (7 * (j + 1))) - 1u;
    const float i_a = in.ia[r0 * L1 + j];
    const float i_b = in.ib[r0 * L1 + j];
    const float nm = in.noc_m[r0 * L1 + j];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const size_t jt = (r0 * L1 + j) * 3 + t;
      const float tw_u = in.tw_u[jt];
      const float tw_p = in.tw_p[jt];
      const float ne = in.noc_e[jt];
      const float zsf = PER_ROW ? in.zsf[jt] : hc.zsf[j][t];
      const uint32_t r = rel[t] & visible;
      const bool has = r != 0u;
      const int k = has ? 31 - __clz(r) : 0;   // innermost relevant slot
      float p_k = 1.0f, b_k = 1.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (has && s == k) {
          p_k = cum[s];
          b_k = bnd[s];
        }
      }
      const float vv = p_k;
      const float outer = p_k / b_k;
      if (t == 2) {                            // output: psum read-modify-write
        float dd = 1.0f;
#pragma unroll
        for (int s = 0; s < S; ++s)
          if ((r >> s) & 1u) dd *= bnd[s];
        const float p_rd = i_a * (vv - dd) * tw_u;
        const float p_wr = i_a * vv * tw_u;
        reads[j] += p_rd * zsf;
        writes[j] += p_wr * zsf;
        raw[j] += p_rd + p_wr;
        if (j + 1 < L1) {
          const float c_rd = i_b * vv * tw_p;
          const float c_wr = i_b * (vv - dd) * tw_p;
          reads[j + 1] += c_rd * zsf;
          writes[j + 1] += c_wr * zsf;
          raw[j + 1] += c_rd + c_wr;
        }
        const float nw = i_b * (2.0f * vv - dd) * tw_p * nm;
        noc_words += nw;
        dyn += nw * zsf * ne;
      } else {
        float words;
        if (t == 0) {                          // input: halo credit
          const float fr = in.fresh[(r0 * L1 + j) * S + k];
          words = has ? outer * (tw_u + (b_k - 1.0f) * fr) : tw_u;
        } else {
          words = has ? vv * tw_u : tw_u;
        }
        const float p_rd = i_a * words;
        reads[j] += p_rd * zsf;
        raw[j] += p_rd;
        if (j + 1 < L1) {
          const float c_wr = i_b * vv * tw_p;
          writes[j + 1] += c_wr * zsf;
          raw[j + 1] += c_wr;
        }
        const float nw = p_rd * nm;
        noc_words += nw;
        dyn += nw * zsf * ne;
      }
    }
  }

  const float pes = fmaxf(in.ib[r0 * L1 + L1 - 1], 1.0f);  // compute leaf
  float cycles = PER_ROW ? in.hw_row[r0 * 4 + 0] / pes
                         : hc.macs / (pes * hc.macs_per_pe * hc.pipeline);
#pragma unroll
  for (int m = 0; m < N_MEM; ++m) {
    const float inst_m = in.ia[r0 * L1 + m];   // parent of pair m = level m
    const float bw = PER_ROW ? in.mem_par[(r0 * N_MEM + m) * 3 + 0]
                             : hc.mem_bw[m];
    const float er = PER_ROW ? in.mem_par[(r0 * N_MEM + m) * 3 + 1]
                             : hc.e_read[m];
    const float ew = PER_ROW ? in.mem_par[(r0 * N_MEM + m) * 3 + 2]
                             : hc.e_write[m];
    cycles = fmaxf(cycles, raw[m] / (bw * inst_m));
    dyn += reads[m] * er + writes[m] * ew;
  }
  const float noc_bw = PER_ROW ? in.hw_row[r0 * 4 + 3] : hc.noc_bw;
  const float leak = PER_ROW ? in.hw_row[r0 * 4 + 2] : hc.leak;
  cycles = fmaxf(cycles, noc_words / noc_bw);
  cycles_out[row] = cycles;
  energy_out[row] = dyn + leak * cycles;
}

template <bool PER_ROW, int N_MEM>
int launch(const Rows& in, const HwConst& hc, float* cycles, float* energy,
           int n_rows, cudaStream_t stream) {
  const int grid = (n_rows + kBlock - 1) / kBlock;
  score_kernel<PER_ROW, N_MEM><<<grid, kBlock, 0, stream>>>(
      in, hc, cycles, energy, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool PER_ROW>
int dispatch(const Rows& in, const HwConst& hc, float* cycles,
             float* energy, int n_rows, int n_mem, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_mem) {
    case 2: return launch<PER_ROW, 2>(in, hc, cycles, energy, n_rows, st);
    case 3: return launch<PER_ROW, 3>(in, hc, cycles, energy, n_rows, st);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Number of floats the host passes for HwConst (layout check).
int mapspace_eval_hw_floats() {
  return static_cast<int>(sizeof(HwConst) / sizeof(float));
}

// Single-architecture scoring.  `hw` points to host memory holding
// mapspace_eval_hw_floats() floats in HwConst order.  Returns the launch's
// cudaGetLastError(), or -1 for an unsupported memory-level count.
int mapspace_eval_single(const float* bounds, const float* cum,
                         const float* rel_i, const float* rel_w,
                         const float* rel_o, const float* tw_u,
                         const float* tw_p, const float* fresh,
                         const float* ia, const float* ib,
                         const float* noc_e, const float* noc_m,
                         const float* hw, float* cycles, float* energy,
                         int n_rows, int n_mem, void* stream) {
  HwConst hc;
  memcpy(&hc, hw, sizeof(HwConst));
  const Rows in{bounds, cum,  rel_i, rel_w, rel_o,  tw_u,    tw_p,   fresh,
                ia,     ib,   noc_e, noc_m, nullptr, nullptr, nullptr};
  return dispatch<false>(in, hc, cycles, energy, n_rows, n_mem, stream);
}

// Multi-architecture scoring with per-row constants: zsf [B, L1, 3],
// mem_par [B, Lm, 3] (bandwidth, read pJ, write pJ), hw_row [B, 4]
// (macs / (macs_per_pe * pipeline), dynamic MAC pJ, leakage, NoC bandwidth).
int mapspace_eval_multi(const float* bounds, const float* cum,
                        const float* rel_i, const float* rel_w,
                        const float* rel_o, const float* tw_u,
                        const float* tw_p, const float* fresh,
                        const float* ia, const float* ib,
                        const float* noc_e, const float* noc_m,
                        const float* zsf, const float* mem_par,
                        const float* hw_row, float* cycles, float* energy,
                        int n_rows, int n_mem, void* stream) {
  HwConst hc;
  memset(&hc, 0, sizeof(HwConst));
  const Rows in{bounds, cum, rel_i, rel_w, rel_o, tw_u,    tw_p,  fresh,
                ia,     ib,  noc_e, noc_m, zsf,   mem_par, hw_row};
  return dispatch<true>(in, hc, cycles, energy, n_rows, n_mem, stream);
}

}  // extern "C"
