// TRIM mapspace scoring on Hopper (sm_90a): one thread per mapping row,
// reading the packed mapspace itself.
//
// Replaces the JAX package's Pallas TPU kernels in
// src/repro/kernels/mapspace_eval/kernel.py: `_score_kernel` (one
// architecture) and `_score_kernel_multi` (rows of several architectures
// sharing a structural BatchSig, fused into one launch).  Those read twelve
// to fifteen per-row arrays that a host packer derives from the packed
// mapspace (`ops._mapping_rows`).  This kernel computes what the JAX
// package's whole path computes, packer included, from what the mapspace
// holds:
//   factors [B, L, 7] int32   loop bound per tiling level per dim
//   rank    [B, L, 7] int32   position of each dim in a memory level's order
//   store   [B, Lm, 3] bool   which tensors each memory level stages
//   jobs    [J] JobRec        one record of constants per (arch, workload)
//   offsets [J + 1] int32     job j owns rows offsets[j]..offsets[j+1]-1
//                             (null for one job: the single-architecture
//                             entry is the one-job case of this template)
// For each row it derives the packer's quantities in the packer's float32
// operation order (tile extents as suffix products of the factors, the loop
// slots and their cumulative product, the relevance bits, union and
// per-instance tile words, the input fresh words of the one slot the scan
// selects, parent and child instance counts, NoC energies per chain pair),
// scores them as `_score_body` does (innermost-relevant-loop scan, psum
// read-modify-write, zero-skip factors; cycles = max(compute, per-level
// bandwidth, NoC), energy = dynamic + leakage x cycles), and checks
// validity as `core.backend.validity_mask_arrays` does, in double (exact for
// these integer products): every routing level's fan-out product is at most
// its fan-out, every memory level's staged tile words at most its size.
//
// What bounds it on an H100: neither, at the main path's sizes.  A row is
// 2 x 28 L + 3 Lm bytes in (233 B for the spatial template) and 9 B out;
// its work is some 330 float operations of scoring plus the derivation,
// scalar and data-dependent, with no matrix product, so there is nothing
// for wgmma to take: one thread per row.  At 3.35 TB/s 8,412 rows move in
// about 0.6 us and 42,992 in about 3 us, below a launch's latency; the
// kernel's time is one thread's chain of dependent operations.  The design
// keeps the bytes at what the function needs: a block stages its rows of
// `factors`, `rank` and `store` (contiguous in memory) and the records of
// the first kStagedJobs jobs its rows span into shared memory with
// coalesced 16-byte `cp.async` copies; a row whose job lies past those
// reads its record from global memory (the same address for the job's
// rows).  Registers hold only the row's slots; levels are read from shared
// memory.  The ragged tail is masked; nothing is padded to a block.
//
// Build (see kernel.py): nvcc -gencode arch=compute_90a,code=sm_90a -O3
// --fmad=false -shared -Xcompiler -fPIC.  --fmad=false keeps a*b+c as two
// roundings, as the plain PyTorch version computes it.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxMem = 3;      // memory levels: make_spatial_arch 3, make_fpga_arch 2
constexpr int kMaxLevels = 6;   // tiling levels, memory and routing
constexpr int kMaxRout = kMaxLevels - 2;
constexpr int kBlock = 128;
constexpr int kStagedJobs = 8;
// dims N M C R S E F -> bit d
constexpr uint32_t kRelIn = 0x7Du, kRelW = 0x1Eu, kRelOut = 0x63u;
constexpr uint32_t kRelOutDepthwise = 0x67u, kSliding = 0x78u;
constexpr int N_ = 0, M_ = 1, C_ = 2, R_ = 3, S_ = 4, E_ = 5, F_ = 6;

// One (architecture, workload) job, in the host's REC_FIELDS order (ref.py).
struct JobRec {
  double sizes[kMaxMem];       // words; inf when unbounded
  double mem_bw[kMaxMem];
  double e_read[kMaxMem];
  double e_write[kMaxMem];
  double fanout[kMaxRout];     // per routing level, in level order
  double uni_e[kMaxRout];
  double multi_e[kMaxRout];
  double acc_e[kMaxRout];
  double zf[3];                // zero-skip factor per tensor
  double macs;
  double eff_macs;
  double macs_per_pe;
  double pipeline;
  double mac_energy;
  double leak;                 // total leakage pJ/cycle
  double noc_bw;               // 1e30 when there is no routing level
  double zs_boundary;          // tiling index, or -1
  double stride[2];
  double dilation[2];
  double pad;
};
static_assert(sizeof(JobRec) % 16 == 0, "records are copied 16 B at a time");

// What every job of a launch shares (its BatchSig).
struct Layout {
  int n_levels;
  int mem_idx[kMaxMem];
  uint32_t rout_mask;          // bit l: tiling level l is a routing level
  int depthwise;
  int has_weight;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Copy `nbytes` contiguous bytes (16-byte aligned at both ends' start) into
// shared memory: 16 B a thread, the last few bytes one a thread.
__device__ __forceinline__ void stage(void* dst, const void* src, int nbytes) {
  const int n16 = nbytes >> 4;
  for (int i = threadIdx.x; i < n16; i += kBlock)
    cp_async16(static_cast<char*>(dst) + 16 * i,
               static_cast<const char*>(src) + 16 * i);
  const int tail = nbytes & 15;
  if (static_cast<int>(threadIdx.x) < tail)
    static_cast<char*>(dst)[16 * n16 + threadIdx.x] =
        static_cast<const char*>(src)[16 * n16 + threadIdx.x];
}

// The job that owns `row`: the last j with offsets[j] <= row.
__device__ __forceinline__ int job_of(const int* __restrict__ offsets,
                                      int n_jobs, int row) {
  if (offsets == nullptr) return 0;
  int lo = 0, hi = n_jobs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(offsets + mid) <= row) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Per-dim tile extent below tiling index `level`: factors of the levels
// >= level multiplied from the innermost level out, as the packer's
// flip-cumprod-flip does; level == L (compute) gives ones.
template <typename T>
__device__ __forceinline__ void tile_at(const int* f, int n_levels, int level,
                                        T out[7]) {
#pragma unroll
  for (int d = 0; d < 7; ++d) out[d] = T(1);
  for (int k = n_levels - 1; k >= level; --k) {
#pragma unroll
    for (int d = 0; d < 7; ++d) out[d] = out[d] * static_cast<T>(f[k * 7 + d]);
  }
}

// Words of a tile per tensor (input, weight, output).
template <typename T>
__device__ __forceinline__ void tile_words(const T t[7], T u, T v, T dr, T ds,
                                           const Layout& lay, T out[3]) {
  const T p = (t[E_] - T(1)) * u + (t[R_] - T(1)) * dr + T(1);
  const T q = (t[F_] - T(1)) * v + (t[S_] - T(1)) * ds + T(1);
  out[0] = t[N_] * t[C_] * p * q;
  out[1] = lay.has_weight ? t[R_] * t[S_] * t[C_] * t[M_] : T(0);
  out[2] = t[N_] * t[E_] * t[F_] * (lay.depthwise ? t[C_] : t[M_]);
}

// Input words fresh in one slide step along the sliding dim `d`.
__device__ __forceinline__ float fresh_words(const float t[7], int d, float u,
                                             float v, float dr, float ds) {
  const float p = (t[E_] - 1.0f) * u + (t[R_] - 1.0f) * dr + 1.0f;
  const float q = (t[F_] - 1.0f) * v + (t[S_] - 1.0f) * ds + 1.0f;
  if (d == E_) return t[N_] * t[C_] * fminf(p, t[E_] * u) * q;
  if (d == F_) return t[N_] * t[C_] * p * fminf(q, t[F_] * v);
  if (d == R_) return t[N_] * t[C_] * fminf(p, t[R_] * dr) * q;
  return t[N_] * t[C_] * p * fminf(q, t[S_] * ds);
}

// Instances of the levels outer than tiling index `idx`: the product of the
// routing levels' factor products.
__device__ __forceinline__ float inst_before(const int* f, uint32_t rout_mask,
                                             int idx) {
  float inst = 1.0f;
  for (int r = 0; r < idx; ++r) {
    if (!((rout_mask >> r) & 1u)) continue;
    float p = static_cast<float>(f[r * 7]);
#pragma unroll
    for (int d = 1; d < 7; ++d) p = p * static_cast<float>(f[r * 7 + d]);
    inst = inst * p;
  }
  return inst;
}

template <int N_MEM>
__global__ void __launch_bounds__(kBlock)
score_kernel(const int* __restrict__ factors, const int* __restrict__ rank,
             const uint8_t* __restrict__ store,
             const JobRec* __restrict__ jobs, const int* __restrict__ offsets,
             int n_jobs, Layout lay, float* __restrict__ cycles_out,
             float* __restrict__ energy_out, uint8_t* __restrict__ valid_out,
             int n_rows) {
  constexpr int S = 7 * N_MEM;
  constexpr int L1 = N_MEM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = lay.n_levels;
  const int row_words = 7 * L;
  const int first = blockIdx.x * kBlock;
  const int rows = min(kBlock, n_rows - first);

  JobRec* s_jobs = reinterpret_cast<JobRec*>(smem);
  int* s_f = reinterpret_cast<int*>(smem + kStagedJobs * sizeof(JobRec));
  int* s_r = s_f + kBlock * row_words;
  uint8_t* s_st = reinterpret_cast<uint8_t*>(s_r + kBlock * row_words);

  const int j0 = job_of(offsets, n_jobs, first);
  const int n_staged =
      min(job_of(offsets, n_jobs, first + rows - 1) - j0 + 1, kStagedJobs);
  stage(s_jobs, jobs + j0, n_staged * static_cast<int>(sizeof(JobRec)));
  const size_t w0 = static_cast<size_t>(first) * row_words;
  stage(s_f, factors + w0, rows * row_words * 4);
  stage(s_r, rank + w0, rows * row_words * 4);
  stage(s_st, store + static_cast<size_t>(first) * N_MEM * 3, rows * N_MEM * 3);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= rows) return;
  const int row = first + t;
  const int j = job_of(offsets, n_jobs, row);
  const JobRec& rec = (j - j0 < kStagedJobs) ? s_jobs[j - j0] : jobs[j];
  const int* f = s_f + t * row_words;
  const int* rk = s_r + t * row_words;
  const uint8_t* st = s_st + t * N_MEM * 3;
  const float u = static_cast<float>(rec.stride[0]);
  const float v = static_cast<float>(rec.stride[1]);
  const float dr = static_cast<float>(rec.dilation[0]);
  const float ds = static_cast<float>(rec.dilation[1]);

  // ---- loop slots: memory level j's dims in its loop order --------------
  float bnd[S];
  uint64_t dims = 0;            // 3 bits a slot: the dim it iterates
#pragma unroll
  for (int m = 0; m < N_MEM; ++m) {
    const int li = lay.mem_idx[m];
    int r7[7];
    float f7[7];
#pragma unroll
    for (int d = 0; d < 7; ++d) {
      r7[d] = rk[li * 7 + d];
      f7[d] = static_cast<float>(f[li * 7 + d]);
    }
#pragma unroll
    for (int s = 0; s < 7; ++s) {
      float b = 1.0f;
      int dim = 0;
#pragma unroll
      for (int d = 0; d < 7; ++d)   // a later dim wins, as in the packer
        if (r7[d] == s) { b = f7[d]; dim = d; }
      bnd[m * 7 + s] = b;
      dims |= static_cast<uint64_t>(dim) << (3 * (m * 7 + s));
    }
  }
  float cum[S];
  cum[0] = bnd[0];
#pragma unroll
  for (int s = 1; s < S; ++s) cum[s] = cum[s - 1] * bnd[s];
  const uint32_t rel_out = lay.depthwise ? kRelOutDepthwise : kRelOut;
  uint32_t rel[3] = {0u, 0u, 0u};     // bit s: slot s relevant and active
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (!(bnd[s] > 1.0f)) continue;
    const int dim = static_cast<int>((dims >> (3 * s)) & 7u);
    rel[0] |= ((kRelIn >> dim) & 1u) << s;
    rel[1] |= ((kRelW >> dim) & 1u) << s;
    rel[2] |= ((rel_out >> dim) & 1u) << s;
  }

  float reads[N_MEM], writes[N_MEM], raw[N_MEM], ia[N_MEM];
#pragma unroll
  for (int m = 0; m < N_MEM; ++m) reads[m] = writes[m] = raw[m] = 0.0f;
  float noc_words = 0.0f;
  float dyn = static_cast<float>(rec.eff_macs * rec.mac_energy);
  float ib_last = 1.0f;

#pragma unroll
  for (int jj = 0; jj < L1; ++jj) {
    const int parent = lay.mem_idx[jj];
    const int child = jj + 1 < N_MEM ? lay.mem_idx[jj + 1] : L;
    float per[7], sb[7], uni[7], tw_p[3], tw_u[3];
    tile_at(f, L, child, per);
#pragma unroll
    for (int d = 0; d < 7; ++d) sb[d] = 1.0f;
    float ne[3] = {0.0f, 0.0f, 0.0f};
    bool crossed = false;
    for (int r = parent + 1; r < child; ++r) {     // routing levels crossed
      if (!((lay.rout_mask >> r) & 1u)) continue;
      crossed = true;
      const int k = __popc(lay.rout_mask & ((1u << r) - 1u));
      const int* fr = f + r * 7;
#pragma unroll
      for (int d = 0; d < 7; ++d) sb[d] = sb[d] * static_cast<float>(fr[d]);
      const bool m_w = fr[N_] > 1 || fr[E_] > 1 || fr[F_] > 1;
      const bool m_i = fr[M_] > 1;
      const bool a_o = fr[C_] > 1 || fr[R_] > 1 || fr[S_] > 1;
      // the packer adds float64 energies into float32 sums
      ne[0] = static_cast<float>(static_cast<double>(ne[0]) +
                                 (m_i ? rec.multi_e[k] : rec.uni_e[k]));
      ne[1] = static_cast<float>(static_cast<double>(ne[1]) +
                                 (m_w ? rec.multi_e[k] : rec.uni_e[k]));
      ne[2] = static_cast<float>(static_cast<double>(ne[2]) +
                                 (a_o ? rec.acc_e[k] : rec.uni_e[k]));
    }
#pragma unroll
    for (int d = 0; d < 7; ++d) uni[d] = per[d] * sb[d];
    tile_words(per, u, v, dr, ds, lay, tw_p);
    tile_words(uni, u, v, dr, ds, lay, tw_u);
    const float i_a = inst_before(f, lay.rout_mask, parent);
    const float i_b = inst_before(f, lay.rout_mask, child);
    ia[jj] = i_a;
    if (jj == L1 - 1) ib_last = i_b;
    const float nm = crossed ? 1.0f : 0.0f;
    const bool zs_parent = rec.zs_boundary >= 0.0 &&
                           static_cast<double>(parent) >= rec.zs_boundary;
    // the child of pair jj sees the slots of memory levels 0..jj
    const uint32_t visible = (1u << (7 * (jj + 1))) - 1u;
#pragma unroll
    for (int tn = 0; tn < 3; ++tn) {
      const float zsf = zs_parent ? static_cast<float>(rec.zf[tn]) : 1.0f;
      const uint32_t r = rel[tn] & visible;
      const bool has = r != 0u;
      const int k = has ? 31 - __clz(r) : 0;     // innermost relevant slot
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
      if (tn == 2) {                             // output: psum read-modify-write
        float dd = 1.0f;
#pragma unroll
        for (int s = 0; s < S; ++s)
          if ((r >> s) & 1u) dd *= bnd[s];
        const float p_rd = i_a * (vv - dd) * tw_u[2];
        const float p_wr = i_a * vv * tw_u[2];
        reads[jj] += p_rd * zsf;
        writes[jj] += p_wr * zsf;
        raw[jj] += p_rd + p_wr;
        if (jj + 1 < L1) {
          const float c_rd = i_b * vv * tw_p[2];
          const float c_wr = i_b * (vv - dd) * tw_p[2];
          reads[jj + 1] += c_rd * zsf;
          writes[jj + 1] += c_wr * zsf;
          raw[jj + 1] += c_rd + c_wr;
        }
        const float nw = i_b * (2.0f * vv - dd) * tw_p[2] * nm;
        noc_words += nw;
        dyn += nw * zsf * ne[2];
      } else {
        float words;
        if (tn == 0) {                           // input: halo credit
          const int dim = static_cast<int>((dims >> (3 * k)) & 7u);
          const float fr = ((kSliding >> dim) & 1u)
                               ? fresh_words(uni, dim, u, v, dr, ds)
                               : tw_u[0];
          words = has ? outer * (tw_u[0] + (b_k - 1.0f) * fr) : tw_u[0];
        } else {
          words = has ? vv * tw_u[1] : tw_u[1];
        }
        const float p_rd = i_a * words;
        reads[jj] += p_rd * zsf;
        raw[jj] += p_rd;
        if (jj + 1 < L1) {
          const float c_wr = i_b * vv * tw_p[tn];
          writes[jj + 1] += c_wr * zsf;
          raw[jj + 1] += c_wr;
        }
        const float nw = p_rd * nm;
        noc_words += nw;
        dyn += nw * zsf * ne[tn];
      }
    }
  }

  const float pes = fmaxf(ib_last, 1.0f);       // compute leaf
  float cycles =
      static_cast<float>(rec.macs / (rec.macs_per_pe * rec.pipeline)) / pes;
#pragma unroll
  for (int m = 0; m < N_MEM; ++m) {
    cycles = fmaxf(cycles, raw[m] / (static_cast<float>(rec.mem_bw[m]) * ia[m]));
    dyn += reads[m] * static_cast<float>(rec.e_read[m]) +
           writes[m] * static_cast<float>(rec.e_write[m]);
  }
  cycles = fmaxf(cycles, noc_words / static_cast<float>(rec.noc_bw));
  cycles_out[row] = cycles;
  energy_out[row] = dyn + static_cast<float>(rec.leak) * cycles;

  // ---- validity, in double ------------------------------------------------
  bool ok = true;
  for (int r = 0, k = 0; r < L; ++r) {
    if (!((lay.rout_mask >> r) & 1u)) continue;
    double p = 1.0;
#pragma unroll
    for (int d = 0; d < 7; ++d) p = p * static_cast<double>(f[r * 7 + d]);
    ok = ok && p <= rec.fanout[k];
    ++k;
  }
#pragma unroll
  for (int m = 0; m < N_MEM; ++m) {
    double tile[7], w[3];
    tile_at(f, L, lay.mem_idx[m], tile);
    tile_words(tile, rec.stride[0], rec.stride[1], rec.dilation[0],
               rec.dilation[1], lay, w);
    const double used = (st[m * 3] ? w[0] : 0.0) +
                        (st[m * 3 + 1] ? w[1] : 0.0) +
                        (st[m * 3 + 2] ? w[2] : 0.0);
    ok = ok && used <= rec.sizes[m];
  }
  valid_out[row] = ok ? 1 : 0;
}

size_t smem_bytes(int n_levels, int n_mem) {
  return kStagedJobs * sizeof(JobRec) +
         2 * static_cast<size_t>(kBlock) * 7 * n_levels * sizeof(int) +
         static_cast<size_t>(kBlock) * n_mem * 3;
}

template <int N_MEM>
int launch(const int* factors, const int* rank, const uint8_t* store,
           const JobRec* jobs, const int* offsets, int n_jobs,
           const Layout& lay, float* cycles, float* energy, uint8_t* valid,
           int n_rows, cudaStream_t stream) {
  const int grid = (n_rows + kBlock - 1) / kBlock;
  score_kernel<N_MEM><<<grid, kBlock, smem_bytes(lay.n_levels, N_MEM),
                        stream>>>(factors, rank, store, jobs, offsets, n_jobs,
                                  lay, cycles, energy, valid, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Layout check: writes the offset (in doubles) of each JobRec field, in
// declaration order, into `out` and returns the record's size in doubles.
int mapspace_eval_job_layout(int* out) {
  int i = 0;
#define REC_OFFSET(name) out[i++] = static_cast<int>(offsetof(JobRec, name) / sizeof(double))
  REC_OFFSET(sizes); REC_OFFSET(mem_bw); REC_OFFSET(e_read);
  REC_OFFSET(e_write); REC_OFFSET(fanout); REC_OFFSET(uni_e);
  REC_OFFSET(multi_e); REC_OFFSET(acc_e); REC_OFFSET(zf); REC_OFFSET(macs);
  REC_OFFSET(eff_macs); REC_OFFSET(macs_per_pe); REC_OFFSET(pipeline);
  REC_OFFSET(mac_energy); REC_OFFSET(leak); REC_OFFSET(noc_bw);
  REC_OFFSET(zs_boundary); REC_OFFSET(stride); REC_OFFSET(dilation);
  REC_OFFSET(pad);
#undef REC_OFFSET
  return static_cast<int>(sizeof(JobRec) / sizeof(double));
}

// Scores and validity of `n_rows` rows.  `offsets` may be null (one job).
// factors, rank, store and jobs must be 16-byte aligned.  Returns the
// launch's cudaGetLastError(), or -1 for an unsupported layout.
int mapspace_eval_score(const int* factors, const int* rank,
                        const uint8_t* store, const double* jobs,
                        const int* offsets, int n_jobs, int n_rows,
                        int n_levels, int n_mem, int mem0, int mem1, int mem2,
                        unsigned rout_mask, int depthwise, int has_weight,
                        float* cycles, float* energy, uint8_t* valid,
                        void* stream) {
  if (n_rows <= 0) return 0;
  if (n_levels > kMaxLevels || n_jobs < 1) return -1;
  const Layout lay{n_levels, {mem0, mem1, mem2}, rout_mask, depthwise,
                   has_weight};
  const JobRec* recs = reinterpret_cast<const JobRec*>(jobs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_mem) {
    case 2: return launch<2>(factors, rank, store, recs, offsets, n_jobs, lay,
                             cycles, energy, valid, n_rows, st);
    case 3: return launch<3>(factors, rank, store, recs, offsets, n_jobs, lay,
                             cycles, energy, valid, n_rows, st);
    default: return -1;
  }
}

}  // extern "C"
