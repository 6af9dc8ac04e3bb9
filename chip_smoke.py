#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 and the CUDA toolkit's
`nvcc`.  It imports nothing of JAX and nothing of the JAX package `repro`.
Each phase prints one line; any failure exits non-zero, and no phase
catches its own failure.

  1. device   the card's name and power limit (nvidia-smi) and capability
  2. build    nvcc builds the six kernel libraries from this checkout;
              ptxas's registers and spills and the dynamic shared memory
              of the tensor-core flash kernel at each head dim (64, 80,
              96, 128), and each instantiation's count of HGMMA (wgmma)
              and UTMALDG (TMA load) instructions in SASS, which must not
              be 0 where the toolkit has cuobjdump; the
              same for the SSD route "tc"'s sub-kernels at the models'
              shapes, whose three product kernels must each issue HGMMA
  3. kernels  both mapspace kernels (which read the packed mapspace and
              derive every per-row quantity themselves) against their plain
              PyTorch version on the card: cycles and energy at their
              tolerances and validity exactly equal, at the main path's
              shapes (AlexNet-CIFAR `intra[2]`, no-bypass mapspaces: one
              architecture's for the single-job kernel, all eight's as
              eight jobs for the multi-job one), on a ragged 37-row slice
              (37 rows of each job, so job boundaries fall inside blocks),
              and with every job scored as the smallest architecture, so
              that rows are invalid; times from CUDA events (median of 25
              calls, with a cold L2 and a warm one) and from torch.profiler
              (CUPTI), beside the bound (`bound_ms`)
  4. explore  paper Algorithm 1 at full width: AlexNet-CIFAR training at
              batch 64 (29 workloads) over the 8-architecture quickstart
              space, `MapperConfig(max_mappings=20000, seed=0)`, traced,
              one run of each engine in turns (cuda, then torch; medians
              of more runs are `scripts/dse_timing.py`'s), each engine's
              wall and split by span and by driver phase
              (`explore` is `run_search(strategy="exhaustive",
              batching="per-arch")`); the single-architecture kernel must
              launch, and the winners must equal those of the plain oracle
              (`backend="torch"`); a profiled run over two architectures
              gives the device's busy share
  5. fused    `fused_best` over the 8 architectures x 24 distinct
              workloads, no-bypass mapspaces, traced (copies, kernel),
              three runs of each engine in turns, medians; the
              multi-architecture kernel must launch, and the winners must
              equal the oracle's
  6. search   `run_search` at the fused phase's setup (8 architectures,
              no-bypass mapspaces), traced, each run's wall and driver
              phase split (`report.phase_times`): (a) exhaustive, fused,
              streamed (2 architectures a round) on "cuda" and on "torch":
              the multi-architecture kernel must launch, and both engines
              must give the same best, mappings, history and frontier;
              (b) the same on "cuda" with `overlap=False`, equal to (a);
              (c) anneal at budget 4, per-arch batching, with a disk cache
              in a temporary directory, cold then warm: the
              single-architecture kernel must launch in the cold run, the
              warm run is all hits with the same report, and the run's
              manifest names this card
  7. flash    both flash-attention kernels against their plain version
              on the card, each case on the route its `FLASH_CASES` entry
              names, which `choose_route` must name too (printed, and
              checked against the route counters): the serving prefill's
              shape (B=4, S=2048, 9 query on 3 KV heads of 64, bf16),
              bf16 at D=128 causal and full, a ragged S=1000 at D=64, a
              ragged S=300 at D=80 and a full ragged S=1000 at D=96 on the
              tensor-core kernel; a ragged float32 shape (S=1000, D=128)
              and a small float32 one at D=96 on the SIMT kernel; the
              prefill shapes of phase 13 (12/2 heads of 128, 16/8 and
              12/12 heads of 64, phi3-mini-3.8b's 32/32 heads of 96 and
              48/8 heads of 128, bf16, all on the tensor-core kernel).  At
              the serving prefill's shape and at phi3's: times as in
              phase 3, beside the bound, the SIMT kernel on the same
              values in a padded layout that only it takes (the kernel
              before the tensor-core one), and one PyTorch call computing
              the same function (`scaled_dot_product_attention`, timed
              here only, never called by the port)
  8. serve    smollm-135m at full width (bf16, random weights from a seed):
              (a) the prefill `forward(tokens [4, 2048], logits_mode=
              "last")` with the kernel installed must launch the
              tensor-core kernel once per layer (30), the RMS-norm kernel
              once a norm (61, `norm_launches`) and nothing else, and
              match the plain-attention forward; timed by events,
              by the host clock (a call's latency and the part of it
              spent enqueueing) and with the device's busy share;
              (b) `ServeEngine(batch=4, max_len=256)` answers 8 requests
              (prompts of 8-32 tokens, 16 new tokens each), and
              teacher-forced `decode_step` on a 128-token prompt matches
              the prefill's last logits
  9. ssd      both SSD-scan kernels against their plain version
              (`ssd_chunk_scan_streaming`, TF32 off) on the card, at 2e-4,
              and against it in float64: each case on the route
              `choose_route` names (checked against the counters) and, where
              that is the tensor-core route "tc", on the SIMT route too:
              mamba2-2.7b's prefill layer (B=4, T=2048, 80 heads of 64,
              N=128, chunk 128), zamba2-2.7b's layer (B=1, N=64), the JAX
              kernel test's four shapes, strided views cut from a
              conv-output-shaped tensor, T of one chunk, an odd number of
              chunks and G=2 (40 heads a group); each timed as in phase 7,
              both routes in the same run, beside the bound that applies
              to each (`ssd_bound_ms`) and the plain version's time; the
              profiler's time of one op call sums its sub-kernels
  9b. conv    the Mamba2 conv-chain kernel (`kernels/ssm_conv`, through
              `ops.ssm_conv`) on bf16 inputs at mamba2-2.7b's and
              zamba2-2.7b's layer widths, [4, 2048]: one launch a call,
              against `ref.conv_chain` on float32 copies at 1e-5 and
              within 12 u s of the eager bf16 chain (CONV_BF16_ULPS);
              each timed as in phase 7, beside its bytes' bound
              (`conv_bound_ms`) and the eager chain's time
  9c. granite granite-4.0-h-small (`portbench/configs/`'s "model"): (a)
              flash at its attention layer, bf16 [2, 4096], 32 query on
              8 KV heads of 128, with its softmax scale 1/128
              (`attention_multiplier`, not 128^-0.5), against the plain
              version at that scale within FLASH_TOL, and moved from the
              default scale's output by over 10x that; (b) the MoE's
              grouped products (`kernels/moe_grouped`, `torch._grouped_mm`)
              at the benchmark's call of 8,192 tokens x top 10: x [81920,
              4096] times w [72, 4096, 768], and [81920, 768] times [72,
              768, 4096], one expert given no row; one launch a call,
              against the loop over experts on float32 copies within
              GROUPED_TOL of the output's range, the launches the
              profiler records named as `moe_roofline.prefill` reads
              them; (c) the model
              at full width and depth (40 layers, 32.2B parameters, bf16,
              random weights from a CUDA generator seeded with 0): the
              prefill [2, 4096] with the flash hook installed launches
              the grouped GEMM 3 times a layer (120), flash once an
              attention layer (4, tensor-core route), the SSD op ("tc"),
              the conv kernel and the gate kernel once a Mamba2 layer
              (36), the RMS-norm kernel once a norm (81), and nothing
              else; each timed as in phase 7, beside
              its bound
  9d. gate    the Mamba2 gate-chain kernel (`kernels/ssm_gate`, through
              `ops.ssm_gate`) at mamba2-2.7b's layer [4, 2048] and
              granite-4.0-h-small's [2, 4096], bf16, on the views the
              conv kernel and the SSD op hand the model, read in place:
              one launch a call, within one bf16 ulp of the eager chain
              (`ref.gate_chain`) on the same inputs; timed as in phase 7,
              beside its bytes' bound (`gate_bound_ms`) and the eager
              chain's time
  9e. norm    the RMS-norm kernel (`kernels/rms_norm`, through
              `ops.rms_norm`) on bf16 x of the residual stream's scale at
              one call shape of each benchmark cell, phi3-mini-3.8b's [9,
              896, 3072], mamba2-2.7b's [4, 2048, 2560] and
              granite-4.0-h-small's [2, 4096, 4096]: one launch a call,
              within one bf16 ulp of the eager chain (`ref.rms_norm`) on
              the same inputs; timed as in phase 7, beside its bytes'
              bound (`norm_bound_ms`) and the eager chain's time.  Every
              model run on the card outside autograd norms on this
              kernel, plain-attention references included: this phase
              is what holds it to the eager chain
 10. ssm      mamba2-2.7b at full width and depth (64 layers, bf16, random
              weights from a CUDA generator seeded with 0): (a) the prefill
              `forward(tokens [4, 2048], logits_mode="last")` must launch
              the SSD op 64 times, all on route "tc", the conv kernel
              (`kernels/ssm_conv`) and the gate kernel (`kernels/ssm_gate`)
              64 times each, the RMS-norm kernel 65 times, and nothing
              else
              (the counters count op calls); timed, with the
              device's busy share; (b) `ServeEngine(batch=4, max_len=256)`
              answers the serve phase's load; (c) with the weights cast to float32 (bf16 rounding
              through 64 random layers is amplified past any useful
              tolerance), teacher-forced `decode_step` (the pure
              recurrence) over 128 tokens matches the kernel prefill's
              last logits
 11. hybrid   zamba2-2.7b at full width and depth (54 Mamba2 layers, the
              shared GQA block after every 6, window 4096): the prefill
              [1, 2048] with the flash hook installed calls the SSD op 54
              times, all on route "tc", the conv and gate kernels 54 times
              each, the RMS-norm kernel 73 times (54 + 2 x 9 + 1), and
              the flash kernel never (the window keeps it off, as in the
              reference's `sdpa`); decode over one chunk
              matches the prefill in float32, as in phase 10
 12. service  the DSE service (`DSEService(workers=2)`, a disk cache in a
              temporary directory) answering TRIM design queries over one
              smollm-135m training block at full width (30 layers, d_model
              576, 9/3 heads of 64, MLP 1536, vocab 49,152; `lower_block`
              at [4, 2048]: 24 matmul workloads + 3 of the head) on the 8
              architectures, no-bypass mapspaces: query A (exhaustive,
              fused, "cuda") from 4 clients at once and query B (anneal,
              budget 4, per-arch, seed 1) together on the two workers; the
              4 clients coalesce onto one job (admitted 2, coalesced 3)
              with equal event streams; A equals a direct `run_search` on
              "torch"; A resubmitted after it retired is a new job of
              cache hits only with the same report; every job's manifest
              names the card; a deadline of 0.3 of A's wall cancels a job
              with a consistent partial frontier; a forced two-shard plan
              over (cuda:0, cuda:0) on one fused group of A is bit-equal
              to the unsharded call on both engines.  Walls per job and by
              driver phase, the device's idle share over job A, and the
              launches of both mapspace kernels

 13. families every other configuration of `configs/registry.py` at full
              width and depth (bf16, random weights from a CUDA generator
              seeded with 0), one after another, each freed before the
              next: granite-moe-1b-a400m (`moe`), qwen2-vl-2b (`vlm`,
              M-RoPE), whisper-small (`encdec`), minicpm3-4b (MLA),
              deepseek-v2-lite-16b (`moe` + MLA), phi3-mini-3.8b (32/32
              heads of 96) and nemotron-4-15b (squared ReLU, untied
              head over a 256,000 vocab): parameters, init time and peak
              memory (and what was allocated before the init); the
              prefill [4, 2048] (whisper: frames and tokens both [4,
              2048]) with the flash hook installed must launch the flash
              kernel 24, 28, 12, 0, 0, 32 and 32 times, all on the
              tensor-core route (phi3's D 96 as two padded panels)
              (`FAMILY_FLASH`), the RMS-norm kernel once a norm
              (`norm_launches`: 49, 57, 0, 249, 82, 65 and 65), and
              nothing else, timed as in phase 8; for the
              five that launch it, the logits within LOGIT_TOL of plain
              attention's (a miss is a fault, unless the top-k expert
              sets of the two runs show the routing flip that explains
              it, as for granite-moe: then with the flash run's experts
              pinned to the plain run's, within LOGIT_TOL, and on a
              float32 copy, route "simt", within LOGIT_TOL_F32); qwen2-vl
              also from `embeds` [4, 2048, d] and `positions3` of a patch
              grid (text, a 32 x 48 image, text), where M-RoPE's three
              sections differ: 28 launches again, flash within LOGIT_TOL
              of plain;
              `ServeEngine(batch=4, max_len=256)` answers the serve
              phase's load (8 requests, prompts of 8-32 tokens, 16 new
              each; the two MLA engines, the slowest, the first 4 of
              them: `FAMILY_ENGINE_REQUESTS`), with tokens/s over the run
              and over its decode ticks, and one profiled decode step's
              busy share
 14. train    the port's training driver, which launches none of the
              kernels (the reference trains on plain attention and on
              Mamba2's differentiable scan): (a) `launch/train.py::
              train_loop` on smollm-135m at full width and depth (bf16
              params, float32 master copies), [8, 2048] in 2
              microbatches, remat "dots_no_batch", through the mesh path
              (DTensor on a (1, 1) `DeviceMesh`, NCCL, a world of one),
              8 steps into a temporary checkpoint directory, then again
              to 10: it must resume at step 8 and run 2; every loss
              finite and the last below the first; its first loss within
              1e-3 relative of the plain `make_train_step`'s from the
              same state and batch (from (b)), and both step times; step
              walls (host clock) and CUDA-event times, tokens/s, model
              FLOP/s as a share of the bf16 peak, peak memory, one
              profiled step's busy share and longest
              device ops, an unprofiled step's wall and enqueue time,
              checkpoint bytes and copy, write and restore times; (b) at
              the same shape through `make_train_step`: microbatches 1
              against 2 (loss 1e-3 relative, params 5e-3, the reference
              test's contract), remat "none", "full" and "dots_no_batch"
              (loss 1e-3 relative; each one's peak memory, and a second
              step's wall and enqueue time), a saved and restored state
              bit-equal leaf by leaf with its next step's loss within
              1e-3 of the live state's; (c) mamba2-2.7b at full width
              with 2 layers, [2, 512]: one train step with finite loss
              and gradient norm and no SSD launch, and in float32
              `lm_loss` on the SSD kernel (under no_grad, route "tc")
              against the model's scan (under autograd) within SSD_TOL
 15. parallel the sharded step builders (`launch/steps.py`) on a (1, 1)
              mesh, smollm-135m at full width and depth: `build_prefill_
              step` at [4, 2048] with the flash hook (30 launches on
              route "wgmma" and 61 of the RMS-norm kernel, each on local
              shards through `local_map`;
              logits within LOGIT_TOL of the unsharded prefill), 8
              `build_decode_step` steps against `decode_step` (each
              within LOGIT_TOL), the host's enqueue time of the sharded
              and the plain prefill and decode step; then one host-only
              dry-run cell (`launch/dryrun.run_cell` smollm-135m
              train_4k on the fake 16 x 16 mesh, one microbatch) and its
              roofline terms

Phase 2 builds the six kernel libraries at once (one nvcc each).  The
line before the last is a JSON object with one entry per kernel; the last
line is `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, float32
# outside the tensor cores, TF32 on them (dense).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# Floating-point operations the mapspace kernel does per row for the
# spatial template (L = 4, 21 slots, 3 chain pairs): about 330 to score
# (245 arithmetic, 84 compares) and 370 to derive the rows (tile extents,
# slot products, tile and fresh words, instance counts) and check validity
# (the last ~100 in double, counted here at the float32 rate).  The bound
# is set by bytes by an order of magnitude, so the count only has to be of
# the right size.
FLOPS_PER_ROW = 700
CYC_RTOL, EN_RTOL = 1e-5, 1e-4
N_TIMED = 25
L2_FLUSH_BYTES = 256 << 20   # > 5x the H100's 50 MB L2

TASK_BATCH = 64
ARCH_SPACE = dict(num_pes=(64, 256), rf_words=(128, 256),
                  gbuf_words=(32 * 1024, 128 * 1024), bits=32,
                  zero_skip=True)
CHECK_ARCH = "pe256_rf256_gb131072"     # the issue's intra[2] architecture
MAX_MAPPINGS = 20000
# explore runs once per engine: a check and a split, not a median
EXPLORE_RUNS = 1
SEARCH_ROUND, SEARCH_BUDGET = 2, 4
SOURCE = "src/repro_torch/kernels/mapspace_eval/csrc/mapspace_eval.cu"

# Flash attention and serving.  Peaks for the bound: bf16 on the tensor
# cores, float32 outside them (NVIDIA data sheet, H100 SXM, dense).
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: FP32_FLOP_PER_S}
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/" \
    "flash_attention.cu"
# (b, s, h, hkv, d, dtype, causal, route): the serving prefill's shape
# first; bf16 (contiguous, so TMA reads it) takes the tensor-core kernel
# ("wgmma") at every D, float32 the SIMT one ("simt"); `choose_route` must
# name the route given
FLASH_CASES = [(4, 2048, 9, 3, 64, torch.bfloat16, True, "wgmma"),
               (2, 1024, 8, 2, 128, torch.bfloat16, True, "wgmma"),
               (2, 1024, 8, 2, 128, torch.bfloat16, False, "wgmma"),
               (1, 1000, 6, 2, 64, torch.bfloat16, True, "wgmma"),
               (1, 1000, 8, 8, 128, torch.float32, True, "simt"),
               (2, 300, 4, 2, 80, torch.bfloat16, True, "wgmma"),
               (1, 1000, 6, 2, 96, torch.bfloat16, False, "wgmma"),
               (1, 257, 6, 2, 96, torch.float32, True, "simt"),
               # the families phase's prefills: qwen2-vl-2b, granite-moe,
               # whisper-small's decoder, phi3-mini-3.8b, nemotron-4-15b
               (4, 2048, 12, 2, 128, torch.bfloat16, True, "wgmma"),
               (4, 2048, 16, 8, 64, torch.bfloat16, True, "wgmma"),
               (4, 2048, 12, 12, 64, torch.bfloat16, True, "wgmma"),
               (4, 2048, 32, 32, 96, torch.bfloat16, True, "wgmma"),
               (4, 2048, 48, 8, 128, torch.bfloat16, True, "wgmma")]
# phi3-mini-3.8b's prefill layer (bf16 at D 96, two padded panels on the
# tensor cores): timed as the serving prefill's shape is
FLASH_PHI3_TIMED = (4, 2048, 32, 32, 96, torch.bfloat16, True, "wgmma")
# the kernel each route launches, as the profiler names it
FLASH_KERNEL_NAMES = {"wgmma": "flash_fwd_tc_kernel",
                      "simt": "flash_fwd_kernel"}
# kernel against plain version, as tests/test_kernels.py states them:
# float32 sums in another order; bf16 outputs one unit in the last place
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
SERVE_ARCH = "smollm-135m"
SEED = 0
PREFILL_B, PREFILL_S = 4, 2048
# Every engine's load: 8 requests on 4 slots (the second four take slots
# as the first finish).  The engines prefill token by token, as the
# reference does, so the prompt tokens set most of each engine's wall.
ENGINE_BATCH, ENGINE_MAX_LEN, ENGINE_REQUESTS = 4, 256, 8
PROMPT_LENS, NEW_TOKENS, TEACHER_LEN = (8, 32), 16, 128
# Logits of two bf16 forwards that round at different points (the fused
# kernel's bf16 output against the plain path's, 30 residual blocks
# deep), compared in float32: max |a - b| <= LOGIT_TOL * max |b|.  bf16
# keeps 8 significant bits (2**-8 = 0.4% a rounding); 5% of the logits'
# range is about a dozen such steps.
LOGIT_TOL = 5e-2

# SSD scan and the Mamba2 models.
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
# (b, t, h, p, g, n, chunk, what): mamba2-2.7b's prefill layer first; the
# model's A (-1 .. -16) at the models' shapes, the JAX test's elsewhere
SSD_CASES = [(4, 2048, 80, 64, 1, 128, 128, "mamba2-2.7b prefill layer"),
             (1, 2048, 80, 64, 1, 64, 128, "zamba2-2.7b layer"),
             (2, 128, 4, 8, 2, 16, 32, "SSD_SHAPES[0]"),
             (1, 256, 2, 64, 1, 128, 128, "SSD_SHAPES[1]"),
             (2, 64, 4, 16, 4, 32, 16, "SSD_SHAPES[2]"),
             (1, 128, 8, 32, 8, 64, 64, "SSD_SHAPES[3]"),
             (2, 1024, 80, 64, 1, 128, 128, "strided views"),
             (2, 1024, 80, 64, 1, 128, 128, "unit-scale strided views")]
# kernel against plain version, the JAX kernel test's tolerance: float32
# sums in another order.  Every case is also held to it against the plain
# version in float64; "unit-scale strided views" (B and C not scaled, so
# |C B^T| ~ 11 and y up to ~300, with the model's A down to -16) only
# against float64: there the float32 plain version itself misses the
# float64 result by more than the tolerance (PERF.md, PR 13), so its
# difference from the kernel measures the plain version's rounding.
SSD_TOL = 2e-4
SSD_FLOAT64_ONLY = ("unit-scale strided views",)
# edges of the tensor-core route: one chunk (no chunk states), an odd
# number of chunks, two groups of 40 heads
SSD_CASES += [(2, 128, 80, 64, 1, 128, 128, "one chunk"),
              (1, 384, 80, 64, 1, 128, 128, "odd chunks"),
              (2, 512, 80, 64, 2, 128, 128, "G=2, 40 heads a group")]
# each route's kernels, as the profiler names them; one op call launches
# all of its route's kernels once (route "tc" launches no chunk states and
# no state passing when T is one chunk)
SSD_KERNEL_NAMES = {
    "tc": ("ssd_prep_kernel", "ssd_cb_kernel", "ssd_states_kernel",
           "ssd_pass_kernel", "ssd_out_kernel"),
    "simt": ("ssd_fwd_kernel",)}
# the models' instantiations of route "tc" (Q, N, P), for the build report
SSD_TC_SHAPES = ((128, 128, 64), (128, 64, 64))
SSM_ARCH, HYBRID_ARCH = "mamba2-2.7b", "zamba2-2.7b"
# Decode against prefill for the Mamba2 models runs in float32 (the same
# weights, cast): with random weights their bf16 rounding is amplified
# layer over layer, so that mamba2-2.7b's bf16 prefill lies ~40% of the
# logits' range from its float32 prefill through the same kernel (phase 10
# (c) prints it; PERF.md, PR 13), and no bf16 comparison through the full
# depth can check a kernel.  In float32 the chunked scan and the recurrence
# sum in other orders and are amplified alike: ~1e-4 of the range
# measured, 2e-3 allowed; a wrong kernel is off by the range itself.
LOGIT_TOL_F32 = 2e-3
HYBRID_PREFILL_B = 1

# The conv-chain kernel (phase 9b): each model's layer at the prefill's
# [PREFILL_B, PREFILL_S], bf16 as the models run it, mamba2-2.7b's first.
CONV_SOURCE = "src/repro_torch/kernels/ssm_conv/csrc/ssm_conv.cu"
CONV_ARCHS = (SSM_ARCH, HYBRID_ARCH)
# Against the chain on float32 copies of the same inputs: the kernel sums
# the same products in float32 (fused multiply-adds, `__expf`).  Against
# the eager bf16 chain (what the models ran before the kernel): each of
# its K products, K - 1 sums, the bias add and the SiLU rounds to bf16
# (u = 2**-8) by at most u s, s = sum_j |w_j x_j| + |b| the magnitude the
# sums work at, and the SiLU's slope is at most 1.1: to first order
# 1.1 (2 K + 1) u s = 9.9 u s at K = 4; 12 u s allowed, as
# tests/test_torch_ssm_conv_gpu.py allows.
CONV_TOL = 1e-5
CONV_BF16_ULPS = 12
U_BF16 = 2.0 ** -8

# The gate-chain kernel (phase 9d): mamba2-2.7b's layer at [PREFILL_B,
# PREFILL_S] and granite-4.0-h-small's at GRANITE_PREFILL, bf16.  It
# rounds where the eager chain rounds; only its float32 sum of squares
# runs in another order than ATen's, which moves a row's scale by a few
# float32 ulps and so may flip the output's last rounding: one bf16 ulp
# of the eager output allowed, as tests/test_torch_ssm_gate_gpu.py allows.
GATE_SOURCE = "src/repro_torch/kernels/ssm_gate/csrc/ssm_gate.cu"
GATE_KERNEL_NAME = "ssm_gate_kernel"
# phase 9e: the residual stream's RMS norm at one call shape of each of the
# benchmark's three cells (phi3-mini-3.8b's conv-2k, mamba2-2.7b's and
# granite-4.0-h-small's code-4k), bf16
NORM_SOURCE = "src/repro_torch/kernels/rms_norm/csrc/rms_norm.cu"
NORM_KERNEL_NAME = "rms_norm_kernel"
NORM_CASES = ((9, 896, 3072, "phi3-mini-3.8b"), (4, 2048, 2560, SSM_ARCH),
              (2, 4096, 4096, "granite-4.0-h-small"))
NORM_EPS = 1e-5

# Granite 4.0-H Small (phase 9c), as the benchmark runs it: its config,
# its attention layer's flash call at the benchmark's call of 8,192
# tokens, and that call's expert products.
GRANITE_CONFIG = "portbench/configs/granite-4.0-h-small.json"
GRANITE_FLASH = (2, 4096, 32, 8, 128, torch.bfloat16, True, "wgmma")
GRANITE_SCALE = 1 / 128          # attention_multiplier, not 128 ** -0.5
GRANITE_PREFILL = (2, 4096)
GRANITE_NAME = "granite-4.0-h-small"
# The grouped GEMM against the loop over experts on float32 copies: bf16
# inputs and output, float32 sums (4,096 or 768 products a sum); max |err|
# <= GROUPED_TOL * max |plain|, as tests/test_torch_families_gpu.py allows.
GROUPED_TOL = 2e-2
GROUPED_SOURCE = "src/repro_torch/kernels/moe_grouped/kernel.py"
# the grouped GEMM's kernel as the profiler names it (CUTLASS's sm90
# grouped GEMM inside PyTorch); `portbench/metrics/moe_roofline.prefill.py`
# finds it by the same name
GROUPED_KERNEL_NAME = "GroupProblemShape"

# The families phase: every configuration the earlier phases do not
# serve, at full width and depth (random weights from a CUDA generator
# seeded with SEED), in the order run, with its flash launches per
# prefill, every one on the tensor-core route (bf16 takes it at every
# head dim, phi3-mini-3.8b's D 96 too): one per causal self-attention of
# equal q/k and v head dims, as `sdpa` decides; whisper's encoder
# (non-causal) and cross-attention (Sq != Sk) and MLA (192/128 and 96/64
# head dims) take the plain path, as in the reference.
FAMILY_FLASH = {"granite-moe-1b-a400m": 24, "qwen2-vl-2b": 28,
                "whisper-small": 12, "minicpm3-4b": 0,
                "deepseek-v2-lite-16b": 0, "phi3-mini-3.8b": 32,
                "nemotron-4-15b": 32}
# The two MLA engines (the slowest: ~3.4 and ~4.6 tokens/s) answer the
# first 4 of the serve phase's 8 requests, which keeps the smoke near
# its time budget now that phase 13 serves seven configurations.
FAMILY_ENGINE_REQUESTS = {"minicpm3-4b": 4, "deepseek-v2-lite-16b": 4}
# qwen2-vl's prefill from embeddings: text, one image of 32 x 48 merged
# patches (Qwen2-VL's M-RoPE: t, h, w offset by the text before it), text
VLM_TEXT_BEFORE, VLM_GRID = 64, (32, 48)

# The DSE service: TRIM's training-accelerator search over one smollm-135m
# training block at its published width, lowered as
# examples/dse_modern_lm.py does (24 FW/BW/WG matmuls a block + 3 of the
# head).  Query A: exhaustive, fused, from SERVICE_CLIENTS clients at once;
# query B: anneal at budget SEARCH_BUDGET, per-arch, seed 1.  A copy of A
# with goal "latency" (other cache keys) gets a deadline of
# CANCEL_FRACTION of A's wall.
SERVICE_SHAPE = ("train_4x2048", 2048, 4, "train")
SERVICE_CLIENTS = 4
CANCEL_FRACTION = 0.3


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    say("device", f"{torch.cuda.get_device_name(0)} capability {cap} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability (9, 0), got {cap}")
    return smi


def build_phase() -> None:
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.mapspace_eval import kernel
    from repro_torch.kernels.rms_norm import kernel as norm
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.ssm_conv import kernel as conv
    from repro_torch.kernels.ssm_gate import kernel as gate
    t0 = time.perf_counter()
    libs = build_all([kernel.LIBRARY, flash.LIBRARY, ssd.LIBRARY,
                      conv.LIBRARY, gate.LIBRARY, norm.LIBRARY])
    dt = time.perf_counter() - t0
    for lib in libs:
        ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
        say("build", f"{lib.relative_to(ROOT)}; " + " | ".join(ptxas))
    say("build", f"{len(libs)} libraries in {dt:.2f} s (built at once)")
    tc_build_report(libs[1], flash.LIBRARY.load())
    ssd_build_report(libs[2], ssd.LIBRARY.load())


def tc_build_report(lib: Path, loaded) -> None:
    """The tensor-core flash kernel's ptxas report per head dim, its dynamic
    shared memory, and each instantiation's count of HGMMA (wgmma) and
    UTMALDG (TMA load) instructions in SASS; fails on a spill, or if
    either count is 0 in any instantiation."""
    from repro_torch.kernels.flash_attention.kernel import SUPPORTED_D
    name = FLASH_KERNEL_NAMES["wgmma"]
    entries = {k: v for k, v in _ptxas_entries(lib).items() if name in k}
    for d in SUPPORTED_D:
        lines = [v for k, v in entries.items() if f"ILi{d}E" in k]
        if not lines:
            raise RuntimeError(f"no ptxas report for the D={d} tensor-core "
                               f"kernel")
        say("build", f"{name}<{d}>: " + " | ".join(lines[0])
            + f" | {loaded.flash_attention_tc_smem_bytes(d)} bytes of "
            f"dynamic shared memory")
        spills = [int(n) for ln in lines[0]
                  for n in re.findall(r"(\d+) bytes spill", ln)]
        if not spills or any(spills):
            raise RuntimeError(f"{name}<{d}> spills registers or has no "
                               f"spill report: {lines[0]}")
    fns = _sass(lib)
    if fns is None:
        say("build", "no cuobjdump in the toolkit: SASS not checked")
        return
    counts = {}
    for d in SUPPORTED_D:
        bodies = [body for f, body in fns.items()
                  if name in f and f"ILi{d}E" in f]
        counts[d] = {op: sum(_count(body, op) for body in bodies)
                     for op in ("HGMMA", "UTMALDG")}
    say("build", f"{lib.name} SASS, {name} HGMMA / UTMALDG instructions "
        f"by head dim: " + ", ".join(f"D={d} {n['HGMMA']} / "
                                     f"{n['UTMALDG']}"
                                     for d, n in counts.items()))
    if not all(n["HGMMA"] and n["UTMALDG"] for n in counts.values()):
        raise RuntimeError(f"a tensor-core flash instantiation issues no "
                           f"wgmma or no TMA load: {counts}")


def _ptxas_entries(lib: Path) -> dict:
    """{entry-function line: its ptxas register and spill lines} from a
    library's build log."""
    entries, cur = {}, None
    for ln in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in ln:
            cur = ln
            entries[cur] = []
        elif cur is not None and ("registers" in ln or "spill" in ln):
            entries[cur].append(ln.strip())
    return entries


def _sass(lib: Path):
    """-> {kernel function: its SASS} of a library, or None where the
    toolkit has no cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME
    cuobjdump = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    if not cuobjdump.exists():
        return None
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return dict(re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass,
                           re.S))


def _count(text: str, op: str) -> int:
    return len(re.findall(rf"\b{op}\b", text))


def ssd_build_report(lib: Path, loaded) -> None:
    """Route "tc"'s sub-kernels at the models' shapes: ptxas registers and
    spills, dynamic shared memory; the HGMMA (wgmma) instructions in SASS
    of each of its three product kernels.  Fails on a spill, or if one of
    them has none."""
    entries = _ptxas_entries(lib)
    dyn = {"ssd_cb_kernel": 1, "ssd_states_kernel": 2, "ssd_out_kernel": 4}
    for q, n, p in SSD_TC_SHAPES:
        tags = {"ssd_prep_kernel": f"ILi{q}EE", "ssd_pass_kernel": "",
                "ssd_cb_kernel": f"ILi{q}ELi{n}EE",
                "ssd_states_kernel": f"ILi{q}ELi{n}ELi{p}EE",
                "ssd_out_kernel": f"ILi{q}ELi{n}ELi{p}EE"}
        for name, tag in tags.items():
            lines = [v for k, v in entries.items() if name in k and tag in k]
            if not lines:
                raise RuntimeError(f"no ptxas report for {name} {tag}")
            smem = (f" | {loaded.ssd_tc_smem_bytes(dyn[name], q, n, p)} "
                    f"bytes of dynamic shared memory" if name in dyn else "")
            say("build", f"{name} (Q={q}, N={n}, P={p}): "
                + " | ".join(lines[0]) + smem)
            spills = [int(v) for ln in lines[0]
                      for v in re.findall(r"(\d+) bytes spill", ln)]
            if not spills or any(spills):
                raise RuntimeError(f"{name} spills registers or has no "
                                   f"spill report: {lines[0]}")
    fns = _sass(lib)
    if fns is None:
        say("build", "no cuobjdump in the toolkit: SASS not checked")
        return
    for name in dyn:
        counts = [_count(body, "HGMMA") for f, body in fns.items()
                  if name in f]
        say("build", f"{name}: HGMMA instructions in SASS per "
            f"instantiation: {counts}")
        if not counts or not all(counts):
            raise RuntimeError(f"{name} issues no wgmma in some "
                               f"instantiation: {counts}")


def launch_counts() -> dict:
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.mapspace_eval import kernel
    from repro_torch.kernels.moe_grouped import kernel as grouped
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.ssm_conv import kernel as conv
    from repro_torch.kernels.rms_norm import kernel as norm
    from repro_torch.kernels.ssm_gate import kernel as gate
    # the conv's, the gate's and the norm's counters are all named "fused"
    # there
    return {**kernel.LAUNCHES, **flash.LAUNCHES, **ssd.LAUNCHES,
            **conv.LAUNCHES, **grouped.LAUNCHES,
            "gate": gate.LAUNCHES["fused"], "norm": norm.LAUNCHES["fused"]}


def reset_launch_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.mapspace_eval import kernel
    from repro_torch.kernels.moe_grouped import kernel as grouped
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.ssm_conv import kernel as conv
    from repro_torch.kernels.rms_norm import kernel as norm
    from repro_torch.kernels.ssm_gate import kernel as gate
    kernel.reset_launches()
    flash.reset_launches()
    ssd.reset_launches()
    conv.reset_launches()
    gate.reset_launches()
    norm.reset_launches()
    grouped.reset_launches()


def device_times_ms(fn, n: int = N_TIMED, cold: bool = False):
    """Median device time of one `fn()` call over `n` calls, from a CUDA
    event pair around each.  Each call is enqueued while the card spins in
    `torch.cuda._sleep`, so its launches run back to back and the events
    time the device, not the host's launch rate (one call at a time: the
    plain version's ~370 launches a call nearly fill the launch queue).
    `cold`: before each call a 256 MB buffer is read, so the inputs come
    from HBM and not from the L2 where the previous call left them."""
    flush = (torch.zeros(L2_FLUSH_BYTES // 4, device="cuda") if cold
             else None)
    for _ in range(3):                                  # warm-up
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin = int(2e9 * 2 * (time.perf_counter() - t0)) + 1000  # <= 2 GHz
    times = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        if flush is not None:
            flush.sum()
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_times_ms(fn, n: int = 5):
    """Median host-clock time of one `fn()` call from an idle device to the
    end of its work (synchronised), and of the part until `fn` returns
    (the time the host takes to enqueue it): where the two are close, the
    host's launch rate and not the device sets the call's latency."""
    fn()
    walls, enqueues = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        enqueues.append((t1 - t0) * 1e3)
    return statistics.median(walls), statistics.median(enqueues)


def back_to_back_ms(fn, n: int = N_TIMED) -> float:
    """Device time of one `fn()` when `n` calls run back to back: one
    CUDA event pair around all of them, enqueued behind a spin kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(int(2e8))                          # ~0.1 s
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_busy(fn):
    """Run `fn()` under torch.profiler (CUPTI) -> (wall s, device busy s,
    device activities, their summed s, {activity name: (summed s,
    count)}): busy is the union of the kernel and copy intervals, so
    overlapping work is not counted twice."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:                                  # microseconds
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name = {}
    for e in events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + (e.time_range.end - e.time_range.start) / 1e6,
                           n + 1)
    return (wall, busy / 1e6, len(spans),
            sum(e - s for s, e in spans) / 1e6, by_name)


def top_activities(by_name: dict, n: int = 5) -> str:
    """The `n` device activities that took longest in all, as 'ms (count)
    name' entries."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return "; ".join(f"{t * 1e3:.2f} ms ({k}x) {name[:70]}"
                     for name, (t, k) in top)


def bound_ms(tensors):
    """The least time the card could take: the bytes the function needs at
    HBM bandwidth, or its float operations at the float32 peak, whichever
    is larger.  It reads each input once (`factors` and `rank` int32,
    `store` bool, the job records, the row offsets) and writes cycles,
    energy (float32) and validity (bool) once."""
    n_rows = tensors[0].shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + 9 * n_rows
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_ROW * n_rows / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, out, ref):
    """Kernel (cycles, energy, valid) against the plain version -> (max abs
    err, max rel err); validity must be equal."""
    (c, e, v), (cr, er, vr) = out, ref
    torch.cuda.synchronize()
    if not (torch.isfinite(c).all() and torch.isfinite(e).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    torch.testing.assert_close(c, cr, rtol=CYC_RTOL, atol=0)
    torch.testing.assert_close(e, er, rtol=EN_RTOL, atol=0)
    if not torch.equal(v, vr):
        raise RuntimeError(f"{name}: validity differs from the plain "
                           f"version in {int((v != vr).sum())} rows")
    rel = max(float(((c - cr).abs() / cr.abs()).max()),
              float(((e - er).abs() / er.abs()).max()))
    return max(float((c - cr).abs().max()), float((e - er).abs().max())), rel


def _multi_inputs(parts, dev, rows=None):
    """[(HwStatic, PackedMapspace)] -> the multi-job kernel's tensors, the
    first `rows` rows of each mapspace (all by default)."""
    from repro_torch.kernels.mapspace_eval import ops
    pms = [p for _, p in parts]
    offsets = np.cumsum([0] + [len(p.factors[:rows]) for p in pms])
    host = [np.concatenate([getattr(p, k)[:rows] for p in pms])
            for k in ("factors", "rank", "store")]
    host += [np.stack([ops.job_record(st) for st, _ in parts]),
             offsets.astype(np.int32)]
    return [torch.from_numpy(a).to(dev) for a in host]


def kernel_phase(archs, workload, dev):
    """Both kernels against `ref.py` on the card -> per-kernel records."""
    from repro_torch.core import MapperConfig, build_packed_mapspace
    from repro_torch.kernels.mapspace_eval import kernel, ops, ref
    cfg = MapperConfig(max_mappings=MAX_MAPPINGS, seed=0,
                       enable_bypass=False)
    packed = {hw.name: build_packed_mapspace(workload, hw, cfg)
              for hw in archs}
    pm = packed[CHECK_ARCH]
    layout = ops.layout_of(pm.static)
    on = lambda *a: [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in a]
    single = on(pm.factors, pm.rank, pm.store, ops.job_record(pm.static))
    parts = [(p.static, p) for p in packed.values()]
    smallest = min(packed.values(), key=lambda p: (p.static.fanout,
                                                   p.static.sizes)).static
    cases = [
        ("mapspace_eval_single", "src/repro/kernels/mapspace_eval/"
         "kernel.py:133", single, on(*(a[:37] for a in (
             pm.factors, pm.rank, pm.store)), ops.job_record(pm.static)),
         on(pm.factors, pm.rank, pm.store, ops.job_record(smallest)),
         lambda t: kernel.mapspace_eval_fwd(*t, layout=layout),
         lambda t: ref.score_ref(*t, layout=layout)),
        ("mapspace_eval_multi", "src/repro/kernels/mapspace_eval/"
         "kernel.py:163", _multi_inputs(parts, dev),
         _multi_inputs(parts, dev, rows=37),
         _multi_inputs([(smallest, p) for p in packed.values()], dev),
         lambda t: kernel.mapspace_eval_multi_fwd(*t, layout=layout),
         lambda t: ref.score_multi_ref(*t, layout=layout)),
    ]
    records = {}
    for name, replaces, tensors, ragged, small, run, plain in cases:
        err, rel = compare(name, run(tensors), plain(tensors))
        compare(name + " (37 rows a job)", run(ragged), plain(ragged))
        out = run(small)
        compare(name + " (as the smallest architecture)", out, plain(small))
        n_invalid = int((~out[2]).sum())
        if not n_invalid:
            raise RuntimeError(f"{name}: no invalid row to check validity")
        rows, n_jobs = tensors[0].shape[0], tensors[3].reshape(
            -1, ref.REC_DOUBLES).shape[0]
        ms = device_times_ms(lambda: run(tensors), cold=True)
        warm_ms = device_times_ms(lambda: run(tensors))
        plain_ms = device_times_ms(lambda: plain(tensors), cold=True)
        plain_warm_ms = device_times_ms(lambda: plain(tensors))
        b_ms, b_by = bound_ms(tensors)
        cupti = [device_busy(lambda: [f(tensors) for _ in range(N_TIMED)])
                 for f in (run, plain)]
        say("kernels", f"{name}: {rows} rows, {n_jobs} job(s); max rel err "
            f"{rel:.3g} (max abs {err:.3g}), validity equal; 37 rows a job "
            f"ok; as the smallest architecture {n_invalid} invalid rows, "
            f"validity equal; events, cold L2: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; warm L2: kernel {warm_ms:.4f} ms, plain "
            f"{plain_warm_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}); "
            f"profiler, warm, device activity per call: kernel "
            f"{cupti[0][3] / N_TIMED * 1e3:.4f} ms in "
            f"{cupti[0][2] / N_TIMED:.0f} op(s), plain "
            f"{cupti[1][3] / N_TIMED * 1e3:.4f} ms in "
            f"{cupti[1][2] / N_TIMED:.0f} ops")
        records[name] = dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            warm_ms=warm_ms, plain_warm_ms=plain_warm_ms)
    say("kernels", f"intra[2] mapspaces, no bypass: "
        + ", ".join(f"{k} {len(p)}" for k, p in packed.items()))
    return records


def _winners(result):
    return [(a.hardware.name,
             [(w.mapping.factors, w.mapping.orders, w.mapping.bypass)
              for w in a.per_workload]) for a in result.all_archs]


def engine_turns(run, n: int = 3):
    """`run(backend)` -> result, traced: n runs of each engine in turns
    (cuda, torch, cuda, ...) -> {engine: (median wall s, [walls], span
    times of the median run, counters of it, launches of it, result)}."""
    from repro_torch.obs import Tracer, activate
    runs = {"cuda": [], "torch": []}
    for _ in range(n):
        for engine in ("cuda", "torch"):
            tr = Tracer()
            reset_launch_counts()
            t0 = time.perf_counter()
            with activate(tr):
                out = run(engine)
            wall = time.perf_counter() - t0
            runs[engine].append((wall, tr.span_times(),
                                 tr.metrics.snapshot()["counters"],
                                 launch_counts(), out))
    summary = {}
    for engine, rs in runs.items():
        walls = [r[0] for r in rs]
        mid = sorted(rs, key=lambda r: r[0])[len(rs) // 2]
        summary[engine] = (statistics.median(walls), walls) + mid[1:]
    return summary


def _split(spans: dict, names, wall: float, outer) -> str:
    """'name s' for each (name, span) and the rest of `wall` outside the
    spans `outer`."""
    rest = wall - sum(spans.get(k, 0.0) for k in outer)
    return ", ".join([f"{k} {spans.get(v, 0.0):.3f} s" for k, v in names]
                     + [f"rest {rest:.3f} s"])


def _walls(walls) -> str:
    return "[" + ", ".join(f"{w:.3f}" for w in walls) + "]"


def _phases(times: dict) -> str:
    """'phase s' for each driver phase in `times`, in pipeline order."""
    from repro_torch.obs import DRIVER_PHASES
    return ", ".join(f"{k} {times[k]:.3f}" for k in DRIVER_PHASES
                     if k in times)


def explore_phase(task, archs, dev):
    """Algorithm 1 on the card, each engine EXPLORE_RUNS times in turns
    -> launches of the kernel engine's median run."""
    from repro_torch.core import MapperConfig, explore
    cfg = MapperConfig(max_mappings=MAX_MAPPINGS, seed=0)
    res = engine_turns(lambda engine: explore(
        task, archs, goal="edp", cfg=cfg, backend=engine, device=dev),
        n=EXPLORE_RUNS)
    (wall, walls, sp, m, launches, out) = res["cuda"]
    (ref_wall, ref_walls, ref_sp, _, ref_launches, ref) = res["torch"]
    if launches["single"] == 0:
        raise RuntimeError("explore launched no single-architecture kernel")
    if ref_launches["single"] or ref_launches["multi"]:
        raise RuntimeError("the oracle engine launched the kernel")
    common = (("mapspace build", "pack"), ("mapspace validate", "validate"))
    say("explore", f"backend=cuda median {wall:.2f} s of {_walls(walls)}, "
        f"launches {launches}, rows kernel "
        f"{m.get('backend.rows.kernel', 0):.0f} / oracle "
        f"{m.get('backend.rows.torch', 0):.0f}; split: " + _split(
            sp, common + (
                ("scoring", "backend.cuda"), ("copy to device", "kernel.h2d"),
                ("kernel", "kernel.run"), ("copy back", "kernel.d2h"),
                ("oracle (bypass rows, incl. copies)", "batch_eval.scores")),
            wall, ("pack", "validate", "backend.cuda")))
    say("explore", f"backend=torch median {ref_wall:.2f} s of "
        f"{_walls(ref_walls)}; split: " + _split(
            ref_sp, common + (("scoring", "backend.torch"),), ref_wall,
            ("pack", "validate", "backend.torch")))
    for engine, spans in (("cuda", sp), ("torch", ref_sp)):
        say("explore", f"backend={engine} median run's driver phases (s): "
            + _phases(spans))
    for a in out.all_archs:
        n = a.network
        if not all(map(lambda v: v > 0 and v < float("inf"),
                       (n.cycles, n.energy_pj, n.edp))):
            raise RuntimeError(f"{a.hardware.name}: bad network estimate")
    if out.best.hardware.name != ref.best.hardware.name \
            or _winners(out) != _winners(ref):
        raise RuntimeError("explore winners differ between the kernel "
                           "engine and the oracle")
    wall, busy, n_ops, _, _ = device_busy(lambda: explore(
        task, archs[:2], goal="edp", cfg=cfg, device=dev))
    say("explore", f"profiled run over {archs[0].name}, {archs[1].name}: "
        f"{wall:.2f} s wall, device busy {busy:.3f} s "
        f"({100 * busy / wall:.2f}%, idle {100 - 100 * busy / wall:.2f}%) "
        f"in {n_ops} device ops")
    say("explore", f"best {out.best.hardware.name} edp "
        f"{out.best.network.edp:.6g} cycles {out.best.network.cycles:.6g}; "
        f"{len(out.all_archs)} archs x {len(out.best.per_workload)} "
        f"workloads: winners equal the oracle's")
    return launches["single"]


def fused_phase(workloads, archs, dev):
    """`fused_best` over every (arch, distinct workload) pair, each engine
    three times in turns -> launches of the kernel engine's median run."""
    from repro_torch.core import MapperConfig, build_packed_mapspace
    from repro_torch.search import MapspaceJob, fused_best
    cfg = MapperConfig(max_mappings=MAX_MAPPINGS, seed=0,
                       enable_bypass=False)
    t0 = time.perf_counter()
    jobs = [MapspaceJob(tag=(hw.name, wl.name), hw=hw, workload=wl,
                        packed=build_packed_mapspace(wl, hw, cfg))
            for hw in archs for wl in workloads]
    build_s = time.perf_counter() - t0
    rows = sum(j.n_rows() for j in jobs)
    res = engine_turns(lambda engine: fused_best(jobs, "edp", device=dev,
                                                 backend=engine))
    (wall, walls, sp, _, launches, out) = res["cuda"]
    (ref_wall, ref_walls, ref_sp, _, _, ref) = res["torch"]
    if launches["multi"] == 0:
        raise RuntimeError("fused_best launched no multi-architecture "
                           "kernel")
    copies = (("copy to device", "kernel.h2d"), ("kernel", "kernel.run"),
              ("copy back", "kernel.d2h"))
    say("fused", f"backend=cuda median {wall:.3f} s of {_walls(walls)}; "
        f"split (rest: grouping, records, concatenation, scores, argmin): "
        + _split(sp, (("kernel groups", "fused.kernel-group"),) + copies,
                 wall, [v for _, v in copies]))
    say("fused", f"backend=torch median {ref_wall:.3f} s of "
        f"{_walls(ref_walls)}; split: " + _split(
            ref_sp, (("groups", "fused.torch-group"),), ref_wall,
            ("fused.torch-group",)))
    if [(b.tag, b.index) for b in out] != [(b.tag, b.index) for b in ref]:
        raise RuntimeError("fused_best winners differ between the kernel "
                           "and the oracle")
    say("fused", f"{len(jobs)} jobs, {rows} rows (built in {build_s:.2f} s); "
        f"backend=cuda {wall:.3f} s, launches {launches}; backend=torch "
        f"{ref_wall:.3f} s; winners equal the oracle's")
    return launches["multi"]


def _report_key(report):
    """What two equal search runs share: best coordinates and value, the
    best architecture's mappings, history rows and the frontier."""
    return (report.best_coords, report.goal_value(),
            [(w.mapping.factors, w.mapping.orders, w.mapping.bypass)
             for w in report.best.per_workload],
            [(r["step"], r["coords"], r["value"], r["objectives"],
              r["feasible"]) for r in report.history],
            sorted(report.pareto.values()))


def search_phase(task, archs, dev):
    """`run_search` on the card: (a) fused exhaustive streamed on both
    engines, (b) synchronous, (c) anneal per-arch with a disk cache, cold
    and warm -> (single-architecture kernel launches in (c) cold,
    multi-architecture kernel launches in (a) on "cuda")."""
    import tempfile
    from repro_torch.core import MapperConfig
    from repro_torch.search import run_search
    cfg = MapperConfig(max_mappings=MAX_MAPPINGS, seed=0,
                       enable_bypass=False)

    def run(engine, **kw):
        reset_launch_counts()
        t0 = time.perf_counter()
        report = run_search(task, archs, goal="edp", cfg=cfg, trace=True,
                            backend=engine, device=dev, **kw)
        return report, time.perf_counter() - t0, launch_counts()

    def line(report, wall, launches):
        return (f"{wall:.3f} s wall, {report.n_evaluated} archs, "
                f"{report.n_enumerations} mapspaces scored, "
                f"{report.n_cache_hits} cache hits, launches "
                f"{{single: {launches['single']}, multi: "
                f"{launches['multi']}}}; phases (s): "
                + _phases(report.phase_times))

    t_phase = time.perf_counter()
    streamed = {e: run(e, strategy="exhaustive", batching="fused",
                       round_size=SEARCH_ROUND, overlap=True)
                for e in ("cuda", "torch")}
    for engine, (report, wall, launches) in streamed.items():
        if not report.overlap:
            raise RuntimeError("the exhaustive fused search did not stream")
        say("search", f"(a) backend={engine} streamed, {SEARCH_ROUND} "
            f"archs a round: " + line(report, wall, launches))
    (got, _, launches), (want, _, ref_launches) = (streamed["cuda"],
                                                   streamed["torch"])
    if launches["multi"] == 0:
        raise RuntimeError("the fused search launched no "
                           "multi-architecture kernel")
    if ref_launches["single"] or ref_launches["multi"]:
        raise RuntimeError("the oracle engine launched the kernel")
    if _report_key(got) != _report_key(want):
        raise RuntimeError("the fused search differs between the kernel "
                           "and the oracle")
    say("search", f"(a) best {got.best.hardware.name} edp "
        f"{got.goal_value():.6g}; frontier {len(got.pareto)} archs; both "
        f"engines give the same best, mappings, history and frontier")
    sync, wall, sync_launches = run("cuda", strategy="exhaustive",
                                    batching="fused",
                                    round_size=SEARCH_ROUND, overlap=False)
    if sync.overlap or _report_key(sync) != _report_key(got):
        raise RuntimeError("the synchronous search differs from the "
                           "streamed one")
    say("search", f"(b) backend=cuda synchronous: "
        + line(sync, wall, sync_launches) + "; equal to (a)")
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(strategy="anneal", budget=SEARCH_BUDGET, seed=0,
                  batching="per-arch", round_size=SEARCH_ROUND, cache=tmp)
        cold, cold_wall, cold_launches = run("cuda", **kw)
        warm, warm_wall, warm_launches = run("cuda", **kw)
    if cold_launches["single"] == 0:
        raise RuntimeError("the per-arch search launched no "
                           "single-architecture kernel")
    if warm.n_cache_misses or warm.n_cache_hits != cold.n_cache_misses \
            or _report_key(warm) != _report_key(cold):
        raise RuntimeError(f"the warm search is not all hits with the "
                           f"same report: {warm.n_cache_hits} hits, "
                           f"{warm.n_cache_misses} misses")
    m = warm.manifest
    if m.device_name != torch.cuda.get_device_name(0) \
            or m.compute_capability != "9.0":
        raise RuntimeError(f"the manifest names {m.device_name} "
                           f"{m.compute_capability}")
    say("search", f"(c) anneal, budget {SEARCH_BUDGET}, per-arch, disk "
        f"cache: cold " + line(cold, cold_wall, cold_launches))
    say("search", f"(c) warm " + line(warm, warm_wall, warm_launches)
        + f"; all hits, same report; manifest {m.run_id}: {m.device}, "
        f"{m.device_name}, capability {m.compute_capability}")
    say("search", f"phase {time.perf_counter() - t_phase:.1f} s")
    return cold_launches["single"], launches["multi"]


def _partial_ok(report, n_archs: int) -> None:
    """A cancelled search's report must be a consistent partial one: some
    but not all architectures evaluated, each once in the history, the
    best among them at the history's best feasible value, and every
    frontier point one of them."""
    rows = report.history
    coords = [r["coords"] for r in rows]
    if not report.cancelled or not 1 <= report.n_evaluated < n_archs:
        raise RuntimeError(f"the deadline did not cut the search: "
                           f"cancelled={report.cancelled}, "
                           f"{report.n_evaluated} of {n_archs} archs")
    if len(set(coords)) != len(coords) or len(rows) != report.n_evaluated:
        raise RuntimeError("the partial history does not match the "
                           "evaluated count")
    feasible = [r["value"] for r in rows if r["feasible"]]
    if report.best_coords not in coords \
            or report.goal_value() != min(feasible):
        raise RuntimeError("the partial best is not the history's best")
    archs = {r["arch"] for r in rows}
    objectives = {tuple(r["objectives"]) for r in rows if r["objectives"]}
    for p in report.pareto.points():
        if p.key not in archs or tuple(p.values) not in objectives:
            raise RuntimeError(f"frontier point {p.key} was never "
                               f"evaluated")


def service_phase(archs, dev):
    """The DSE service on the card -> (single-architecture kernel
    launches, multi-architecture kernel launches) while it served."""
    import tempfile
    import threading
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import MapperConfig, build_packed_mapspace
    from repro_torch.core.explorer import _workload_key
    from repro_torch.core.task_analyst import TaskWorkloads
    from repro_torch.core.lower_lm import lower_block
    from repro_torch.obs import Tracer, activate
    from repro_torch.search import MapspaceJob, fused_best, run_search
    from repro_torch.search import batch_frontier as bf
    from repro_torch.serve import DSEService, SearchQuery
    t_phase = time.perf_counter()
    low = lower_block(get_config(SERVE_ARCH), ShapeSpec(*SERVICE_SHAPE))
    task = TaskWorkloads(intra=low.workloads + low.tail, preproc=[],
                         activations=[])
    distinct = list({_workload_key(w): w for w in task.intra}.values())
    cfg = MapperConfig(max_mappings=MAX_MAPPINGS, seed=0,
                       enable_bypass=False)
    query_a = dict(task=task, space=archs, goal="edp", cfg=cfg,
                   strategy="exhaustive", batching="fused",
                   round_size=SEARCH_ROUND, backend="cuda")
    say("service", f"{SERVE_ARCH} training block at [{SERVICE_SHAPE[2]}, "
        f"{SERVICE_SHAPE[1]}]: {len(task.intra)} workloads "
        f"({len(low.workloads)} a block x {low.repeat} layers + "
        f"{len(low.tail)} of the head, {len(distinct)} distinct), "
        f"{low.total_macs():.4g} MACs a step; {len(archs)} archs")
    reset_launch_counts()
    tr = Tracer()
    with tempfile.TemporaryDirectory() as tmp, \
            DSEService(workers=2, cache=tmp, device=dev, tracer=tr) as svc:
        barrier = threading.Barrier(SERVICE_CLIENTS)
        tickets, errors = [None] * SERVICE_CLIENTS, []

        def client(i):
            try:
                barrier.wait(timeout=60)
                tickets[i] = svc.submit(SearchQuery(**query_a))
            except BaseException as exc:     # raised below
                errors.append(exc)

        def serve_a_and_b():
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(SERVICE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            if errors or any(t is None for t in tickets):
                raise RuntimeError(f"a client's submit failed: {errors}")
            tickets.append(svc.submit(SearchQuery(
                task=task, space=archs, goal="edp", cfg=cfg,
                strategy="anneal", budget=SEARCH_BUDGET, seed=1,
                batching="per-arch", round_size=SEARCH_ROUND,
                backend="cuda")))
            tickets[0].result(timeout=600)

        t0 = time.perf_counter()
        wall_a, busy, n_ops, _, _ = device_busy(serve_a_and_b)
        a_tickets, tb = tickets[:SERVICE_CLIENTS], tickets[-1]
        rep_a, rep_b = a_tickets[0].result(), tb.result(timeout=600)
        pair_wall = time.perf_counter() - t0
        snap = svc.snapshot()
        if (snap["admitted"], snap["coalesced"]) != (2, SERVICE_CLIENTS - 1):
            raise RuntimeError(f"the {SERVICE_CLIENTS} clients did not "
                               f"coalesce onto one job: {snap}")
        if len({t.job for t in a_tickets}) != 1 or tb.job is a_tickets[0].job:
            raise RuntimeError("query A's tickets are not on one job")
        streams = [[e.to_dict() for e in t.drain(timeout=60)]
                   for t in a_tickets]
        if any(st != streams[0] for st in streams[1:]):
            raise RuntimeError("the coalesced clients' event streams "
                               "differ")
        kinds = [e["kind"] for e in streams[0]]
        say("service", f"A ({SERVICE_CLIENTS} clients) and B together: "
            f"{pair_wall:.3f} s; A {rep_a.wall_time_s:.3f} s wall, "
            f"{rep_a.n_evaluated} archs, {rep_a.n_enumerations} mapspaces "
            f"scored; B {rep_b.wall_time_s:.3f} s wall, "
            f"{rep_b.n_evaluated} archs; stats {snap}; {len(kinds)} events "
            f"a client ({kinds.count('job-coalesced')} job-coalesced), "
            f"all {SERVICE_CLIENTS} streams equal")
        say("service", f"device over job A's {wall_a:.3f} s (B shares the "
            f"card): busy {busy:.3f} s ({100 * busy / wall_a:.2f}%, idle "
            f"{100 - 100 * busy / wall_a:.2f}%) in {n_ops} device ops")

        t0 = time.perf_counter()
        again = svc.submit(SearchQuery(**query_a))
        warm = again.result(timeout=600)
        warm_wall = time.perf_counter() - t0
        if again.coalesced or again.job is a_tickets[0].job \
                or svc.snapshot()["admitted"] != 3:
            raise RuntimeError("the resubmit of A was not a new job")
        if warm.n_cache_misses or warm.n_enumerations \
                or not warm.n_cache_hits:
            raise RuntimeError(f"the resubmit of A is not all hits: "
                               f"{warm.n_cache_hits} hits, "
                               f"{warm.n_cache_misses} misses")
        if _report_key(warm) != _report_key(rep_a) \
                or warm.hypervolume_curve() != rep_a.hypervolume_curve():
            raise RuntimeError("the warm resubmit of A differs from A")
        say("service", f"A resubmitted after it retired: a new job, "
            f"{warm_wall:.3f} s, {warm.n_cache_hits} cache hits and no "
            f"miss, the same report")

        deadline = CANCEL_FRACTION * rep_a.wall_time_s
        tc_ = svc.submit(SearchQuery(**{**query_a, "goal": "latency"}),
                         timeout_s=deadline)
        cut = tc_.result(timeout=600)
        if tc_.status != "cancelled" or tc_.job.cancel_reason != "deadline":
            raise RuntimeError(f"the deadline did not cancel the job: "
                               f"{tc_.status}, {tc_.job.cancel_reason}")
        _partial_ok(cut, len(archs))
        say("service", f"deadline {deadline:.3f} s ({CANCEL_FRACTION} of "
            f"A's wall): cancelled after {cut.wall_time_s:.3f} s with "
            f"{cut.n_evaluated} of {len(archs)} archs, frontier "
            f"{len(cut.pareto)}: consistent")
        card = torch.cuda.get_device_name(0)
        for name, r in (("A", rep_a), ("B", rep_b), ("A again", warm),
                        ("cancelled", cut)):
            m = r.manifest
            if m is None or m.device_name != card \
                    or m.compute_capability != "9.0":
                raise RuntimeError(f"job {name}'s manifest names "
                                   f"{m and m.device_name}")
        final = svc.snapshot()
    launches = launch_counts()
    if launches["single"] == 0 or launches["multi"] == 0:
        raise RuntimeError(f"the service did not launch both mapspace "
                           f"kernels: {launches}")
    say("service", f"stats {final}; launches {{single: "
        f"{launches['single']}, multi: {launches['multi']}}}; manifests "
        f"name {card}; driver phases over all jobs (s): "
        + _phases(tr.phase_times()))

    t0 = time.perf_counter()
    direct = run_search(
        task, archs, **{k: v for k, v in query_a.items()
                        if k not in ("task", "space", "backend")},
        backend="torch", device=dev)
    direct_wall = time.perf_counter() - t0
    if _report_key(direct) != _report_key(rep_a) \
            or direct.hypervolume_curve() != rep_a.hypervolume_curve():
        raise RuntimeError("query A through the service differs from a "
                           "direct run_search on the oracle engine")
    say("service", f"A equals a direct run_search on \"torch\" "
        f"({direct_wall:.3f} s): best {rep_a.best.hardware.name} edp "
        f"{rep_a.goal_value():.6g}, frontier {len(rep_a.pareto)} archs")

    jobs = [MapspaceJob(tag=hw.name, hw=hw, workload=distinct[0],
                        packed=build_packed_mapspace(distinct[0], hw, cfg))
            for hw in archs]
    rows = sum(j.n_rows() for j in jobs)
    key = lambda bests: [(b.tag, b.index, b.value, b.n_scored)
                         for b in bests]
    real_devices = bf._local_devices
    for engine in ("cuda", "torch"):
        base = fused_best(jobs, "edp", device=dev, backend=engine)
        reset_launch_counts()
        bf._local_devices = lambda device: (dev, dev)
        try:
            tr2 = Tracer()
            with activate(tr2):
                split = fused_best(jobs, "edp", device=dev, backend=engine)
        finally:
            bf._local_devices = real_devices
        n = launch_counts()["multi"]
        sharded = (n == 2 if engine == "cuda" else
                   "fused.shard-dispatch" in tr2.span_times())
        if not sharded or key(split) != key(base):
            raise RuntimeError(f"the forced two-shard plan on {engine} "
                               f"(sharded: {sharded}) differs from the "
                               f"unsharded call")
    reset_launch_counts()
    say("service", f"forced two-shard plan over ({dev}, {dev}) on one "
        f"fused group of A ({len(jobs)} jobs of {distinct[0].name}, {rows} "
        f"rows): bit-equal to the unsharded call on both engines; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches["single"], launches["multi"]


def flash_bound_ms(b, s, h, hkv, d, dtype, causal=True):
    """The least time the card could take for causal attention on these
    shapes: 2 products x 2 ops x D per (row, visible key) pair, S(S+1)/2
    pairs per head, at the input type's peak; or q, k, v read once and o
    written once at HBM bandwidth, whichever is larger."""
    pairs = s * (s + 1) // 2 if causal else s * s
    t_ops = 4 * b * h * d * pairs / PEAK_FLOP_PER_S[dtype] * 1e3
    esize = torch.tensor([], dtype=dtype).element_size()
    t_bytes = 2 * b * s * (h + hkv) * d * esize / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _qkv(b, s, h, hkv, d, dtype, dev, seed=SEED):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(dev, dtype) for shape in ((b, s, h, d), (b, s, hkv, d),
                                          (b, s, hkv, d))]


def _padded(t):
    """The same values in a layout whose head stride is D + 1 elements: not
    16-byte aligned, so only the SIMT kernel takes it."""
    out = torch.zeros(*t.shape[:3], t.shape[3] + 1, dtype=t.dtype,
                      device=t.device)
    out[..., :t.shape[3]] = t
    return out[..., :t.shape[3]]


def flash_phase(dev, cases=FLASH_CASES):
    """Both kernels against `ref.py` on the card, each case on its route
    -> the tensor-core kernel's record (times at the first case, the
    serving prefill's shape; at FLASH_PHI3_TIMED, phi3-mini-3.8b's layer,
    under "phi3_timed")."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False     # plain version: fp32
    record = None
    for case in cases:
        b, s, h, hkv, d, dtype, causal, want_route = case
        q, k, v = _qkv(b, s, h, hkv, d, dtype, dev)
        route = kernel.choose_route(q, k, v)
        run = lambda: ops.flash_attention(q, k, v, causal=causal)
        plain = lambda: ref.flash_attention_ref(q, k, v, causal=causal)
        before = dict(kernel.LAUNCHES)
        out, want = run(), plain()
        torch.cuda.synchronize()
        tc_launches = kernel.LAUNCHES["flash_wgmma"] - before["flash_wgmma"]
        if route != want_route \
                or kernel.LAUNCHES["flash"] != before["flash"] + 1 \
                or tc_launches != (route == "wgmma"):
            raise RuntimeError(f"flash {tuple(q.shape)}: route {route} "
                               f"(want {want_route}), launches {before} -> "
                               f"{kernel.LAUNCHES}")
        if out.shape != q.shape or out.dtype != dtype \
                or not torch.isfinite(out).all():
            raise RuntimeError(f"flash {tuple(q.shape)}: bad output")
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
        err = float((out.float() - want.float()).abs().max())
        shape = (f"B={b} S={s} H={h} Hkv={hkv} D={d} {str(dtype)[6:]} "
                 f"{'causal' if causal else 'full'}")
        if record is None:
            record = dict(
                name="flash_attention", route="cuda", source=FLASH_SOURCE,
                replaces="src/repro/kernels/flash_attention/kernel.py:27",
                launches=None, **_time_prefill_shape(
                    q, k, v, run, plain, want, case, err, shape))
        elif case == FLASH_PHI3_TIMED:
            record["phi3_timed"] = _time_prefill_shape(
                q, k, v, run, plain, want, case, err, shape)
        else:
            say("flash", f"{shape}: route {route}, max abs err {err:.3g} "
                f"(tol {tol:g})")
    return record


def _sdpa(q, k, v, causal):
    """SDPA on the [B, H, S, D] views of the same tensors, GQA included:
    the one PyTorch call computing the kernel's function, timed here only
    and never called by the port."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def _time_prefill_shape(q, k, v, run, plain, want, case, err, shape):
    """A prefill's shape on the tensor-core route: the SIMT kernel on the
    same values in a padded layout (the kernel before the tensor-core one)
    held to the plain version within FLASH_TOL; times of the kernel, of
    the SIMT kernel, of the plain version and of SDPA, beside the bound
    -> those numbers, for the kernels line."""
    from repro_torch.kernels.flash_attention import kernel, ops
    b, s, h, hkv, d, dtype, causal, route = case
    if route != "wgmma":
        raise RuntimeError(f"the prefill's shape took route {route}")
    tol = FLASH_TOL[dtype]
    # the SIMT kernel on the same values, in a layout only it takes
    qp, kp, vp = (_padded(t) for t in (q, k, v))
    if kernel.choose_route(qp, kp, vp) != "simt":
        raise RuntimeError("the padded layout did not take the SIMT "
                           "route")
    simt = lambda: ops.flash_attention(qp, kp, vp, causal=causal)
    simt_out = simt().float()
    torch.testing.assert_close(simt_out, want.float(), rtol=tol, atol=tol)
    simt_err = float((simt_out - want.float()).abs().max())
    library = _sdpa(q, k, v, causal)
    lib_err = float((library().transpose(1, 2).float()
                     - want.float()).abs().max())
    ms = device_times_ms(run, cold=True)
    warm_ms = device_times_ms(run)
    b2b_ms = back_to_back_ms(run)
    simt_ms = device_times_ms(simt, cold=True)
    plain_ms = device_times_ms(plain, cold=True)
    plain_warm_ms = device_times_ms(plain)
    library_ms = device_times_ms(library, cold=True)
    b_ms, b_by = flash_bound_ms(b, s, h, hkv, d, dtype, causal)
    # the profiler may record no launch of a kernel in a burst:
    # profile until it has, and report "not recorded" if it never does
    (tc_prof, (kern_ms, _, kern_n)), (_, (simt_prof_ms, _, _)) = [
        profile_kernels(lambda f=f: [f() for _ in range(N_TIMED)],
                        (FLASH_KERNEL_NAMES[r],))
        for f, r in ((run, "wgmma"), (simt, "simt"))]
    cupti = [tc_prof] + [device_busy(lambda f=f: [f() for _ in
                                                  range(N_TIMED)])
                         for f in (plain, library)]
    prof = [c[3] / N_TIMED * 1e3 for c in cupti]
    say("flash", f"{shape}: route {route}, max abs err {err:.3g} (tol "
        f"{tol:g}; SIMT kernel's {simt_err:.3g}, SDPA's {lib_err:.3g}); "
        f"events, cold L2: kernel {ms:.4f} ms, SIMT kernel "
        f"{simt_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms; warm L2: kernel {warm_ms:.4f} ms, plain "
        f"{plain_warm_ms:.4f} ms; {N_TIMED} kernel calls back to back: "
        f"{b2b_ms:.4f} ms a call; profiler, warm: kernel {_ms(kern_ms)} "
        f"ms a launch over {kern_n} launches recorded, SIMT kernel "
        f"{_ms(simt_prof_ms)} ms; device time per call: kernel "
        f"{prof[0]:.4f} ms, plain {prof[1]:.4f} ms, SDPA {prof[2]:.4f} "
        f"ms; bound {b_ms:.5f} ms ({b_by}), kernel at "
        f"{100 * b_ms / ms:.1f}% of it (cold), SDPA at "
        f"{100 * b_ms / library_ms:.1f}%; kernel {simt_ms / ms:.1f}x "
        f"faster than the SIMT kernel, {ms / library_ms:.2f}x SDPA's time")
    return dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms,
        kernel=f"flash_fwd_tc_kernel<{d}>", kernel_route=route,
        warm_ms=warm_ms, plain_warm_ms=plain_warm_ms,
        back_to_back_ms=b2b_ms, profiler_ms=kern_ms,
        simt_ms=simt_ms, simt_profiler_ms=simt_prof_ms,
        simt_max_abs_err=simt_err, shape=shape)


def _logits_close(what: str, got, want, tol: float = LOGIT_TOL) -> float:
    """max |got - want| in float32, held to `tol` of want's range."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"{what}: bad logits {tuple(got.shape)}")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= tol * scale:
        raise RuntimeError(f"{what}: max abs err {err:.4g} > "
                           f"{tol} x {scale:.4g}")
    return err


def serve_phase(dev, cfg=None):
    """smollm-135m at full width: the prefill through the flash kernel,
    then the engine -> the kernel's launches in one prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import (attention, decode_step, forward,
                                    init_cache, init_model)
    from repro_torch.obs import Tracer
    from repro_torch.serve import Request, ServeEngine
    cfg = cfg or get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator().manual_seed(SEED), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S))).to(dev)
    torch.cuda.synchronize()
    say("serve", f"{cfg.name}: {n_params / 1e6:.1f}M params "
        f"({cfg.param_dtype}), {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.d_head}; init {time.perf_counter() - t0:.2f} s")
    prefill = lambda: forward(model, cfg, {"tokens": tokens},
                              logits_mode="last")
    with torch.no_grad():
        ops.install()
        try:
            reset_launch_counts()
            fused = prefill()
            torch.cuda.synchronize()
            launches = launch_counts()
            if launches["flash"] != cfg.n_layers \
                    or launches["flash_wgmma"] != cfg.n_layers \
                    or launches["single"] or launches["multi"] \
                    or launches["ssd"] \
                    or launches["norm"] != norm_launches(cfg):
                raise RuntimeError(f"prefill launches {launches}, want "
                                   f"flash=flash_wgmma={cfg.n_layers}, "
                                   f"norm={norm_launches(cfg)} and no "
                                   f"other")
            fused_ms = device_times_ms(prefill, n=5)
            host_ms, enqueue_ms = host_times_ms(prefill)
            wall, busy, n_ops, _, by_name = device_busy(prefill)
        finally:
            attention.set_flash_impl(None)
        plain = prefill()
        plain_ms = device_times_ms(prefill, n=5)
    err = _logits_close("prefill", fused, plain)
    say("serve", f"(a) prefill [{PREFILL_B}, {PREFILL_S}] -> logits "
        f"{tuple(fused.shape)}: flash launches {launches['flash']} "
        f"({launches['flash_wgmma']} on the tensor-core route); "
        f"{fused_ms:.2f} ms with the kernel, {plain_ms:.2f} ms with plain "
        f"attention (events); against plain max abs err {err:.4g} "
        f"(logits up to {float(plain.float().abs().max()):.4g}); "
        f"profiled: {wall * 1e3:.2f} ms wall, device busy "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%) in {n_ops} ops; "
        f"{PREFILL_B * PREFILL_S / fused_ms:.0f} prompt tokens/ms; host "
        f"clock with the kernel: {host_ms:.2f} ms a call from an idle "
        f"device to its end, {enqueue_ms:.2f} ms of it to enqueue the "
        f"call's work")
    say("serve", "(a) prefill's longest device activities: "
        + top_activities(by_name))

    tr = Tracer()
    engine = ServeEngine(cfg, model, batch=ENGINE_BATCH,
                         max_len=ENGINE_MAX_LEN, tracer=tr, device=dev)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, ENGINE_REQUESTS)
    for rid, n in enumerate(lens):
        engine.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, int(n)).astype(np.int32),
            max_new_tokens=NEW_TOKENS))
    t0 = time.perf_counter()
    ticks = engine.run_until_drained()
    wall = time.perf_counter() - t0
    out = [len(r.out_tokens) for r in engine.done.values()]
    if sorted(engine.done) != list(range(ENGINE_REQUESTS)) \
            or out != [NEW_TOKENS + 1] * ENGINE_REQUESTS:
        raise RuntimeError(f"engine finished {sorted(engine.done)} with "
                           f"{out} tokens")
    sp = tr.span_times()
    decoded = tr.metrics.snapshot()["counters"]["serve.tokens_decoded"]
    toks = torch.zeros(ENGINE_BATCH, dtype=torch.int32, device=dev)
    wall_1, busy_1, n_ops_1, _, by_name = device_busy(
        lambda: decode_step(model, cfg, engine.cache, toks, 0))
    say("serve", f"(b) engine: {ENGINE_REQUESTS} requests (prompts "
        f"{sorted(lens.tolist())}), {sum(out)} tokens out ({decoded:.0f} "
        f"from decode ticks), {ticks} ticks, {wall:.2f} s wall, "
        f"{sum(out) / wall:.1f} tokens/s; token-by-token prefill "
        f"{sp.get('serve.prefill', 0):.2f} s ({int(lens.sum())} steps), "
        f"decode ticks {sp.get('serve.decode', 0):.2f} s")
    say("serve", f"(b) one profiled decode_step: {wall_1 * 1e3:.2f} ms wall, "
        f"device busy {busy_1 * 1e3:.3f} ms ({100 * busy_1 / wall_1:.1f}%) "
        f"in {n_ops_1} ops; longest: " + top_activities(by_name, 3))

    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, TEACHER_LEN))
                              ).to(dev)
    cache = init_cache(cfg, 1, TEACHER_LEN, device=dev)
    for pos in range(TEACHER_LEN):
        step, cache = decode_step(model, cfg, cache, prompt[:, pos], pos)
    with torch.no_grad():
        ops.install()
        try:
            last = forward(model, cfg, {"tokens": prompt},
                           logits_mode="last")[:, 0]
        finally:
            attention.set_flash_impl(None)
    err = _logits_close("decode vs prefill", step, last)
    say("serve", f"teacher-forced decode_step over {TEACHER_LEN} tokens "
        f"against the flash prefill's last logits: max abs err {err:.4g}")
    return launches["flash_wgmma"]


def ssd_bound_ms(b, t, h, p, g, n, q):
    """The least time the card could take for the SSD scan on these
    shapes, per route: the larger of its operations at the peak of the
    units the route computes on and its bytes at HBM bandwidth.
    Operations, 2 a multiply-add, with C B^T formed once per (batch row,
    group, chunk) and only the causal half (Q(Q+1)/2 pairs) of the two
    Q x Q products counted: C B^T (N deep) per group, its weights times X
    (P wide), C times the state and the state update (Q x N x P each) per
    head; route "simt" does them once at the float32 peak outside the
    tensor cores, route "tc" three times (the TF32 split) at the TF32
    peak.  Bytes: x, dt, a, B and C read once and y written once, in
    float32.  -> {route: (ms, "operations" or "bytes")}."""
    nc, pairs = t // q, q * (q + 1) // 2
    flops = 2 * b * nc * (g * pairs * n + h * pairs * p + 2 * h * q * n * p)
    nbytes = 4 * (2 * b * t * h * p + 2 * b * t * g * n + b * t * h + h)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3

    def bound(t_ops):
        return (t_ops, "operations") if t_ops >= t_bytes \
            else (t_bytes, "bytes")
    return {"simt": bound(flops / FP32_FLOP_PER_S * 1e3),
            "tc": bound(3 * flops / TF32_FLOP_PER_S * 1e3)}


def _ssd_inputs(b, t, h, p, g, n, dev, what, seed=SEED):
    """(xh, dt, a, bh, ch) on the card: softplus dt, B/C scaled by 0.3 and
    a = -exp(0.5 z) as the JAX kernel test draws them, or the model's
    a = -(1 .. 16) at the models' shapes; for the "strided views" cases,
    xh, B and C are slices of one [B, T, H*P + 2*G*N] tensor, as the model
    passes them (its B/C columns scaled by 0.3 unless "unit-scale")."""
    rng = np.random.default_rng(seed)
    z = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        dev)
    dt = torch.nn.functional.softplus(z(b, t, h))
    a = -torch.exp(z(h) * 0.5) if what.startswith("SSD_SHAPES") \
        else -torch.linspace(1.0, 16.0, h, device=dev)
    if not what.endswith("strided views"):
        return z(b, t, h, p), dt, a, z(b, t, g, n) * 0.3, z(b, t, g, n) * 0.3
    conv = z(b, t, h * p + 2 * g * n)
    if not what.startswith("unit-scale"):
        conv[..., h * p:] *= 0.3
    return (conv[..., :h * p].reshape(b, t, h, p), dt, a,
            conv[..., h * p:h * p + g * n].reshape(b, t, g, n),
            conv[..., h * p + g * n:].reshape(b, t, g, n))


def ssd_launched(route: str, t: int, q: int) -> tuple:
    """The sub-kernels one SSD op call on `route` launches at sequence
    length `t` and chunk `q`: route "tc" has no chunk states and no state
    passing when `t` is one chunk."""
    names = SSD_KERNEL_NAMES[route]
    if route == "tc" and t // q == 1:
        names = tuple(k for k in names
                      if k not in ("ssd_states_kernel", "ssd_pass_kernel"))
    return names


def ssd_call_ms(by_name: dict, names):
    """-> (device ms of one SSD op call, {sub-kernel: ms a recorded
    launch}, fewest launches recorded of a sub-kernel) from a profile's
    {activity name: (summed s, count)}: each sub-kernel in `names` (the
    call's launches, `ssd_launched`) at its time a recorded launch (the
    profiler may drop launches), summed.  A sub-kernel with no launch
    recorded is None, and so is the call's time: not measured."""
    per, counts = {}, []
    for kname in names:
        hits = [v for name, v in by_name.items() if kname in name]
        s, k = sum(t for t, _ in hits), sum(c for _, c in hits)
        per[kname] = s / k * 1e3 if k else None
        counts.append(k)
    call = None if None in per.values() else sum(per.values())
    return call, per, min(counts)


def profile_kernels(fn, names, tries: int = 3):
    """`device_busy(fn)` until the profile has recorded a launch of every
    kernel in `names`, at most `tries` times -> (the last profile,
    `ssd_call_ms` of it)."""
    for _ in range(tries):
        prof = device_busy(fn)
        call = ssd_call_ms(prof[4], names)
        if call[0] is not None:
            break
    return prof, call


def _ms(v) -> str:
    return "not recorded" if v is None else f"{v:.4f}"


def _sub_kernels(per: dict) -> str:
    return ", ".join(f"{k.replace('ssd_', '').replace('_kernel', '')} "
                     f"{_ms(v)}" for k, v in per.items())


def ssd_phase(dev, cases=SSD_CASES):
    """Both kernels against `ssd_chunk_scan_streaming` on the card, in
    float32 and in float64 -> the tensor-core route's record (times at the
    first case, mamba2-2.7b's prefill layer, beside the SIMT route's)."""
    from repro_torch.kernels.ssd_scan import kernel, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False     # plain version: fp32
    record = None
    for b, t, h, p, g, n, q, what in cases:
        args = _ssd_inputs(b, t, h, p, g, n, dev, what)
        chosen = kernel.choose_route(*args, chunk=q)
        plain = lambda: ref.ssd_chunk_scan_streaming(*args, q)
        want = plain()
        truth = ref.ssd_chunk_scan_streaming(*[v.double() for v in args], q)
        shape = f"B={b} T={t} H={h} P={p} G={g} N={n} Q={q}"
        bounds = ssd_bound_ms(b, t, h, p, g, n, q)
        plain_ms = device_times_ms(plain, cold=True)
        plain_warm_ms = device_times_ms(plain)
        res = {}
        for route in [chosen] + (["simt"] if chosen == "tc" else []):
            if route == chosen:          # the op, as the model calls it
                run = lambda: ops.ssd_scan(*args, chunk=q)
            else:
                run = lambda r=route: kernel.ssd_scan_fwd(*args, chunk=q,
                                                          route=r)
            before = dict(kernel.LAUNCHES)
            out = run()
            torch.cuda.synchronize()
            if kernel.LAUNCHES["ssd"] != before["ssd"] + 1 \
                    or kernel.LAUNCHES["ssd_tc"] != before["ssd_tc"] + (
                        route == "tc"):
                raise RuntimeError(f"ssd {what}: route {route}, launches "
                                   f"{before} -> {kernel.LAUNCHES}")
            if out.shape != (b, t, h, p) or out.dtype != torch.float32 \
                    or not torch.isfinite(out).all():
                raise RuntimeError(f"ssd {what} ({route}): bad output")
            torch.testing.assert_close(out.double(), truth, rtol=SSD_TOL,
                                       atol=SSD_TOL)
            if what not in SSD_FLOAT64_ONLY:
                torch.testing.assert_close(out, want, rtol=SSD_TOL,
                                           atol=SSD_TOL)
            ms = device_times_ms(run, cold=True)
            _, (call_ms, per, kern_n) = profile_kernels(
                lambda: [run() for _ in range(N_TIMED)],
                ssd_launched(route, t, q))
            b_ms, b_by = bounds[route]
            if b_ms > ms:
                raise RuntimeError(f"ssd {what} ({route}): {ms:.4f} ms is "
                                   f"under its bound {b_ms:.4f} ms")
            res[route] = dict(
                ms=ms, call_ms=call_ms, per=per, kern_n=kern_n,
                err=float((out - want).abs().max()),
                err64=float((out.double() - truth).abs().max()),
                over=float(((out.double() - truth).abs()
                            / (SSD_TOL * (1 + truth.abs()))).max()),
                share=b_ms / ms, bound=(b_ms, b_by))
        over_plain = float(((want.double() - truth).abs()
                            / (SSD_TOL * (1 + truth.abs()))).max())
        main = res[chosen]
        warm_ms = device_times_ms(lambda: ops.ssd_scan(*args, chunk=q))
        b2b_ms = back_to_back_ms(lambda: ops.ssd_scan(*args, chunk=q))
        routes = "; ".join(
            f"{r}: max abs err {v['err']:.3g} against plain, "
            f"{v['err64']:.3g} against float64 (worst |err| / tol "
            f"{v['over']:.3g}); {v['ms']:.4f} ms cold, profiler "
            f"{_ms(v['call_ms'])} ms a call ({_sub_kernels(v['per'])}; "
            f">= {v['kern_n']} launches of each recorded); bound "
            f"{v['bound'][0]:.5f} ms ({v['bound'][1]}), at "
            f"{100 * v['share']:.1f}% of it" for r, v in res.items())
        say("ssd", f"{what} ({shape}): route {chosen} (outputs up to "
            f"{float(want.abs().max()):.3g}; plain's worst |err| / tol "
            f"against float64 {over_plain:.3g}); {routes}; route {chosen} "
            f"warm L2 {warm_ms:.4f} ms, {N_TIMED} calls back to back "
            f"{b2b_ms:.4f} ms a call; plain {plain_ms:.4f} ms cold, "
            f"{plain_warm_ms:.4f} ms warm")
        if record is None:
            if chosen != "tc":
                raise RuntimeError(f"the mamba2 layer took route {chosen}")
            simt = res["simt"]
            record = dict(
                name="ssd_scan", route="cuda", source=SSD_SOURCE,
                replaces="src/repro/kernels/ssd_scan/kernel.py:26",
                launches=None, max_abs_err=main["err"], ms=main["ms"],
                plain_ms=plain_ms, bound_ms=main["bound"][0],
                bound_by=main["bound"][1], library_ms=None,
                kernel_route="tc", max_abs_err_float64=main["err64"],
                warm_ms=warm_ms, plain_warm_ms=plain_warm_ms,
                back_to_back_ms=b2b_ms, profiler_ms=main["call_ms"],
                sub_kernels_ms=main["per"], simt_ms=simt["ms"],
                simt_profiler_ms=simt["call_ms"],
                simt_bound_ms=simt["bound"][0],
                simt_max_abs_err=simt["err"], shape=shape)
    return record


def conv_bound_ms(b, t, c, h, k, esize=2):
    """The least time the card could take for the conv chain on these
    shapes: its bytes at HBM bandwidth (K multiply-adds and one exp a
    channel are ~0.3 operations a byte, far below any ridge): the conv's C
    and dt's H columns of zxbcdt read once at `esize` bytes, conv32 and dt
    written once in float32, the weights ((K + 1) C + H) read once."""
    nbytes = b * t * (c + h) * (esize + 4) + ((k + 1) * c + h) * esize
    return nbytes / HBM_BYTES_PER_S * 1e3


def _conv_inputs(cfg, b, t, dev, seed=SEED):
    """(zxbcdt, conv_w, conv_b, dt_bias) in bf16 on the card at `cfg`'s
    layer: zxbcdt of unit scale, conv_w at the model's scale K**-0.5, a
    small bias, dt_bias about log(expm1(0.01))."""
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.d_state
    c, h, k = di + 2 * gn, cfg.n_ssm_heads, cfg.d_conv
    gen = torch.Generator(dev).manual_seed(seed)

    def z(*shape, scale=1.0, shift=0.0):
        v = torch.randn(shape, generator=gen, device=dev) * scale + shift
        return v.to(torch.bfloat16)

    return (z(b, t, 2 * di + 2 * gn + h), z(k, c, scale=k ** -0.5),
            z(c, scale=0.1), z(h, scale=0.5, shift=-4.6))


def _conv_scale(zxbcdt, w, bias, di, gn):
    """s[b, t, c] = sum_j |w[j, c] x[b, t - K + 1 + j, c]| + |bias[c]|,
    in float32."""
    x = zxbcdt[..., di:2 * di + 2 * gn].float().abs()
    k, t = w.shape[0], x.shape[1]
    full = torch.cat([x.new_zeros(x.shape[0], k - 1, x.shape[2]), x], 1)
    return sum(full[:, j:j + t] * w[j].float().abs() for j in range(k)) \
        + bias.float().abs()


def ssm_conv_phase(dev):
    """The conv-chain kernel through `ops.ssm_conv` at each of CONV_ARCHS'
    layers, bf16 at [PREFILL_B, PREFILL_S]: one launch a call, against
    `ref.conv_chain` on float32 copies at CONV_TOL and within
    CONV_BF16_ULPS u s of the eager bf16 chain; timed as the SSD phase
    times (events cold and warm, the profiler's time a launch), beside
    the eager chain's time and the bytes' bound -> the kernel's record
    (mamba2-2.7b's layer, zamba2-2.7b's times beside)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_conv import kernel, ops, ref
    record = None
    b, t = PREFILL_B, PREFILL_S
    for arch in CONV_ARCHS:
        cfg = get_config(arch)
        di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.d_state
        c, h = di + 2 * gn, cfg.n_ssm_heads
        shape = f"{arch} layer: B={b} T={t} C={c} H={h} K={cfg.d_conv}"
        args = _conv_inputs(cfg, b, t, dev)
        run = lambda: ops.ssm_conv(*args, d_inner=di, gn=gn)  # noqa: E731
        plain = lambda: ref.conv_chain(*args, di, gn)        # noqa: E731
        with torch.no_grad():
            before = kernel.LAUNCHES["fused"]
            _, out, dt = run()
            torch.cuda.synchronize()
            if kernel.LAUNCHES["fused"] != before + 1:
                raise RuntimeError(f"conv {shape}: launches {before} -> "
                                   f"{kernel.LAUNCHES['fused']}, want one")
            _, want, want_dt = ref.conv_chain(*[v.float() for v in args],
                                              di, gn)
            torch.testing.assert_close(out, want, rtol=CONV_TOL,
                                       atol=CONV_TOL)
            torch.testing.assert_close(dt, want_dt, rtol=CONV_TOL,
                                       atol=CONV_TOL)
            err32 = max(float((out - want).abs().max()),
                        float((dt - want_dt).abs().max()))
            del want, want_dt
            _, eager, eager_dt = plain()
            room = CONV_BF16_ULPS * U_BF16 \
                * _conv_scale(args[0], args[1], args[2], di, gn) + 1e-6
            over = float(((out - eager).abs() / room).max())
            err_bf16 = float((out - eager).abs().max())
            if over > 1:
                raise RuntimeError(f"conv {shape}: {over:.3g} times the "
                                   f"bf16 chain's bound")
            torch.testing.assert_close(dt, eager_dt, rtol=CONV_TOL,
                                       atol=CONV_TOL)
            del eager, eager_dt, room, out, dt
            ms = device_times_ms(run, cold=True)
            warm_ms = device_times_ms(run)
            plain_ms = device_times_ms(plain, cold=True)
            _, (prof_ms, _, kern_n) = profile_kernels(
                lambda: [run() for _ in range(N_TIMED)], ("ssm_conv_kernel",))
        b_ms = conv_bound_ms(b, t, c, h, cfg.d_conv)
        if b_ms > ms:
            raise RuntimeError(f"conv {shape}: {ms:.4f} ms is under its "
                               f"bound {b_ms:.4f} ms")
        say("conv", f"{shape}: max abs err {err32:.3g} against the float32 "
            f"chain (tol {CONV_TOL:g}), {err_bf16:.3g} against the bf16 "
            f"chain ({over:.3g} of its {CONV_BF16_ULPS} u s bound); "
            f"{ms:.4f} ms cold, {warm_ms:.4f} ms warm L2, profiler "
            f"{_ms(prof_ms)} ms a launch (>= {kern_n} recorded); bound "
            f"{b_ms:.5f} ms (bytes), at {100 * b_ms / ms:.1f}% of it; the "
            f"eager chain {plain_ms:.4f} ms cold")
        if record is None:
            record = dict(
                name="ssm_conv", route="cuda", source=CONV_SOURCE,
                replaces=None, launches=None, max_abs_err=err32, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes",
                library_ms=None, max_abs_err_bf16_chain=err_bf16,
                bf16_bound_share=over, warm_ms=warm_ms,
                profiler_ms=prof_ms, shape=shape)
        else:
            record.update(zamba2_ms=ms, zamba2_plain_ms=plain_ms,
                          zamba2_bound_ms=b_ms)
        del args
        torch.cuda.empty_cache()
    return record


def gate_bound_ms(b, t, di, h, esize=2):
    """The least time the card could take for the gate chain: its bytes at
    HBM bandwidth (~40 instructions a channel are ~3 a byte, below the
    ridge): float32 y and xh and `esize` z read once, the output written
    once, D and out_norm read once."""
    nbytes = b * t * di * (4 + 4 + 2 * esize) + (di + h) * esize
    return nbytes / HBM_BYTES_PER_S * 1e3


def _gate_inputs(cfg, b, t, dev):
    """(y, xh, D, z, out_norm) in bf16 as `mamba2_forward` hands them over
    at `cfg`'s layer: `_conv_inputs` through the conv kernel (z its view,
    xh the first d_inner columns of its float32 output) and the SSD op (y,
    A from -1 to -16 over the heads), D about 1 and out_norm about 1."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_conv import ops as conv_ops
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.d_state
    h, p, g = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_ngroups
    z, conv32, dt = conv_ops.ssm_conv(*_conv_inputs(cfg, b, t, dev),
                                      d_inner=di, gn=gn)
    xh = conv32[..., :di].unflatten(-1, (h, p))
    bh = conv32[..., di:di + gn].unflatten(-1, (g, gn // g))
    ch = conv32[..., di + gn:].unflatten(-1, (g, gn // g))
    y = ssd_ops.ssd_scan(xh, dt, -torch.linspace(1.0, 16.0, h, device=dev),
                         bh, ch, chunk=cfg.chunk)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    d = 1 + 0.5 * torch.randn(h, generator=gen, device=dev)
    w = 1 + 0.1 * torch.randn(di, generator=gen, device=dev)
    return y, xh, d.to(torch.bfloat16), z, w.to(torch.bfloat16)


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def ssm_gate_phase(dev):
    """Phase 9d: the gate-chain kernel through `ops.ssm_gate` at
    mamba2-2.7b's layer [PREFILL_B, PREFILL_S] and granite-4.0-h-small's
    [GRANITE_PREFILL], bf16 on the model's views, read in place: one
    launch a call, within one bf16 ulp of `ref.gate_chain` on the same
    inputs; timed as the conv phase times -> the kernel's record
    (mamba2's layer, granite's beside)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_gate import kernel, ops, ref
    record = None
    bf16 = torch.bfloat16
    for cfg, (b, t) in ((get_config(SSM_ARCH), (PREFILL_B, PREFILL_S)),
                        (granite_config(), GRANITE_PREFILL)):
        di, h = cfg.d_inner, cfg.n_ssm_heads
        shape = (f"{cfg.name} layer: B={b} T={t} H={h} "
                 f"P={cfg.ssm_headdim}")
        with torch.no_grad():
            args = _gate_inputs(cfg, b, t, dev)
            if not kernel.vector_ok(*args[:2], args[3], args[4]):
                raise RuntimeError(f"gate {shape}: the model's views would "
                                   f"be copied, not read in place")
            run = lambda: ops.ssm_gate(  # noqa: E731
                *args, eps=cfg.norm_eps, dtype=bf16)
            plain = lambda: ref.gate_chain(  # noqa: E731
                *args, cfg.norm_eps, bf16)
            before = kernel.LAUNCHES["fused"]
            out = run()
            torch.cuda.synchronize()
            if kernel.LAUNCHES["fused"] != before + 1:
                raise RuntimeError(f"gate {shape}: launches {before} -> "
                                   f"{kernel.LAUNCHES['fused']}, want one")
            want = plain()
            err = (out.float() - want.float()).abs()
            over = float((err / _bf16_ulp(torch.maximum(
                out.float().abs(), want.float().abs()))).max())
            max_err, n_off = float(err.max()), int((err > 0).sum())
            if over > 1 or not torch.isfinite(out).all():
                raise RuntimeError(f"gate {shape}: {over:.3g} bf16 ulps "
                                   f"from the eager chain, one allowed")
            del out, want, err
            ms = device_times_ms(run, cold=True)
            plain_ms = device_times_ms(plain, cold=True)
            _, (prof_ms, _, kern_n) = profile_kernels(
                lambda: [run() for _ in range(N_TIMED)], (GATE_KERNEL_NAME,))
        b_ms = gate_bound_ms(b, t, di, h)
        if b_ms > ms:
            raise RuntimeError(f"gate {shape}: {ms:.4f} ms is under its "
                               f"bound {b_ms:.4f} ms")
        say("gate", f"{shape}: one launch; max abs err {max_err:.3g} "
            f"against the eager bf16 chain ({n_off} of {b * t * di} "
            f"outputs off, {over:.3g} of the one-ulp bound); {ms:.4f} ms "
            f"cold, profiler {_ms(prof_ms)} ms a launch (>= {kern_n} "
            f"recorded); bound {b_ms:.5f} ms (bytes), at "
            f"{100 * b_ms / ms:.1f}% of it; the eager chain {plain_ms:.4f} "
            f"ms cold")
        if record is None:
            record = dict(
                name="ssm_gate", route="cuda", source=GATE_SOURCE,
                replaces=None, launches=None, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes",
                library_ms=None, bf16_ulp_share=over, profiler_ms=prof_ms,
                shape=shape)
        else:
            record.update(granite_ms=ms, granite_plain_ms=plain_ms,
                          granite_bound_ms=b_ms, granite_max_abs_err=max_err,
                          granite_bf16_ulp_share=over)
        del args
        torch.cuda.empty_cache()
    return record


def norm_launches(cfg) -> int:
    """RMS-norm kernel launches in one `forward` of `cfg` on the card: one
    a residual-stream norm (two a block, one a Mamba2 block, two a shared
    attention block of the hybrid family), the final norm, and MLA's
    latent norms (kv_a in every layer, q_a where there is a q_lora_rank);
    none where the model's norm is not RMS."""
    if cfg.norm != "rmsnorm":
        return 0
    n = cfg.n_layers
    if cfg.family == "ssm":
        return n + 1
    if cfg.family == "hybrid":
        return n + 2 * (n // cfg.shared_attn_every) + 1
    mla = 1 + bool(cfg.q_lora_rank) if cfg.attn == "mla" else 0
    return (2 + mla) * n + 1


def norm_bound_ms(rows, d, esize=2):
    """The least time the card could take for one RMS norm of [rows, d]:
    its bytes at HBM bandwidth (~5 instructions a value are ~2 a byte in
    bf16, below the ridge): x read and the output written once, the
    weight read once."""
    return (2 * rows * d + d) * esize / HBM_BYTES_PER_S * 1e3


def rms_norm_phase(dev):
    """Phase 9e: the RMS-norm kernel through `ops.rms_norm` at
    `NORM_CASES`, bf16 x of the residual stream's scale (a few outliers)
    and a weight about 1: one launch a call, within one bf16 ulp of
    `ref.rms_norm` on the same inputs; timed as the gate phase times ->
    the kernel's record (mamba2's shape, every case under "cases")."""
    from repro_torch.kernels.rms_norm import kernel, ops, ref
    bf16, cases = torch.bfloat16, []
    for b, t, d, model in NORM_CASES:
        shape = f"{model} residual stream [{b}, {t}, {d}]"
        gen = torch.Generator(dev).manual_seed(SEED)
        with torch.no_grad():
            x = 4 * torch.randn(b, t, d, generator=gen, device=dev)
            x.view(-1)[::97] *= 30
            x = x.to(bf16)
            w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(bf16)
            if not kernel.vector_ok(x, w):
                raise RuntimeError(f"norm {shape}: x would be copied, not "
                                   f"read in place")
            run = lambda: ops.rms_norm(x, w, NORM_EPS)  # noqa: E731
            plain = lambda: ref.rms_norm(x, w, NORM_EPS)  # noqa: E731
            before = kernel.LAUNCHES["fused"]
            out = run()
            torch.cuda.synchronize()
            if kernel.LAUNCHES["fused"] != before + 1:
                raise RuntimeError(f"norm {shape}: launches {before} -> "
                                   f"{kernel.LAUNCHES['fused']}, want one")
            want = plain()
            err = (out.float() - want.float()).abs()
            over = float((err / _bf16_ulp(torch.maximum(
                out.float().abs(), want.float().abs()))).max())
            max_err, n_off = float(err.max()), int((err > 0).sum())
            if over > 1 or not torch.isfinite(out).all():
                raise RuntimeError(f"norm {shape}: {over:.3g} bf16 ulps "
                                   f"from the eager chain, one allowed")
            del out, want, err
            ms = device_times_ms(run, cold=True)
            plain_ms = device_times_ms(plain, cold=True)
            _, (prof_ms, _, kern_n) = profile_kernels(
                lambda: [run() for _ in range(N_TIMED)], (NORM_KERNEL_NAME,))
        b_ms = norm_bound_ms(b * t, d)
        if b_ms > ms:
            raise RuntimeError(f"norm {shape}: {ms:.4f} ms is under its "
                               f"bound {b_ms:.4f} ms")
        say("norm", f"{shape}: one launch; max abs err {max_err:.3g} "
            f"against the eager bf16 chain ({n_off} of {b * t * d} outputs "
            f"off, {over:.3g} of the one-ulp bound); {ms:.4f} ms cold, "
            f"profiler {_ms(prof_ms)} ms a launch (>= {kern_n} recorded); "
            f"bound {b_ms:.5f} ms (bytes), at {100 * b_ms / ms:.1f}% of it; "
            f"the eager chain {plain_ms:.4f} ms cold")
        cases.append(dict(shape=shape, max_abs_err=max_err, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms,
                          bf16_ulp_share=over, profiler_ms=prof_ms))
        del x, w
        torch.cuda.empty_cache()
    main = next(c for c in cases if SSM_ARCH in c["shape"])
    return dict(name="rms_norm", route="cuda", source=NORM_SOURCE,
                replaces=None, launches=None, bound_by="bytes",
                library_ms=None, **main, cases=cases)


def granite_config():
    """granite-4.0-h-small's `ModelConfig`, from the benchmark's config
    file as `portbench/harness.py::program` builds it."""
    from repro_torch.configs.base import ModelConfig
    m = json.loads((ROOT / GRANITE_CONFIG).read_text())["model"]
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in m.items()})


def granite_flash(dev, cfg) -> dict:
    """Phase 9c (a): flash at granite's attention layer with its scale ->
    the numbers for the flash record."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    b, s, h, hkv, d, dtype, causal, want_route = GRANITE_FLASH
    scale = cfg.softmax_scale
    if scale != GRANITE_SCALE or (h, hkv, d) != (
            cfg.n_heads, cfg.n_kv_heads, cfg.d_head):
        raise RuntimeError(f"granite's attention: scale {scale}, heads "
                           f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.d_head}")
    q, k, v = _qkv(b, s, h, hkv, d, dtype, dev)
    route = kernel.choose_route(q, k, v)
    run = lambda: ops.flash_attention(q, k, v, scale=scale)  # noqa: E731
    before = dict(kernel.LAUNCHES)
    out = run()
    torch.cuda.synchronize()
    if route != want_route or kernel.LAUNCHES["flash_wgmma"] \
            != before["flash_wgmma"] + 1:
        raise RuntimeError(f"granite flash: route {route}, launches "
                           f"{before} -> {kernel.LAUNCHES}")
    tol = FLASH_TOL[dtype]
    want = ref.flash_attention_ref(q, k, v, scale=scale)
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    err = float((out.float() - want.float()).abs().max())
    del want
    moved = float((out.float() - ops.flash_attention(q, k, v).float())
                  .abs().max())
    if not moved > 10 * tol:
        raise RuntimeError(f"granite flash: scale {scale} moved the output "
                           f"by {moved:.3g} from the default's, want > "
                           f"{10 * tol:g}")
    ms = device_times_ms(run, cold=True)
    b_ms, by = flash_bound_ms(b, s, h, hkv, d, dtype)
    shape = f"B={b} S={s} H={h} Hkv={hkv} D={d} bf16 causal"
    say("granite", f"(a) flash {shape}, scale {scale:g}: route {route}, "
        f"max abs err {err:.3g} (tol {tol:g}), {moved:.3g} from the "
        f"default scale's output; {ms:.4f} ms cold, bound {b_ms:.4f} ms "
        f"({by}), at {100 * b_ms / ms:.1f}% of it")
    return dict(shape=shape, scale=scale, max_abs_err=err,
                moved_from_default=moved, ms=ms, bound_ms=b_ms, bound_by=by)


def granite_grouped(dev, cfg) -> dict:
    """Phase 9c (b): the grouped expert products at the benchmark's call
    -> the grouped product's record (gate/up's numbers, down's beside)."""
    from repro_torch.kernels.moe_grouped import kernel, ops
    from repro_torch.kernels.moe_grouped.ref import grouped_mm_ref
    from repro_torch.models.moe import sort_by_expert
    e, dm, f = cfg.n_experts, cfg.d_model, cfg.d_expert
    rows = GRANITE_PREFILL[0] * GRANITE_PREFILL[1] * cfg.top_k
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ids = torch.randint(0, e, (rows,), generator=gen, device=dev)
    ids[ids == 7] = 8                               # an expert with no row
    _, offs = sort_by_expert(ids, e)
    record = None
    for what, k, n in (("gate/up", dm, f), ("down", f, dm)):
        x = torch.randn(rows, k, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        w = torch.randn(e, k, n, generator=gen, device=dev,
                        dtype=torch.bfloat16) * 0.02
        run = lambda: ops.grouped_mm(x, w, offs)          # noqa: E731
        with torch.no_grad():
            before = kernel.LAUNCHES["grouped"]
            got = run()
            torch.cuda.synchronize()
            if kernel.LAUNCHES["grouped"] != before + 1:
                raise RuntimeError(f"grouped {what}: launches {before} -> "
                                   f"{kernel.LAUNCHES['grouped']}, want one")
            want = grouped_mm_ref(x.float(), w.float(), offs)
            err, top = (float((got.float() - want).abs().max()),
                        float(want.abs().max()))
            del got, want
            if not err <= GROUPED_TOL * top:
                raise RuntimeError(f"grouped {what}: max abs err {err:.4g} "
                                   f"over {GROUPED_TOL:g} of {top:.4g}")
            ms = device_times_ms(run, cold=True)
            plain_ms = device_times_ms(
                lambda: grouped_mm_ref(x, w, offs), n=5, cold=True)
            prof, (prof_ms, _, kern_n) = profile_kernels(
                lambda: [run() for _ in range(N_TIMED)],
                (GROUPED_KERNEL_NAME,))
        # the profiler may drop every launch of a burst ("not recorded");
        # launches recorded under another name are a fault
        if prof_ms is None and prof[4]:
            raise RuntimeError(f"grouped {what}: no device activity named "
                               f"{GROUPED_KERNEL_NAME!r} among "
                               f"{sorted(prof[4])[:4]}")
        t_ops = 2 * rows * k * n / PEAK_FLOP_PER_S[torch.bfloat16] * 1e3
        t_bytes = 2 * (rows * k + e * k * n + rows * n) \
            / HBM_BYTES_PER_S * 1e3
        b_ms, by = (t_ops, "operations") if t_ops >= t_bytes \
            else (t_bytes, "bytes")
        shape = f"[{rows}, {k}] x [{e}, {k}, {n}]"
        say("granite", f"(b) grouped {what} {shape}: one launch, max abs "
            f"err {err:.4g} ({err / top:.3g} of the output's range, tol "
            f"{GROUPED_TOL:g}) against the loop on float32 copies; "
            f"{ms:.4f} ms cold, profiler {_ms(prof_ms)} ms a launch (>= "
            f"{kern_n} recorded as {GROUPED_KERNEL_NAME}); bound "
            f"{b_ms:.4f} ms ({by}), at {100 * b_ms / ms:.1f}% of it; the "
            f"loop over experts in bf16 {plain_ms:.4f} ms")
        numbers = dict(max_abs_err=err, rel_err=err / top, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                       profiler_ms=prof_ms, shape=shape)
        if record is None:
            record = dict(name="moe_grouped", route="library",
                          source=GROUPED_SOURCE, replaces=None,
                          launches=None, library_ms=None, **numbers)
        else:
            record["down"] = numbers
        del x, w
        torch.cuda.empty_cache()
    return record


def granite_prefill(dev, cfg) -> dict:
    """Phase 9c (c): the model at full width and depth, one prefill with
    the flash hook -> its launch counts."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import attention, forward, init_model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, torch.Generator(dev).manual_seed(SEED),
                       device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, GRANITE_PREFILL)).to(dev)
    n_attn = cfg.layer_types.count("attention")
    n_mamba = cfg.n_layers - n_attn

    def prefill():
        return forward(model, cfg, {"tokens": tokens}, logits_mode="last")

    with torch.no_grad():
        flash_ops.install()
        try:
            reset_launch_counts()
            logits = prefill()
            torch.cuda.synchronize()
            launches = launch_counts()
            want = {**{k: 0 for k in launches}, "flash": n_attn,
                    "flash_wgmma": n_attn, "ssd": n_mamba,
                    "ssd_tc": n_mamba, "fused": n_mamba, "gate": n_mamba,
                    "grouped": 3 * cfg.n_layers, "norm": norm_launches(cfg)}
            if launches != want:
                raise RuntimeError(f"granite prefill launches {launches}, "
                                   f"want {want}")
            if tuple(logits.shape) != (GRANITE_PREFILL[0], 1, cfg.vocab) \
                    or not torch.isfinite(logits).all():
                raise RuntimeError(f"granite prefill: bad logits "
                                   f"{tuple(logits.shape)}")
            ms = device_times_ms(prefill, n=3)
        finally:
            attention.set_flash_impl(None)
    peak = torch.cuda.max_memory_allocated()
    say("granite", f"(c) {cfg.name}: {n_params / 1e9:.3f}B params "
        f"({cfg.param_dtype}), {n_mamba} Mamba2 + {n_attn} attention "
        f"layers, each with a {cfg.n_experts}-expert top-{cfg.top_k} MoE; "
        f"init {init_s:.2f} s; prefill {list(GRANITE_PREFILL)}: launches "
        f"{ {k: v for k, v in launches.items() if v} }; {ms:.2f} ms "
        f"(events); peak {peak / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t0:.1f} s")
    del model, logits
    torch.cuda.empty_cache()
    return launches


def granite_phase(dev) -> tuple:
    """Phase 9c -> (the scaled flash case's numbers, the grouped product's
    record, one prefill's launch counts)."""
    cfg = granite_config()
    flash = granite_flash(dev, cfg)
    torch.cuda.empty_cache()
    grouped = granite_grouped(dev, cfg)
    return flash, grouped, granite_prefill(dev, cfg)


def ssm_serve_phase(dev, cfg, tag, prefill_b, engine=True):
    """A Mamba2 model (ssm or hybrid family) at the size `cfg` gives, with
    the flash hook installed: the prefill [prefill_b, PREFILL_S] must
    launch the SSD, conv and gate kernels once a Mamba2 layer and nothing
    else;
    then the engine (when `engine`); then, with the weights cast to
    float32 in place, teacher-forced decode over TEACHER_LEN tokens
    against the kernel prefill's last logits (LOGIT_TOL_F32) -> the
    launch counts of one prefill."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import (attention, decode_step, forward,
                                    init_cache, init_model)
    from repro_torch.obs import Tracer
    from repro_torch.serve import Request, ServeEngine
    t_phase = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED)
    model = init_model(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (prefill_b, PREFILL_S))).to(dev)
    torch.cuda.synchronize()
    shared = (f", the shared GQA block ({cfg.n_heads}/{cfg.n_kv_heads} "
              f"heads of {cfg.d_head}, d_ff {cfg.d_ff}, window "
              f"{cfg.sliding_window}) after every {cfg.shared_attn_every}"
              if cfg.family == "hybrid" else "")
    say(tag, f"{cfg.name}: {n_params / 1e9:.3f}B params ({cfg.param_dtype}"
        f"), {cfg.n_layers} Mamba2 layers{shared}, d_model {cfg.d_model}, "
        f"d_inner {cfg.d_inner} = {cfg.n_ssm_heads} heads of "
        f"{cfg.ssm_headdim}, d_state {cfg.d_state}, chunk {cfg.chunk}, "
        f"vocab {cfg.vocab}; init {time.perf_counter() - t_phase:.2f} s")

    def prefill(toks=tokens):
        return forward(model, cfg, {"tokens": toks}, logits_mode="last")

    t0 = time.perf_counter()
    with torch.no_grad():
        flash_ops.install()
        try:
            reset_launch_counts()
            logits = prefill()
            torch.cuda.synchronize()
            launches = launch_counts()
            want = {**{k: 0 for k in launches}, "ssd": cfg.n_layers,
                    "ssd_tc": cfg.n_layers, "fused": cfg.n_layers,
                    "gate": cfg.n_layers, "norm": norm_launches(cfg)}
            if launches != want:
                raise RuntimeError(f"prefill launches {launches}, want "
                                   f"{want}")
            if tuple(logits.shape) != (prefill_b, 1, cfg.vocab) \
                    or not torch.isfinite(logits).all():
                raise RuntimeError(f"prefill: bad logits "
                                   f"{tuple(logits.shape)}")
            ms = device_times_ms(prefill, n=5)
            (wall, busy, n_ops, _, by_name), (call_ms, per, kern_n) = \
                profile_kernels(prefill, ssd_launched("tc", PREFILL_S,
                                                  cfg.chunk))
        finally:
            attention.set_flash_impl(None)
    ssd_total = sum(t for name, (t, _) in by_name.items()
                    if any(k in name for k in SSD_KERNEL_NAMES["tc"]))
    say(tag, f"(a) prefill [{prefill_b}, {PREFILL_S}] -> logits "
        f"{tuple(logits.shape)}: launches {launches}; {ms:.2f} ms (events); "
        f"profiled: {wall * 1e3:.2f} ms wall, device busy {busy * 1e3:.2f} "
        f"ms ({100 * busy / wall:.1f}%) in {n_ops} ops, the SSD op's "
        f"sub-kernels {ssd_total * 1e3:.2f} ms in all (>= {kern_n} "
        f"launches of each recorded; {_ms(call_ms)} ms a call: "
        f"{_sub_kernels(per)}); {prefill_b * PREFILL_S / ms:.0f} prompt "
        f"tokens/ms; phase {time.perf_counter() - t0:.1f} s")
    say(tag, "(a) prefill's longest device activities: "
        + top_activities(by_name))

    if engine:
        t0 = time.perf_counter()
        tr = Tracer()
        eng = ServeEngine(cfg, model, batch=ENGINE_BATCH,
                          max_len=ENGINE_MAX_LEN, tracer=tr, device=dev)
        lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                            ENGINE_REQUESTS)
        for rid, n in enumerate(lens):
            eng.submit(Request(rid=rid, prompt=rng.integers(
                0, cfg.vocab, int(n)).astype(np.int32),
                max_new_tokens=NEW_TOKENS))
        ticks = eng.run_until_drained()
        wall = time.perf_counter() - t0
        out = [len(r.out_tokens) for r in eng.done.values()]
        if sorted(eng.done) != list(range(ENGINE_REQUESTS)) \
                or out != [NEW_TOKENS + 1] * ENGINE_REQUESTS:
            raise RuntimeError(f"engine finished {sorted(eng.done)} with "
                               f"{out} tokens")
        sp = tr.span_times()
        toks = torch.zeros(ENGINE_BATCH, dtype=torch.int32, device=dev)
        wall_1, busy_1, n_ops_1, _, by_1 = device_busy(
            lambda: decode_step(model, cfg, eng.cache, toks, 0))
        say(tag, f"(b) engine: {ENGINE_REQUESTS} requests (prompts "
            f"{sorted(lens.tolist())}), {sum(out)} tokens out, {ticks} "
            f"ticks, {wall:.2f} s wall, {sum(out) / wall:.1f} tokens/s; "
            f"token-by-token prefill {sp.get('serve.prefill', 0):.2f} s "
            f"({int(lens.sum())} steps), decode ticks "
            f"{sp.get('serve.decode', 0):.2f} s")
        say(tag, f"(b) one profiled decode_step: {wall_1 * 1e3:.2f} ms "
            f"wall, device busy {busy_1 * 1e3:.3f} ms "
            f"({100 * busy_1 / wall_1:.1f}%) in {n_ops_1} ops; longest: "
            + top_activities(by_1, 3))

    t0 = time.perf_counter()
    prompt = tokens[:1, :TEACHER_LEN]
    with torch.no_grad():
        last_bf16 = prefill(prompt)[:, 0].float()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model.float()
    cache = init_cache(cfg32, 1, TEACHER_LEN, device=dev)
    for pos in range(TEACHER_LEN):
        step, cache = decode_step(model, cfg32, cache, prompt[:, pos], pos)
    reset_launch_counts()
    with torch.no_grad():
        last = forward(model, cfg32, {"tokens": prompt},
                       logits_mode="last")[:, 0]
    if launch_counts()["ssd"] != cfg.n_layers:
        raise RuntimeError("the teacher's prefill missed the SSD kernel")
    err = _logits_close("decode vs prefill (float32)", step, last,
                        LOGIT_TOL_F32)
    scale = float(last.abs().max())
    drift = float((last_bf16 - last).abs().max())
    say(tag, f"(c) float32 weights: teacher-forced decode_step (the "
        f"recurrence) over {TEACHER_LEN} tokens against the kernel "
        f"prefill's last logits: max abs err {err:.4g} ({err / scale:.3g} "
        f"of the range {scale:.4g}, tol {LOGIT_TOL_F32:g}); the bf16 "
        f"kernel prefill is {drift:.4g} ({drift / scale:.3g}) from the "
        f"float32 one; {time.perf_counter() - t0:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def _family_batch(cfg, rng, dev):
    """A prefill's inputs: tokens [PREFILL_B, PREFILL_S]; for encdec also
    stub frame embeddings [PREFILL_B, PREFILL_S, d] (the reference's
    prefill specs give both the same length)."""
    b, s = PREFILL_B, PREFILL_S
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                                        ).to(dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model), np.float32)).to(dev)
    return batch


def _patch_grid_batch(cfg, rng, dev):
    """qwen2-vl's prefill from embeddings: [PREFILL_B, PREFILL_S, d] of
    VLM_TEXT_BEFORE text tokens, one image of VLM_GRID merged patches and
    text to PREFILL_S (stub embeddings, normal at the embedding table's
    init scale of 0.02), and positions3 [3, B, S] as Qwen2-VL numbers
    them: text at (i, i, i); after L text tokens a patch at (L, L + row,
    L + col); text after the image from one past the largest position
    before it.  -> (batch, the largest position)."""
    b, s = PREFILL_B, PREFILL_S
    (gh, gw), before = VLM_GRID, VLM_TEXT_BEFORE
    end = before + gh * gw
    pos = np.empty((3, s), np.int64)
    pos[:, :before] = np.arange(before)
    rows, cols = np.divmod(np.arange(gh * gw), gw)
    pos[:, before:end] = before + np.stack([0 * rows, rows, cols])
    pos[:, end:] = pos[:, :end].max() + 1 + np.arange(s - end)
    embeds = 0.02 * rng.standard_normal((b, s, cfg.d_model), np.float32)
    return ({"embeds": torch.from_numpy(embeds).to(dev),
             "positions3": torch.from_numpy(pos).to(dev)[:, None].expand(
                 3, b, s)}, int(pos.max()))


@contextlib.contextmanager
def _routing_recorded(choices: list, pinned=None):
    """Appends each MoE layer's top-k expert ids [T, k] to `choices`, in
    call order, while the block runs; with `pinned` (the `choices` of an
    earlier run) each layer takes that run's experts instead of its own,
    its gate weights renormalised from its own router probabilities as
    `moe._route` does."""
    from repro_torch.models import moe
    route = moe._route

    def recording(xt, router, cfg):
        probs, top_p, top_i = route(xt, router, cfg)
        if pinned is not None:
            top_i = pinned[len(choices)]
            top_p = probs.gather(-1, top_i)
            top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True),
                                            1e-9)
        choices.append(top_i)
        return probs, top_p, top_i
    moe._route = recording
    try:
        yield
    finally:
        moe._route = route


def _routing_flips(choices_a, choices_b):
    """-> [(MoE layer, tokens whose top-k expert set differs)] for each
    layer where the two runs route any token differently."""
    flips = []
    for i, (a, b) in enumerate(zip(choices_a, choices_b)):
        n = int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
        if n:
            flips.append((i, n))
    return flips


def _prefill_routed(model, cfg, batch, flash_ops=None, pinned=None):
    """-> (logits of the last position, each MoE layer's top-k expert
    ids), with the flash hook installed if `flash_ops` is given, and every
    MoE layer taking the experts `pinned` if given (`_routing_recorded`)."""
    from repro_torch.models import attention, forward
    choices = []
    with torch.no_grad():
        if flash_ops is not None:
            flash_ops.install()
        try:
            with _routing_recorded(choices, pinned):
                logits = forward(model, cfg, batch, logits_mode="last")
        finally:
            attention.set_flash_impl(None)
    return logits, choices


def _flash_vs_plain(model, cfg, batch, flash_ops, pin: bool = False):
    """-> (flash logits, plain logits) of the last position, and the
    routing flips between the two runs (`_routing_flips`) with the number
    of MoE layers.  `pin`: the flash run takes the plain run's experts in
    every MoE layer."""
    plain, choices_p = _prefill_routed(model, cfg, batch)
    fused, choices_f = _prefill_routed(model, cfg, batch, flash_ops,
                                       choices_p if pin else None)
    return fused, plain, _routing_flips(choices_f, choices_p), len(choices_f)


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def family_phase(dev, arch: str) -> dict:
    """One configuration at full width and depth: init on the card, the
    prefill [PREFILL_B, PREFILL_S] with the flash hook installed (launches
    must be FAMILY_FLASH[arch], all on the tensor-core route, and nothing
    else),
    timed; flash against plain attention within LOGIT_TOL (where the bf16
    logits miss and the two runs' top-k expert sets show that bf16
    rounding in attention flipped a routing choice: with the flash run's
    experts pinned to the plain run's, and on a float32 copy, route
    "simt", within LOGIT_TOL_F32);
    for `vlm` the same from embeddings and positions3 of a patch grid; the
    engine under the serve phase's load -> the flash launches of one
    prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import (attention, decode_step, forward,
                                    init_model)
    from repro_torch.obs import Tracer
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config(arch)
    tag = "families"
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, torch.Generator(dev).manual_seed(SEED),
                       device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    n_params = sum(p.numel() for p in model.parameters())
    mrope = (f", M-RoPE {cfg.mrope_sections}" if cfg.rope == "mrope"
             else "")
    attn_desc = (f"MLA ({cfg.n_heads} heads, q/k {cfg.qk_nope_dim}+"
                 f"{cfg.qk_rope_dim}, v {cfg.v_head_dim}, kv_lora "
                 f"{cfg.kv_lora_rank}, q_lora {cfg.q_lora_rank})"
                 if cfg.attn == "mla" else
                 f"GQA {cfg.n_heads}/{cfg.n_kv_heads} heads of "
                 f"{cfg.d_head}{mrope}")
    mlp_desc = (f"{cfg.n_experts} experts of {cfg.d_expert} top-{cfg.top_k}"
                f", {cfg.n_shared_experts} shared, first "
                f"{cfg.first_dense_layers} dense ({cfg.d_ff_dense})"
                if cfg.family == "moe" else f"MLP {cfg.d_ff} {cfg.act}")
    depth = (f"{cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers"
             if cfg.family == "encdec" else f"{cfg.n_layers} layers")
    say(tag, f"{arch} ({cfg.family}): {n_params / 1e9:.3f}B params "
        f"({cfg.param_dtype}), {depth} (full depth), d_model "
        f"{cfg.d_model}, {attn_desc}, {mlp_desc}, vocab {cfg.vocab}"
        f"{'' if cfg.tie_embeddings else ' (untied head)'}; init "
        f"{init_s:.2f} s, max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({held:.2f} "
        f"GiB allocated before it)")

    rng = np.random.default_rng(SEED)
    batch = _family_batch(cfg, rng, dev)
    prefill = lambda: forward(model, cfg, batch, logits_mode="last")
    want_flash = FAMILY_FLASH[arch]
    with torch.no_grad():
        flash_ops.install()
        try:
            reset_launch_counts()
            logits = prefill()
            torch.cuda.synchronize()
            launches = launch_counts()
            want = {**{k: 0 for k in launches}, "flash": want_flash,
                    "flash_wgmma": want_flash, "norm": norm_launches(cfg)}
            if launches != want:
                raise RuntimeError(f"{arch} prefill launches {launches}, "
                                   f"want {want}")
            if tuple(logits.shape) != (PREFILL_B, 1, cfg.vocab) \
                    or not torch.isfinite(logits).all():
                raise RuntimeError(f"{arch} prefill: bad logits "
                                   f"{tuple(logits.shape)}")
            ms = device_times_ms(prefill, n=5)
            host_ms, enqueue_ms = host_times_ms(prefill)
            wall, busy, n_ops, _, by_name = device_busy(prefill)
        finally:
            attention.set_flash_impl(None)
    peak = torch.cuda.max_memory_allocated() / 2**30
    shape = (f"frames [{PREFILL_B}, {PREFILL_S}, {cfg.d_model}] + tokens "
             if cfg.family == "encdec" else "tokens ")
    say(tag, f"{arch} (a) prefill {shape}[{PREFILL_B}, {PREFILL_S}] -> "
        f"logits {tuple(logits.shape)}: flash launches "
        f"{launches['flash']} (wgmma {launches['flash_wgmma']}, simt "
        f"{launches['flash'] - launches['flash_wgmma']}; want "
        f"{want_flash} on wgmma); {ms:.2f} ms by events, "
        f"{host_ms:.2f} ms by the host clock ({enqueue_ms:.2f} ms of it to "
        f"enqueue); "
        f"profiled: {wall * 1e3:.2f} ms wall, device busy "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%) in {n_ops} ops; "
        f"{PREFILL_B * PREFILL_S / ms:.0f} prompt tokens/ms; max memory "
        f"allocated {peak:.2f} GiB")
    say(tag, f"{arch} (a) prefill's longest device activities: "
        + top_activities(by_name))

    compare_fp32 = False
    if want_flash:
        fused, plain, flips, n_moe = _flash_vs_plain(model, cfg, batch,
                                                     flash_ops)
        scale = float(plain.float().abs().max())
        err = float((fused.float() - plain.float()).abs().max())
        if err <= LOGIT_TOL * scale:
            say(tag, f"{arch} flash against plain attention, bf16: max abs "
                f"err {err:.4g} (logits up to {scale:.4g}, tol "
                f"{LOGIT_TOL:g} of it); max memory allocated through the "
                f"plain run {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                f" GiB")
        elif not flips:     # no MoE layer, or the same routing: a fault
            _logits_close(f"{arch} flash vs plain", fused, plain)
        else:
            compare_fp32 = True
            say(tag, f"{arch} flash against plain attention, bf16: max abs "
                f"err {err:.4g} > {LOGIT_TOL:g} x {scale:.4g}; the two "
                f"runs' top-k expert sets differ in {len(flips)} of "
                f"{n_moe} MoE layers, first in layer {flips[0][0]} "
                f"({flips[0][1]} of {PREFILL_B * PREFILL_S} tokens), "
                f"tokens differing by layer {[n for _, n in flips]}: bf16 "
                f"rounding in attention flips routing choices; compared "
                f"on a float32 copy after the engine")
            fused, plain, _, _ = _flash_vs_plain(model, cfg, batch,
                                                 flash_ops, pin=True)
            pinned_err = _max_abs(fused, plain)
    if cfg.family == "vlm":
        vbatch, top = _patch_grid_batch(cfg, rng, dev)
        reset_launch_counts()
        fused, plain, _, _ = _flash_vs_plain(model, cfg, vbatch, flash_ops)
        launches_v = launch_counts()
        # two prefills, the plain one without flash
        want_v = {**want, "norm": 2 * want["norm"]}
        if launches_v != want_v:
            raise RuntimeError(f"{arch} prefill from embeds launches "
                               f"{launches_v}, want {want_v}")
        err = _logits_close(f"{arch} flash vs plain from embeds", fused,
                            plain)
        flat = {**vbatch, "positions3": torch.arange(
            PREFILL_S, device=dev).expand(3, PREFILL_B, PREFILL_S)}
        with torch.no_grad():
            moved = float((forward(model, cfg, flat, logits_mode="last")
                           .float() - plain.float()).abs().max())
        if not moved > 0:
            raise RuntimeError(f"{arch}: positions3 of a patch grid give "
                               f"the logits of 1-D positions")
        gh, gw = VLM_GRID
        say(tag, f"{arch} (a) prefill from embeds [{PREFILL_B}, "
            f"{PREFILL_S}, {cfg.d_model}] and positions3 of a patch grid "
            f"({VLM_TEXT_BEFORE} text, a {gh} x {gw} image, "
            f"{PREFILL_S - VLM_TEXT_BEFORE - gh * gw} text; positions up "
            f"to {top}): flash launches {launches_v['flash']} (wgmma "
            f"{launches_v['flash_wgmma']}); against plain max abs err "
            f"{err:.4g} (logits up to {float(plain.float().abs().max()):.4g}"
            f", tol {LOGIT_TOL:g} of it); 1-D positions move the plain "
            f"logits by {moved:.4g}")

    tr = Tracer()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, model, batch=ENGINE_BATCH, max_len=ENGINE_MAX_LEN,
                      tracer=tr, device=dev)
    n_req = FAMILY_ENGINE_REQUESTS.get(arch, ENGINE_REQUESTS)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                        ENGINE_REQUESTS)[:n_req]
    for rid, n in enumerate(lens):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, int(n)).astype(np.int32),
            max_new_tokens=NEW_TOKENS))
    ticks = eng.run_until_drained()
    wall = time.perf_counter() - t0
    out = [len(r.out_tokens) for r in eng.done.values()]
    if sorted(eng.done) != list(range(n_req)) \
            or out != [NEW_TOKENS + 1] * n_req:
        raise RuntimeError(f"{arch} engine finished {sorted(eng.done)} "
                           f"with {out} tokens")
    sp = tr.span_times()
    decoded = tr.metrics.snapshot()["counters"]["serve.tokens_decoded"]
    toks = torch.zeros(ENGINE_BATCH, dtype=torch.int32, device=dev)
    wall_1, busy_1, n_ops_1, _, by_1 = device_busy(
        lambda: decode_step(model, cfg, eng.cache, toks, 0))
    cut = ("" if n_req == ENGINE_REQUESTS else
           f" (the first {n_req} of the serve phase's {ENGINE_REQUESTS}: "
           f"the MLA engines are cut to keep the smoke in its time)")
    say(tag, f"{arch} (b) engine: {n_req} requests{cut} "
        f"(prompts {sorted(lens.tolist())}), {sum(out)} tokens out "
        f"({decoded:.0f} from decode ticks), {ticks} ticks, {wall:.2f} s "
        f"wall, {sum(out) / wall:.1f} tokens/s; token-by-token prefill "
        f"{sp.get('serve.prefill', 0):.2f} s ({int(lens.sum())} steps), "
        f"decode ticks {sp.get('serve.decode', 0):.2f} s "
        f"({decoded / sp.get('serve.decode', float('nan')):.1f} tokens/s); "
        f"one profiled decode_step: "
        f"{wall_1 * 1e3:.2f} ms wall, device busy {busy_1 * 1e3:.3f} ms "
        f"({100 * busy_1 / wall_1:.1f}%) in {n_ops_1} ops; longest: "
        + top_activities(by_1, 3))
    del eng

    if compare_fp32:
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        model.float()
        plain, choices32 = _prefill_routed(model, cfg32, batch)
        reset_launch_counts()
        fused, choices = _prefill_routed(model, cfg32, batch, flash_ops)
        launches32 = launch_counts()
        if launches32["flash"] != want_flash or launches32["flash_wgmma"]:
            raise RuntimeError(f"{arch} float32 prefill launches "
                               f"{launches32}, want simt {want_flash}")
        err = _logits_close(f"{arch} flash vs plain (float32)", fused,
                            plain, tol=LOGIT_TOL_F32)
        flips = _routing_flips(choices, choices32)
        scale = float(plain.abs().max())
        say(tag, f"{arch} flash against plain attention on a float32 copy "
            f"({launches32['flash']} launches on simt): max abs err "
            f"{err:.4g} (logits up to {scale:.4g}, tol {LOGIT_TOL_F32:g} "
            f"of it); top-k expert sets differ in {len(flips)} of "
            f"{len(choices)} MoE layers, tokens differing by layer "
            f"{[n for _, n in flips]}")
        # what the bf16 miss is made of: the same prefills in bf16 (the
        # weights cast back, exactly) with every MoE layer's experts
        # pinned to the float32 plain run's, against its logits
        model.to(getattr(torch, cfg.param_dtype))
        drift = {name: _max_abs(_prefill_routed(model, cfg, batch, ops,
                                                choices32)[0], plain)
                 for name, ops in (("plain", None), ("flash", flash_ops))}
        say(tag, f"{arch} bf16 with the routing pinned: flash against plain"
            f" {pinned_err:.4g} (the flash run's experts pinned to the "
            f"plain run's); plain {drift['plain']:.4g} and flash "
            f"{drift['flash']:.4g} from the float32 plain logits (the "
            f"experts of its run; range {scale:.4g}): bf16 rounding "
            f"through {cfg.n_layers} layers, measured, not held to a "
            f"tolerance")
    del model
    torch.cuda.empty_cache()
    say(tag, f"{arch}: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# The train phase: the port's training driver (`launch/train.py`) at full
# width and depth, bf16 params with float32 master copies.  The reference
# trains on its plain paths (no flash hook; Mamba2 on its differentiable
# scan), so no kernel may launch here.  Model FLOPs of one step (PaLM,
# arXiv:2204.02311 app. B): tokens x (6 N + 12 L H hd S), N every
# parameter (the tied head is the embedding's matmul use), remat's
# recomputation not counted.
TRAIN_ARCH = "smollm-135m"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 2048, 8, 2
TRAIN_REMAT = "dots_no_batch"
# (the mesh path's host time is up to ~2x the plain step's)
TRAIN_STEPS, TRAIN_RESUME_STEPS = 8, 10
# (b): microbatches 1 against 2 as the reference's contract states them
# (loss relative, params absolute); remat modes and a restored state
# against the live one: loss relative (CUDA's embedding backward adds
# with atomics, so two runs differ in the last bits)
TRAIN_LOSS_RTOL, TRAIN_PARAM_TOL = 1e-3, 5e-3
TRAIN_REMAT_MODES = ("none", "full", "dots_no_batch")
# (c): mamba2-2.7b at full width, 2 of its 64 layers, [2, 512]
TRAIN_SSM_LAYERS, TRAIN_SSM_SEQ, TRAIN_SSM_BATCH = 2, 512, 2


def model_flops(cfg, n_params: int, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step over `tokens` tokens of length
    `seq` (the PaLM count above)."""
    return tokens * (6 * n_params + 12 * cfg.n_layers * cfg.n_heads
                     * cfg.d_head * seq)


def _no_kernel_launched(what: str) -> None:
    counts = launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"{what} launched kernels {counts}; the "
                           f"training path has no kernel")


def _clone_state(state):
    from repro_torch.train.train_step import TrainState
    return TrainState(copy.deepcopy(state.params), copy.deepcopy(state.opt),
                      copy.deepcopy(state.compress_err))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def train_phase(dev):
    """(a) `train_loop` on TRAIN_ARCH at full width and depth, TRAIN_STEPS
    steps into a temporary checkpoint directory, then again to
    TRAIN_RESUME_STEPS (it must resume and run the rest); losses finite
    and falling; step walls, device times, tokens/s, model FLOP share,
    peak memory, one profiled step, checkpoint bytes and times.  (b) at
    the same shape through `make_train_step`: microbatches 1 against 2,
    the remat modes against each other (with their peak memory and step
    time), and a
    saved and restored state against the live one.  (c) mamba2-2.7b, 2
    layers at full width: one train step (the model's scan, no SSD
    launch), and `lm_loss` on the kernel (no grad) against the scan
    (grad) in float32."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import ensure_process_group
    from repro_torch.models import init_model, lm_loss
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import (TrainConfig, TrainState,
                                              make_train_step)
    tag = "train"
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steps, ckpt_times = [], {"copy": [], "write": [], "restore": []}
    real = (launch_train.build_train_step, ckpt.save, ckpt.restore,
            ckpt.AsyncCheckpointer.save_async)

    def timed_build(*args, **kwargs):
        step, shapes, placements = real[0](*args, **kwargs)

        def timed(state, batch):
            a, b = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            a.record()
            out = step(state, batch)
            b.record()
            b.synchronize()
            steps.append((time.perf_counter() - t0, a.elapsed_time(b),
                          step, state, batch))
            return out
        return timed, shapes, placements

    def timer(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            ckpt_times[key].append(time.perf_counter() - t0)
            return out
        return run

    # the phase owns the process group (NCCL, a world of one), so that the
    # profiled step below still has it after train_loop returns
    ensure_process_group(dev)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        launch_train.build_train_step = timed_build
        ckpt.save = timer("write", real[1])
        ckpt.restore = timer("restore", real[2])
        ckpt.AsyncCheckpointer.save_async = timer("copy", real[3])
        try:
            kw = dict(arch=TRAIN_ARCH, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, reduced=False,
                      microbatches=TRAIN_MICRO, remat=TRAIN_REMAT,
                      ckpt_dir=tmp, log_every=4, device=dev)
            first = launch_train.train_loop(steps=TRAIN_STEPS, **kw)
            n_first = len(steps)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ckpt_bytes = sum(f.stat().st_size for f in Path(
                tmp, f"step_{TRAIN_STEPS}").iterdir())
            rest = launch_train.train_loop(steps=TRAIN_RESUME_STEPS, **kw)
        finally:
            (launch_train.build_train_step, ckpt.save, ckpt.restore,
             ckpt.AsyncCheckpointer.save_async) = real
        _no_kernel_launched("train_loop")
        losses = first + rest
        if len(first) != TRAIN_STEPS \
                or len(rest) != TRAIN_RESUME_STEPS - TRAIN_STEPS \
                or len(ckpt_times["restore"]) != 1:
            raise RuntimeError(f"train_loop ran {len(first)} then "
                               f"{len(rest)} steps, restored "
                               f"{len(ckpt_times['restore'])} times")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"losses {losses}")
        _, _, step_fn, state, batch = steps[-1]
        wall, busy, n_ops, _, by_name = device_busy(
            lambda: step_fn(state, batch))
        mesh_step_ms, mesh_enqueue_ms = host_times_ms(
            lambda: step_fn(state, batch), n=3)
        step_ms, enqueue_ms = host_times_ms(lambda: step_fn(state, batch),
                                            n=3)
    host = [s[0] for s in steps[1:n_first]]
    dev_ms = [s[1] for s in steps[1:n_first]]
    n_params = sum(p.numel() for p in state.params.parameters())
    first_loss = first[0]
    flops = model_flops(cfg, n_params, tokens, TRAIN_SEQ)
    wall_med = statistics.median(host)
    share = flops / wall_med / PEAK_FLOP_PER_S[torch.bfloat16]
    writes = ", ".join(f"{t:.2f}" for t in ckpt_times["write"])
    say(tag, f"(a) train_loop on the (1, 1) mesh path (DTensor, NCCL world "
        f"of one) {TRAIN_ARCH} full width and depth "
        f"({n_params / 1e6:.1f}M params, {cfg.param_dtype} + float32 "
        f"master), [{TRAIN_BATCH}, {TRAIN_SEQ}] in {TRAIN_MICRO} "
        f"microbatches, remat {TRAIN_REMAT}: {TRAIN_STEPS} steps, then "
        f"resumed at step {TRAIN_STEPS} for {len(rest)}; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; no kernel launched")
    say(tag, f"(a) step (median of steps 1-{n_first - 1}): "
        f"{wall_med * 1e3:.1f} ms host clock, "
        f"{statistics.median(dev_ms):.1f} ms between CUDA events; first "
        f"step {steps[0][0] * 1e3:.1f} ms; {tokens / wall_med:.0f} "
        f"tokens/s; model FLOPs {flops:.4g} a step = tokens x (6 N + 12 L "
        f"H hd S), {flops / wall_med / 1e12:.1f} TFLOP/s = "
        f"{100 * share:.2f}% of the bf16 dense peak (989 TFLOP/s); peak "
        f"{peak:.2f} GiB allocated")
    say(tag, f"(a) one profiled step: {wall * 1e3:.1f} ms wall, device busy "
        f"{busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%; "
        f"{100 * busy * 1e3 / step_ms:.1f}% of an unprofiled step's "
        f"{step_ms:.1f} ms, of which the host takes {enqueue_ms:.1f} ms to "
        f"enqueue) in {n_ops} ops; longest: " + top_activities(by_name))
    say(tag, f"(a) checkpoint: {ckpt_bytes / 2 ** 30:.3f} GiB a step "
        f"({len(ckpt_times['write'])} saves); copy to host "
        f"{', '.join(f'{t:.2f}' for t in ckpt_times['copy'])} s (the "
        f"loop waits), write {writes} s (a thread); restore "
        f"{ckpt_times['restore'][0]:.2f} s")
    del state, step_fn, steps

    # (b) invariants through make_train_step at the same shape
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator().manual_seed(SEED), device=dev)
    opt_cfg = OptConfig(warmup_steps=5, total_steps=TRAIN_STEPS)
    base = TrainState(model, init_opt_state(opt_cfg, model))
    data = make_source(DataConfig(seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, vocab=cfg.vocab))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()} for i in range(2)]
    reset_launch_counts()
    out = {}
    for mb in (1, TRAIN_MICRO):
        st = _clone_state(base)
        step = make_train_step(cfg, opt_cfg, TrainConfig(
            remat=TRAIN_REMAT, microbatches=mb))
        st, m = step(st, batches[0])
        out[mb] = (float(m["loss"]), st)
    (l1, s1), (l2, s2) = out[1], out[TRAIN_MICRO]
    p_err = max(float((a - b).detach().abs().max()) for a, b in zip(
        s1.params.parameters(), s2.params.parameters()))
    w_err = max(float((s1.opt.master[n] - s2.opt.master[n]).abs().max())
                for n in s1.opt.master)
    if _rel(l2, l1) > TRAIN_LOSS_RTOL or p_err > TRAIN_PARAM_TOL:
        raise RuntimeError(f"microbatches 1 vs {TRAIN_MICRO}: loss {l1} vs "
                           f"{l2}, params {p_err}")
    # (a)'s first step: the same state, batch, schedule and microbatches
    if _rel(first_loss, l2) > TRAIN_LOSS_RTOL:
        raise RuntimeError(f"the (1, 1) mesh path's first loss {first_loss} "
                           f"vs the plain step's {l2}")
    del out, s2
    peaks, remat_loss, remat_ms = {}, {}, {}
    for mode in TRAIN_REMAT_MODES:
        st = _clone_state(base)
        step = make_train_step(cfg, opt_cfg, TrainConfig(
            remat=mode, microbatches=TRAIN_MICRO))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st, m = step(st, batches[0])
        remat_loss[mode] = float(m["loss"])
        peaks[mode] = torch.cuda.max_memory_allocated() / 2 ** 30
        # a second step, timed: its wall and the part spent enqueueing
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, m = step(st, batches[1])
        t_enq = time.perf_counter() - t1
        float(m["loss"])
        remat_ms[mode] = ((time.perf_counter() - t1) * 1e3, t_enq * 1e3)
        del st
    bad = [k for k, v in remat_loss.items()
           if _rel(v, remat_loss["none"]) > TRAIN_LOSS_RTOL]
    if bad:
        raise RuntimeError(f"remat losses {remat_loss}")
    plain_ms, plain_enq = remat_ms[TRAIN_REMAT]
    say(tag, f"(a) vs (b): first loss on the (1, 1) mesh path "
        f"{first_loss:.6f}, plain make_train_step {l2:.6f} (rel "
        f"{_rel(first_loss, l2):.2e}, tol {TRAIN_LOSS_RTOL:g}); a step at "
        f"[{TRAIN_BATCH}, {TRAIN_SEQ}], {TRAIN_MICRO} microbatches, remat "
        f"{TRAIN_REMAT}: mesh path {mesh_step_ms:.1f} ms "
        f"({mesh_enqueue_ms:.1f} to enqueue), plain {plain_ms:.1f} ms "
        f"({plain_enq:.1f} to enqueue) (host clock, from an idle device)")
    step = make_train_step(cfg, opt_cfg, TrainConfig(
        remat=TRAIN_REMAT, microbatches=TRAIN_MICRO))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save(tmp, 1, s1.leaves())
        other = init_model(cfg, torch.Generator(dev).manual_seed(SEED + 1),
                           device=dev)
        fresh = TrainState(other, init_opt_state(opt_cfg, other))
        fresh.load_leaves(ckpt.restore(tmp, 1, fresh.leaves()))
    live, back = s1.leaves(), fresh.leaves()
    unequal = [k for k in live if not torch.equal(live[k], back[k])]
    if unequal or fresh.opt.step != s1.opt.step:
        raise RuntimeError(f"restored leaves differ: {unequal[:5]}")
    _, m_live = step(s1, batches[1])
    _, m_back = step(fresh, batches[1])
    l_live, l_back = float(m_live["loss"]), float(m_back["loss"])
    if _rel(l_back, l_live) > TRAIN_LOSS_RTOL:
        raise RuntimeError(f"restored state's next loss {l_back} vs "
                           f"{l_live}")
    _no_kernel_launched("the invariants")
    say(tag, f"(b) microbatches 1 vs {TRAIN_MICRO}: loss {l1:.6f} vs "
        f"{l2:.6f} (rel {_rel(l2, l1):.2e}, tol {TRAIN_LOSS_RTOL:g}), "
        f"params max |diff| {p_err:.3g} (tol {TRAIN_PARAM_TOL:g}), float32 "
        f"masters {w_err:.3g}; remat "
        + ", ".join(f"{k} loss {remat_loss[k]:.6f} peak {peaks[k]:.2f} GiB"
                    f" step {remat_ms[k][0]:.1f} ms ({remat_ms[k][1]:.1f} "
                    f"to enqueue)" for k in TRAIN_REMAT_MODES)
        + f"; saved and restored state: {len(live)} leaves bit-equal, next "
        f"loss {l_back:.6f} vs live {l_live:.6f} (rel "
        f"{_rel(l_back, l_live):.2e}); {time.perf_counter() - t0:.1f} s")
    del base, s1, fresh, model, other, live, back

    # (c) Mamba2 under autograd on the card
    t0 = time.perf_counter()
    scfg = dataclasses.replace(get_config(SSM_ARCH),
                               n_layers=TRAIN_SSM_LAYERS)
    smodel = init_model(scfg, torch.Generator(dev).manual_seed(SEED),
                        device=dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, scfg.vocab, (TRAIN_SSM_BATCH, TRAIN_SSM_SEQ))).to(dev)
    sstate = TrainState(smodel, init_opt_state(OptConfig(), smodel))
    reset_launch_counts()
    _, m = make_train_step(scfg, OptConfig(), TrainConfig(
        remat=TRAIN_REMAT))(sstate, {"tokens": toks})
    gnorm = float(m["grad_norm"])
    if not np.isfinite(gnorm) or not np.isfinite(float(m["loss"])):
        raise RuntimeError(f"mamba2 train step: loss {m['loss']}, grad norm "
                           f"{gnorm}")
    _no_kernel_launched("the mamba2 train step")
    scfg32 = dataclasses.replace(scfg, param_dtype="float32",
                                 compute_dtype="float32")
    smodel.float()
    with torch.no_grad():
        on_kernel = float(lm_loss(smodel, scfg32, {"tokens": toks}))
    kernel_calls = launch_counts()
    reset_launch_counts()
    on_scan = float(lm_loss(smodel, scfg32, {"tokens": toks}).detach())
    _no_kernel_launched("lm_loss under autograd")
    if kernel_calls["ssd"] != TRAIN_SSM_LAYERS \
            or kernel_calls["ssd_tc"] != TRAIN_SSM_LAYERS:
        raise RuntimeError(f"lm_loss under no_grad launched {kernel_calls}")
    if _rel(on_kernel, on_scan) > SSD_TOL:
        raise RuntimeError(f"mamba2 lm_loss: kernel {on_kernel} vs scan "
                           f"{on_scan}")
    say(tag, f"(c) {SSM_ARCH} at full width, {TRAIN_SSM_LAYERS} layers, "
        f"[{TRAIN_SSM_BATCH}, {TRAIN_SSM_SEQ}]: a train step (the model's "
        f"scan) loss {float(m['loss']):.4f}, grad norm {gnorm:.4g}, no SSD "
        f"launch; float32 lm_loss on the kernel (no grad, "
        f"{kernel_calls['ssd_tc']} launches on \"tc\") {on_kernel:.7f} vs the "
        f"scan (grad) {on_scan:.7f}: rel {_rel(on_kernel, on_scan):.2e} "
        f"(tol {SSD_TOL:g}); {time.perf_counter() - t0:.1f} s")
    say(tag, f"phase {time.perf_counter() - t_phase:.1f} s")


# Phase 15: the sharded builders on a (1, 1) mesh; the dry-run cell runs
# on the host (fake process group, meta tensors), one microbatch
PARALLEL_DECODE_STEPS, PARALLEL_MAX_LEN = 8, 64
PARALLEL_DRYRUN = ("smollm-135m", "train_4k")


def parallel_phase(dev) -> int:
    """smollm-135m at full width and depth on a (1, 1) `DeviceMesh`: the
    sharded prefill through the flash kernel on local shards against the
    unsharded one, sharded decode steps against `decode_step`, the host's
    enqueue time of each; then one dry-run cell on the host.  -> the
    flash launches of the sharded prefill."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import (attention, decode_step, forward,
                                    init_cache, init_model)
    from repro_torch.parallel.sharding import make_rules
    tag = "parallel"
    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    mesh = make_mesh((1, 1), ("data", "model"), device=dev)
    rules = make_rules(mesh)
    model = init_model(cfg, torch.Generator().manual_seed(SEED), device=dev)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S))).to(dev)
    spec = ShapeSpec("prefill", PREFILL_S, PREFILL_B, "prefill")
    prefill, _, (p_pl, _) = steps.build_prefill_step(cfg, mesh, rules, spec)
    sharded = steps.init_sharded_params(
        cfg, mesh, p_pl, device=dev,
        generator=torch.Generator().manual_seed(SEED))
    run_sharded = lambda: prefill(sharded, {"tokens": tokens})
    run_plain = lambda: forward(model, cfg, {"tokens": tokens},
                                logits_mode="last")
    with torch.no_grad():
        ops.install()
        try:
            reset_launch_counts()
            got = run_sharded().full_tensor()
            torch.cuda.synchronize()
            launches = launch_counts()
            if launches["flash"] != cfg.n_layers \
                    or launches["flash_wgmma"] != cfg.n_layers \
                    or launches["single"] or launches["multi"] \
                    or launches["ssd"] \
                    or launches["norm"] != norm_launches(cfg):
                raise RuntimeError(f"sharded prefill launches {launches}, "
                                   f"want flash=flash_wgmma={cfg.n_layers}, "
                                   f"norm={norm_launches(cfg)}")
            want = run_plain()
            pre_err = _logits_close("sharded prefill", got, want)
            s_ms, s_enq = host_times_ms(run_sharded, n=3)
            p_ms, p_enq = host_times_ms(run_plain, n=3)
        finally:
            attention.set_flash_impl(None)
    say(tag, f"(a) build_prefill_step {cfg.name} full width and depth on a "
        f"(1, 1) mesh, [{PREFILL_B}, {PREFILL_S}]: flash launches "
        f"{launches['flash']} ({launches['flash_wgmma']} on \"wgmma\", on "
        f"local shards through local_map); logits {tuple(got.shape)} vs "
        f"the unsharded prefill max abs err {pre_err:.4g} (tol {LOGIT_TOL} "
        f"of the range); host clock a call: sharded {s_ms:.2f} ms "
        f"({s_enq:.2f} to enqueue), plain {p_ms:.2f} ms ({p_enq:.2f} to "
        f"enqueue)")

    dspec = ShapeSpec("decode", PARALLEL_MAX_LEN, PREFILL_B, "decode")
    serve, _, (_, c_pl, _) = steps.build_decode_step(cfg, mesh, rules, dspec)
    cache = init_cache(cfg, PREFILL_B, PARALLEL_MAX_LEN, device=dev)
    s_cache = steps.place_tree(init_cache(cfg, PREFILL_B, PARALLEL_MAX_LEN,
                                          device=dev), c_pl, mesh)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PARALLEL_DECODE_STEPS, PREFILL_B))).to(dev)
    errs = []
    for i in range(PARALLEL_DECODE_STEPS):
        with torch.no_grad():
            lg, s_cache = serve(sharded, s_cache, toks[i], i)
            ref, cache = decode_step(model, cfg, cache, toks[i], i)
        errs.append(_logits_close(f"sharded decode step {i}",
                                  lg.full_tensor(), ref))
    pos = PARALLEL_DECODE_STEPS
    ds_ms, ds_enq = host_times_ms(
        lambda: serve(sharded, s_cache, toks[0], pos), n=3)
    dp_ms, dp_enq = host_times_ms(
        lambda: decode_step(model, cfg, cache, toks[0], pos), n=3)
    say(tag, f"(b) build_decode_step: {PARALLEL_DECODE_STEPS} steps at batch "
        f"{PREFILL_B} against decode_step, max abs err "
        f"{max(errs):.4g} (tol {LOGIT_TOL} of the range); host clock a "
        f"step: sharded {ds_ms:.2f} ms ({ds_enq:.2f} to enqueue), plain "
        f"{dp_ms:.2f} ms ({dp_enq:.2f} to enqueue)")
    del sharded, s_cache, cache, model
    dist.destroy_process_group()      # the dry-run has its own fake group

    arch, shape = PARALLEL_DRYRUN
    cell = dryrun.run_cell(arch, shape, multi_pod=False, microbatches=1)
    r = cell["roofline"]
    say(tag, f"(c) dry-run {arch} {shape} on the fake 16 x 16 mesh (host "
        f"only, one microbatch): traced in {cell['trace_s']:.1f} s; per "
        f"device {r['flops_per_device']:.4g} FLOPs, "
        f"{r['bytes_per_device']:.4g} bytes, {r['collective_bytes']:.4g} "
        f"collective bytes; compute {r['compute_s']:.4g} s, memory "
        f"{r['memory_s']:.4g} s, collective {r['collective_s']:.4g} s "
        f"(H100 constants) -> {r['bottleneck']}; useful ratio "
        f"{r['useful_ratio']:.4g}; args {cell['memory']['argument_bytes']} "
        f"B, saved for backward {cell['memory']['temp_bytes']} B a device")
    say(tag, f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches["flash_wgmma"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import alexnet_cifar, analyze, generate_arch_space
    from repro_torch.core.explorer import _workload_key
    t_start = time.perf_counter()
    smi = device_phase()
    device_busy(lambda: torch.ones(1, device="cuda").sum())  # CUPTI warm-up
    build_phase()
    dev = torch.device("cuda", 0)
    task = analyze(alexnet_cifar(batch_size=TASK_BATCH))
    distinct = list({_workload_key(w): w for w in task.intra}.values())
    archs = list(generate_arch_space(**ARCH_SPACE))
    say("setup", f"AlexNet-CIFAR batch {TASK_BATCH}: {len(task.intra)} "
        f"intra workloads, {len(distinct)} distinct; {len(archs)} archs")
    records = kernel_phase(archs, task.intra[2], dev)
    single = {"explore": explore_phase(task, archs, dev)}
    multi = {"fused_best": fused_phase(distinct, archs, dev)}
    single["search"], multi["search"] = search_phase(task, archs, dev)
    single["service"], multi["service"] = service_phase(archs, dev)
    # launches on the main path: the search driver's runs (explore is its
    # per-arch exhaustive search; the fused exhaustive search)
    for name, paths, main_path in (("mapspace_eval_single", single,
                                    "explore"),
                                   ("mapspace_eval_multi", multi, "search")):
        records[name].update(launches=paths[main_path],
                             launches_by_path=paths)
    records["flash_attention"] = flash_phase(dev)
    records["flash_attention"]["launches"] = serve_phase(dev)
    from repro_torch.configs import get_config
    records["ssd_scan"] = ssd_phase(dev)
    records["ssm_conv"] = ssm_conv_phase(dev)
    granite_flash_case, records["moe_grouped"], granite = granite_phase(dev)
    records["flash_attention"]["granite_scaled"] = granite_flash_case
    records["ssm_gate"] = ssm_gate_phase(dev)
    records["rms_norm"] = rms_norm_phase(dev)
    records["moe_grouped"].update(
        launches=granite["grouped"],
        launches_by_path={GRANITE_NAME: granite["grouped"]})
    ssm = ssm_serve_phase(dev, get_config(SSM_ARCH), "ssm", PREFILL_B)
    hybrid = ssm_serve_phase(dev, get_config(HYBRID_ARCH), "hybrid",
                             HYBRID_PREFILL_B, engine=False)
    records["ssd_scan"]["launches"] = ssm["ssd"]
    records["ssm_conv"].update(launches=ssm["fused"], launches_by_path={
        SSM_ARCH: ssm["fused"], HYBRID_ARCH: hybrid["fused"],
        GRANITE_NAME: granite["fused"]})
    records["ssm_gate"].update(launches=ssm["gate"], launches_by_path={
        SSM_ARCH: ssm["gate"], HYBRID_ARCH: hybrid["gate"],
        GRANITE_NAME: granite["gate"]})
    by_path = {SERVE_ARCH: records["flash_attention"]["launches"],
               HYBRID_ARCH: 0, GRANITE_NAME: granite["flash"]}
    norms = {SSM_ARCH: ssm["norm"], HYBRID_ARCH: hybrid["norm"],
             GRANITE_NAME: granite["norm"]}
    for arch in FAMILY_FLASH:
        launches = family_phase(dev, arch)
        by_path[arch], norms[arch] = launches["flash"], launches["norm"]
    records["flash_attention"]["launches_by_path"] = by_path
    records["rms_norm"].update(launches=ssm["norm"], launches_by_path=norms)
    train_phase(dev)
    by_path["parallel"] = parallel_phase(dev)
    say("done", f"{time.perf_counter() - t_start:.1f} s total on {smi}")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
