"""repro_torch — the TRIM design-space exploration model on PyTorch and CUDA.

A port of the JAX package `repro` (which stays the reference) for an
NVIDIA H100.  This package imports `torch` and `numpy`, never `jax` and
nothing of `repro`; module names mirror `repro`'s.  Public entry points
take `device=` (default "cuda") and never move to the host on their own.

  core      workload / designer / mapper / evaluator / task analyst
            (framework-free copies), the batched oracle (`batch_eval`),
            backend dispatch and the explorer (paper Algorithm 1)
  kernels   hand-written CUDA kernels (sm_90a) with plain PyTorch twins
  search    cross-architecture fused mapspace scoring (`fused_best`)
  obs       host-side spans, counters and metrics
  convert   the JAX side's numpy/dict inputs -> the port's objects
  analysis  trimlint for the port (standard library only):
            `python -m repro_torch.analysis --strict`
"""
