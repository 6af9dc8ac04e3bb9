"""Serving example on the PyTorch/CUDA port, the counterpart of
`examples/serve_lm.py`: batched requests through the continuous-batching
engine (prefill + fused decode ticks, slot recycling), on the card unless
`--device cpu` is given:

    python examples/port/serve_lm.py
    python examples/port/serve_lm.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.convert import load_model_params
from repro_torch.device import as_device
from repro_torch.models import init_model
from repro_torch.serve.engine import Request, ServeEngine


def run(tree=None, device="cuda") -> dict:
    """Serve 8 requests on smollm-135m's reduced config, with random
    weights from a generator seeded with 0, or the reference's params
    `tree` (`repro.models.init_model`'s first output, loaded through
    `convert.load_model_params`) -> the engine's finished requests by id,
    as printed."""
    dev = as_device(device)
    cfg = reduced_config("smollm-135m")
    params = init_model(cfg, torch.Generator().manual_seed(0), device=dev)
    if tree is not None:
        load_model_params(params, tree)
    engine = ServeEngine(cfg, params, batch=4, max_len=64, device=dev)

    rng = np.random.default_rng(0)
    for rid in range(8):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(2, 8))
        engine.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                              max_new_tokens=8))

    ticks = engine.run_until_drained()
    print(f"served {len(engine.done)} requests in {ticks} engine ticks "
          f"(batch={engine.batch} slots)\n")
    for rid in sorted(engine.done):
        req = engine.done[rid]
        print(f"  req {rid}: prompt[{len(req.prompt)}] -> "
              f"{req.out_tokens}")
    assert len(engine.done) == 8
    return engine.done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
