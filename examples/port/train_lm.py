"""End-to-end training driver on the PyTorch/CUDA port, the counterpart of
`examples/train_lm.py`: train a SmolLM-135M-family model for a few
hundred steps with the full production stack (the sharded train step on a
(1, 1) DTensor mesh, AdamW, checkpointing + resume, deterministic data
pipeline), on the card unless `--device cpu` is given.

Default runs the reduced config in a checkpoint directory of its own that
is removed at the end; pass `--ckpt-dir DIR` to keep the checkpoints and
resume from them on the next run, and `--full --steps 300` for the 135M
model.

    python examples/port/train_lm.py --steps 200
    python examples/port/train_lm.py --device cpu --steps 40
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.device import as_device
from repro_torch.launch.train import train_loop


def run(arch: str = "smollm-135m", steps: int = 200, seq_len: int = 128,
        global_batch: int = 8, full: bool = False, ckpt_dir: str = "",
        device="cuda") -> list:
    """Train (resuming from `ckpt_dir`'s latest checkpoint if it has one;
    a temporary directory when `ckpt_dir` is empty) -> the losses of the
    steps run.  A run from step 0 must end below its first loss; a
    resumed run's few last steps, at the end of the schedule, are only
    printed."""
    dev = as_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        losses = train_loop(
            arch=arch, steps=steps, seq_len=seq_len,
            global_batch=global_batch, reduced=not full,
            ckpt_dir=ckpt_dir or tmp, log_every=20, device=dev)
    if not losses:
        print(f"\nthe checkpoint in {ckpt_dir} is at step {steps} or "
              f"later: no step to run")
        return losses
    drop = losses[0] - min(losses)
    print(f"\nloss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(best drop {drop:.4f})")
    if len(losses) < steps:
        print(f"resumed at step {steps - len(losses)}: "
              f"{len(losses)} steps run")
        return losses
    assert losses[-1] < losses[0], "training did not reduce loss"
    print("OK: loss decreased over training")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default="",
                    help="keep checkpoints here and resume from them "
                         "(default: a temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(arch=args.arch, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, full=args.full,
        ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
