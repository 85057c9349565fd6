"""End-to-end training on the PyTorch/CUDA port: train an LM for a few
hundred steps on the synthetic pipeline, with checkpoints, and show the
loss dropping; the counterpart of ``examples/train_lm.py``.

The default is a width-reduced gemma (a few M parameters) so the example
finishes in minutes; ``--hundred-m`` trains the full mamba2-130m config.

    PYTHONPATH=src python examples_torch/train_lm.py --steps 300 \\
        [--device cpu]

Runs on the card unless ``--device`` says otherwise, and raises where
there is none.
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--hundred-m", action="store_true",
                    help="train the full mamba2-130m config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    train_argv = ["--arch", "mamba2-130m" if args.hundred_m else "gemma-2b",
                  "--steps", str(args.steps), "--batch", "8", "--seq", "256",
                  "--lr", "1e-3", "--ckpt-dir", args.ckpt_dir,
                  "--ckpt-every", "100", "--log-every", "20"]
    if not args.hundred_m:
        train_argv.append("--smoke")
    if args.device is not None:
        train_argv += ["--device", args.device]
    final_loss = train_main(train_argv)
    print(f"[example] final loss {final_loss:.4f}")
    return final_loss


if __name__ == "__main__":
    main()
