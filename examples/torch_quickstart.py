"""Quickstart on the card: train a small LM end to end with
checkpoint/resume, then decode from it. The port's counterpart of
``examples/quickstart.py``, through the port's launchers
(``python -m repro_torch.launch.train`` and ``repro_torch.launch.serve``)
with ``--device`` passed to every call.

  PYTHONPATH=src python examples/torch_quickstart.py               # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import subprocess
import sys
import tempfile

from repro_torch import device as devmod


def commands(ck: str, device: str) -> list:
    """The three launcher calls: train 30 steps checkpointing every 10,
    resume from the step-30 checkpoint and continue to 40, serve 16
    tokens."""
    train = [sys.executable, "-m", "repro_torch.launch.train",
             "--arch", "qwen3_4b", "--smoke", "--batch", "4", "--seq", "64",
             "--ckpt", ck, "--log-every", "5", "--device", device]
    return [train + ["--steps", "30", "--ckpt-every", "10"],
            train + ["--steps", "40", "--resume"],
            [sys.executable, "-m", "repro_torch.launch.serve",
             "--arch", "qwen3_4b", "--smoke", "--batch", "2",
             "--prompt-len", "16", "--gen", "16", "--device", device]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=devmod.DEFAULT)
    device = str(devmod.resolve(ap.parse_args(argv).device))
    with tempfile.TemporaryDirectory(prefix="repro-torch-ck-") as ck:
        for cmd in commands(ck, device):
            subprocess.run(cmd, check=True)
    print("quickstart OK")


if __name__ == "__main__":
    main()
