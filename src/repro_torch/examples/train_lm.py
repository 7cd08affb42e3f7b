"""End-to-end LM training with checkpoint/resume (the reduced smollm
configuration, a few hundred steps).

    PYTHONPATH=src python -m repro_torch.examples.train_lm

The checkpoints go under the temporary directory
(``tempfile.gettempdir()``).
"""

import os
import tempfile

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.train import main as train_main


def main(device: DeviceLike = None) -> dict:
    """Runs on ``device`` (default: the card; raises without CUDA);
    returns the launcher's losses and state."""
    dev = resolve_device(device)
    out = train_main([
        "--arch", "smollm_360m", "--smoke",
        "--steps", "200", "--batch", "8", "--seq", "64",
        "--lr", "3e-3",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                   "repro_torch_train_example"),
        "--ckpt-every", "100",
        "--device", str(dev),
    ])
    losses = out["losses"]
    assert losses[-1] < losses[0], "loss must decrease"
    print(f"loss {losses[0]:.3f} → {losses[-1]:.3f} over "
          f"{len(losses)} steps — training works end to end")
    return out


if __name__ == "__main__":
    main()
