"""Batched LM serving (prefill + sampled decode with KV caches) on an
architecture's smoke twin.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch xlstm_125m]
"""

import argparse

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.serve import main as serve_main


def main(device: DeviceLike = None, arch: str = "smollm_360m") -> dict:
    """Runs on ``device`` (default: the card; raises without CUDA);
    returns the launcher's tokens and timings."""
    dev = resolve_device(device)
    return serve_main(["--arch", arch, "--smoke", "--batch", "4",
                       "--prompt-len", "32", "--gen", "48",
                       "--device", str(dev)])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    main(arch=ap.parse_args().arch)
