"""svinet-torch: every engine of svinet_tpu (the a-MMSB link-sampling SVI
engine, MMSBInfer, FastAMM2, FastAMM, FastInit, SBM, the full blockmodel
and the generator family) in PyTorch, with hand-written CUDA kernels for
an NVIDIA Hopper GPU (sm_90a).

The package mirrors svinet_tpu's layout (ops/, svi/, evals/, io/, cli.py)
and is tested against it, but imports nothing of it and never imports
JAX. It keeps its own copy of the host layer it needs: config.Config,
graph.Network, io.writers, io.native and cli.parse_args, each held to its
original by tests/test_torch_hostlayer.py.
"""

from __future__ import annotations

import os

import torch

__version__ = "0.1.0"

DEVICE_ENV = "SVINET_TORCH_DEVICE"


def resolve_device(name: "str | torch.device | None" = None) -> torch.device:
    """The device the engine runs on: `name`, else $SVINET_TORCH_DEVICE,
    else "cuda". Asking for CUDA on a machine without a card raises; the
    port never moves to the CPU on its own."""
    dev = torch.device(name if name is not None
                       else os.environ.get(DEVICE_ENV, "cuda"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is "
                f"available (set {DEVICE_ENV}=cpu to run on the CPU)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


__all__ = ["DEVICE_ENV", "resolve_device", "__version__"]
