"""Device resolution and device-to-host copies (the port's counterpart of
tracs_tpu/parallel/mesh.py::to_host).

The port keeps no global device state: every entry point takes a ``device``
argument, resolved here.  Asking for CUDA on a machine without a card
raises; nothing falls back to the CPU silently.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceUnavailableError(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve_device(device: str | torch.device) -> torch.device:
    """``"cuda"``, ``"cuda:<k>"`` or ``"cpu"`` as a torch.device; raises
    DeviceUnavailableError for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "CUDA was requested but torch.cuda.is_available() is False on "
                "this machine; pass --device cpu (device='cpu') to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise DeviceUnavailableError(
                f"{dev} requested but only {torch.cuda.device_count()} CUDA device(s) exist"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev


def to_host(x: torch.Tensor) -> np.ndarray:
    """One device-to-host copy of ``x`` as a numpy array."""
    return x.cpu().numpy()
