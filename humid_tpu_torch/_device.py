"""Device resolution for the port.

The device is the explicit ``device=`` argument when one is given, else
the ``HUMID_TPU_TORCH_DEVICE`` environment variable, else ``"cuda"``.  A
CUDA request without a usable CUDA device raises: the port never falls
back to the CPU quietly, so a run that was meant for the GPU cannot
silently measure or validate the CPU path instead.
"""

from __future__ import annotations

import os

import torch

from .errors import DeviceUnavailableError

ENV_VAR = "HUMID_TPU_TORCH_DEVICE"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (or $HUMID_TPU_TORCH_DEVICE, default ``cuda``) as a
    ``torch.device``; raises DeviceUnavailableError for CUDA without a
    usable CUDA device."""
    if device is None:
        device = os.environ.get(ENV_VAR) or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {str(dev)!r} requested (device= argument or "
            f"{ENV_VAR}) but torch.cuda.is_available() is False; set "
            f"{ENV_VAR}=cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise DeviceUnavailableError(
            f"device {str(dev)!r} is not supported (use cuda or cpu)")
    return dev


def to_host(*tensors):
    """Numpy copies of ``tensors`` (all on one device) with one wait: on a
    CUDA device every copy goes to pinned memory without blocking and the
    current stream is synchronised once after the last."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    dev = tensors[0].device
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in hosts]


def to_device(array, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; to a CUDA device through
    pinned memory without blocking the host (the copy is ordered on the
    current stream)."""
    t = torch.from_numpy(array)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
