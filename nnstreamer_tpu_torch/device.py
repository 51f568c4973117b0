"""Device and dtype policy.

The port's counterpart of ``nnstreamer_tpu/utils/platform.py`` and of the
device choice in ``filter/backends/xla.py``:

- entry points run on ``cuda:0`` unless the caller asks for the CPU
  (``tensor_filter accelerator=true:cpu``, or ``device="cpu"`` on a
  function);
- without a CUDA device and without that request they raise: nothing
  falls back to the CPU quietly;
- models compute in bf16 on the card and in f32 on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


class DeviceError(RuntimeError):
    """The requested device does not exist on this host."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda:0``); a CUDA device that this host
    lacks raises :class:`DeviceError`."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(
                "no CUDA device: ask for the CPU explicitly "
                "(accelerator=true:cpu, or device='cpu')")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise DeviceError(f"unsupported device {dev}")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card (tensor-core native), f32 on the CPU (bf16
    convolutions are emulated and slow there)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def parse_dtype(name: Optional[str], device: torch.device) -> torch.dtype:
    """``custom=dtype:<name>`` → torch dtype; unset picks
    :func:`default_dtype`."""
    if not name:
        return default_dtype(device)
    dtypes = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
              "float32": torch.float32, "f32": torch.float32,
              "float16": torch.float16, "f16": torch.float16}
    key = str(name).strip().lower()
    if key not in dtypes:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(dtypes)}")
    return dtypes[key]
