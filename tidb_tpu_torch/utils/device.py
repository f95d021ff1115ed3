"""Device choice and dtype mapping.

`resolve_device(None)` is the card: the port's entry points run on CUDA
unless the caller asks for the CPU, and they never fall back to the CPU
when no card is present.
"""

from __future__ import annotations

import numpy as np
import torch

from tidb_tpu_torch.errors import ExecutionError

__all__ = ["resolve_device", "torch_dtype"]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    # int8/int16: the narrow frame-of-reference payloads of the columnar
    # segment store, staged as they are and widened on the device
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def resolve_device(device=None) -> torch.device:
    """None -> cuda. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ExecutionError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    return dev


def torch_dtype(np_dtype) -> torch.dtype:
    return _TORCH_DTYPES[np.dtype(np_dtype)]
