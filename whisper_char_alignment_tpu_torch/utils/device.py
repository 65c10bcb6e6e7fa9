"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    the CPU. Raises when a GPU is wanted and none is present: the port never
    carries on on the CPU by itself.

    On a GPU it also pins float32 to real float32: no TF32 in matmuls or in
    cuDNN convolutions (PyTorch's default lets convolutions use TF32)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev



def per_utterance(fn: Callable[[torch.Tensor], torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    """``fn`` over x (B, ...) called on one utterance at a time on a card,
    at one call shape whatever B: the library chooses a product's or a
    convolution's kernel by the whole call's shape, so a batch's rows would
    be summed in orders that depend on B. One call on the CPU."""
    if x.device.type != "cuda" or x.shape[0] == 1:
        return fn(x)
    return torch.cat([fn(x[i:i + 1]) for i in range(x.shape[0])])
