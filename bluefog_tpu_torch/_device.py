"""The port's device rule: entry points run on the card unless the caller
asks for the host.

Every entry point takes ``device=`` (default ``"cuda"``) and resolves it
here.  Without CUDA, a ``"cuda"`` device raises instead of falling back
to the CPU: a run that meant to measure the card must not quietly
measure the host.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; pass device='cpu' to "
                "run the port on the CPU (plain versions of its kernels)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {dev}")
    return dev
