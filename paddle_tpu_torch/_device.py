"""The port's one device rule.

Every entry point runs on CUDA unless its caller passes ``device="cpu"``
(or another explicit device). With ``device=None`` and no CUDA device the
entry point raises: the port never falls back to the CPU quietly. A
skeleton build (`nn.layer.skeleton_init`) resolves every device to
``meta``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None):
    """`device` as a ``torch.device``; None means CUDA, which must exist.
    A CUDA device without an index gets the current one, so two spellings
    of one card compare equal. Inside `nn.layer.skeleton_init` every
    device is ``meta``."""
    from .nn.layer import building_skeleton

    if building_skeleton():
        return torch.device("meta")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the "
                "CPU (it never falls back on its own)")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
