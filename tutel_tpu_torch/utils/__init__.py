"""Small helpers shared by the port's modules."""

import torch


def resolve_device(device="cuda"):
    """The device an entry point runs on. "cuda" (the default) raises when
    no GPU is present: the port never drops to the CPU on its own; a
    caller that wants the CPU (the tests) asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device
