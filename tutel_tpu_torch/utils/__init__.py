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


def matmul_f32(a, b):
    """a @ b accumulated in and returned as float32, as JAX's
    `preferred_element_type=jnp.float32`: [.., M, K] @ [K, N] or, batched,
    [B, M, K] @ [B, K, N]. On CUDA a bfloat16 product keeps its operands
    (`out_dtype`); on the CPU the operands go to float32 first, which is
    exact for bfloat16 values."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type != "cuda":
        return a.float() @ b.float()
    if b.ndim == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    lead = a.shape[:-1]
    out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return out.reshape(*lead, b.shape[-1])
