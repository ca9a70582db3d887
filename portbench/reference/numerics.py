"""Frozen copies of the number formats the configurations state, in plain
PyTorch, and the lower precision the controls compute in.

Nothing here is imported from the program: the formulas are written out
again so that a change to the program's quantizers shows as a gap
against this reference.
"""

import torch


def int4_weight(w):
    """Weight-only INT4 of expert weights [E, K, N] as served: symmetric
    per-(expert, output column) scales s = max|w| over K / 7 (1 where the
    column is zero), q = clamp(round(w / s), -8, 7); returns q * s in
    float32."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=1, keepdim=True)
    s = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    return torch.clamp(torch.round(w32 / s), -8, 7) * s


def int8_kv(x):
    """The INT8 KV cache's round trip of K or V rows [..., heads, hd]:
    symmetric per-(row, head) scales s = max(max|x| / 127, 1e-10),
    q = clamp(round(x / s), -127, 127); returns q * s in float32."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-10)
    return torch.clamp(torch.round(xf / s), -127, 127) * s


FP8_MAX = 448.0         # float8_e4m3fn's largest finite value


def fp8(x):
    """x rounded to float8 e4m3 under one per-tensor scale (max|x| maps to
    448), back in float32: the control's operands."""
    xf = x.float()
    amax = xf.detach().abs().amax().clamp(min=1e-30)
    s = amax / FP8_MAX
    q = (xf / s).to(torch.float8_e4m3fn).float() * s
    # straight-through: the control's backward sees the rounding as identity
    return xf + (q - xf).detach()


class Precision:
    """What each product's operands are rounded to: "fp32" (none) or
    "fp8" (the control)."""

    def __init__(self, name="fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def r(self, x):
        x = x.float()
        return fp8(x) if self.name == "fp8" else x

    def mm(self, a, b):
        return self.r(a) @ self.r(b)

    def einsum(self, spec, a, b):
        return torch.einsum(spec, self.r(a), self.r(b))


def no_tf32():
    """Float32 products on the GPU in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
