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


def tree_leaves(tree):
    """The tensors of a parameter tree of dicts and lists, dict entries in
    the order of their sorted keys."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_replace(tree, leaves):
    """`tree` with its tensors replaced, in `tree_leaves` order, by
    `leaves`."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(it)
    return rebuild(tree)


def sgd_step(loss_fn, params, lr):
    """One functional SGD step p - lr * g over a parameter tree: returns
    (new tree, the loss, the gradients in `tree_leaves` order). No
    optimizer state; the new tree holds no graph."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_replace(params, leaves))
    grads = torch.autograd.grad(loss, leaves)
    new = [(p - lr * g.to(p.dtype)).detach() for p, g in zip(leaves, grads)]
    return tree_replace(params, new), loss.detach(), grads


def _mm_f32(a, b):
    """a @ b on CUDA with float32 accumulation and output, the operands
    kept in their type ([.., M, K] @ [K, N] or [B, M, K] @ [B, K, N])."""
    if b.ndim == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    lead = a.shape[:-1]
    out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return out.reshape(*lead, b.shape[-1])


class _MatmulF32(torch.autograd.Function):
    """`_mm_f32` with a backward (the `out_dtype` overloads have none). The
    float32 cotangent is rounded to the operands' type and both products
    accumulate in float32, on the tensor cores as the forward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm_f32(g.to(b.dtype), b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.ndim == 3:
                gb = _mm_f32(a.transpose(1, 2), g.to(a.dtype))
            else:
                a2 = a.reshape(-1, a.shape[-1])
                gb = _mm_f32(a2.t(), g.reshape(-1, g.shape[-1]).to(a.dtype))
            gb = gb.to(b.dtype)
        return ga, gb


def matmul_f32(a, b):
    """a @ b accumulated in and returned as float32, as JAX's
    `preferred_element_type=jnp.float32`: [.., M, K] @ [K, N] or, batched,
    [B, M, K] @ [B, K, N]. On CUDA a bfloat16 product keeps its operands
    (`out_dtype`; under autograd `_MatmulF32`); on the CPU the operands go
    to float32 first, which is exact for bfloat16 values."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type != "cuda":
        return a.float() @ b.float()
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32.apply(a, b)
    return _mm_f32(a, b)
