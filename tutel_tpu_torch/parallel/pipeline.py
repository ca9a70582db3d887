"""Pipeline parallelism over a mesh axis (counterpart:
tutel_tpu/parallel/pipeline.py): GPipe (`pipeline`) and 1F1B
(`pipeline_1f1b`).

The mesh is a `ProcessMesh` with a stage axis ('pp') and, for PP x EP or
PP x DP, data axes (e.g. 'e', 'r', 'g') that split each microbatch's rows
within a stage. Every rank runs the same lockstep schedule of ticks: at
tick t, stage s works on microbatch t - s (a bubble where that is out of
range, masked: no stage runs and zeros travel), and every rank posts
every tick's hop to its neighbours (`net.ppermute` over its 'pp' line),
bubbles included, in one order, so no rank waits for a hop another rank
skips.

Parameters. `stack_stage_params` stacks per-stage trees on a new leading
dim; each rank holds its stage's slice (`local_stage_params`: the leading
dim split over 'pp', the other dims by `stage_param_specs`, e.g. a MoE
layer's `param_specs`). The schedules take and return that slice, the
leading dim of size 1 kept.

Inputs and outputs. `fn(stage_params, x)` takes the global batch x
[batch, ...], alike on every rank (as JAX's `fn` takes the global array);
it is split into n_micro microbatches, and `data_spec` (a tuple of axis
entries over a microbatch's dims, e.g. ('e',)) gives each rank its rows of
each. GPipe returns this rank's rows: [n_micro * rows, ...], microbatch
after microbatch (with no data axes, the whole batch), replicated over
'pp' by a masked all-reduce whose backward is the identity, so every
stage's rank computes the loss of the same outputs and calls backward on
it. Under data axes, a rank's loss is its share (the sum over its rows),
and a value replicated over the data axes (the aux) enters each share
divided by their size; the gradients of stage parameters that the data
axes replicate are summed over those axes, as JAX's shard_map transposes
a replicated input.

GPipe's backward is autograd through the schedule: every hop lies on the
path from each rank's loss to every input that takes a gradient (the
first state depends on them and the last tick's output joins the outputs,
both with zero weight), so every rank runs every backward hop, in reverse
tick order, under `backward()` and `torch.autograd.grad` alike.
`remat=True` recomputes each stage call in the backward
(`torch.utils.checkpoint`). 1F1B is an explicit schedule of one masked
forward slot and one masked backward slot a tick; the backward slot
recomputes the stage from its stashed input (at most 2(S-1)+1 inputs a
stage) and accumulates the parameter gradients with `torch.autograd.grad`.
"""

import torch
import torch.utils.checkpoint

from .. import net
from ..utils import tree_leaves, tree_replace

__all__ = ["pipeline", "pipeline_1f1b", "stack_stage_params",
           "local_stage_params"]


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage parameter trees on a new leading stage
    dim, the layout the schedules shard over 'pp'."""
    stacked = [torch.stack(leaves) for leaves in
               zip(*(tree_leaves(p) for p in per_stage_params))]
    return tree_replace(per_stage_params[0], stacked)


def _walk(fn, params, specs):
    """fn(leaf, spec) over the leaves of `params`, with the spec at the
    same place in `specs` (a tree of the same dicts and lists, whose
    leaves are None or tuples of axis entries); specs=None: all None."""
    if isinstance(params, dict):
        return {k: _walk(fn, params[k], None if specs is None else specs[k])
                for k in sorted(params)}
    if isinstance(params, (list, tuple)):
        return type(params)(_walk(fn, p, None if specs is None else s)
                            for p, s in zip(params, specs or
                                            [None] * len(params)))
    return fn(params, specs)


def _full_param_specs(stacked_params, axis, stage_param_specs):
    """Each leaf's spec with the stage axis in front (only the stage axis
    where no per-stage specs are given: a stage's parameters whole on
    every rank of its row)."""
    return _walk(lambda _, s: (axis,) + tuple(s or ()), stacked_params,
                 stage_param_specs)


def _spec_axes(spec):
    """The axis names a spec splits over."""
    return {a for entry in (spec or ()) if entry is not None
            for a in ((entry,) if isinstance(entry, str) else entry)}


def local_stage_params(stacked_params, mesh, axis="pp",
                       stage_param_specs=None):
    """This rank's slice of stacked parameters: the stage dim over `axis`,
    the other dims by `stage_param_specs`."""
    return _walk(lambda v, s: mesh.shard(v, s), stacked_params,
                 _full_param_specs(stacked_params, axis, stage_param_specs))


def _data_axes(data_spec):
    return tuple(a for entry in (data_spec or ()) if entry is not None
                 for a in ((entry,) if isinstance(entry, str) else entry))


def _micro(x, n_micro, mesh, data_spec):
    """[n_micro, rows, ...]: x split into microbatches, each cut to this
    rank's rows by data_spec."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    xm = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    return mesh.shard(xm, (None,) + tuple(data_spec or ()))


def _check_mesh(mesh, axis, num_stages):
    if mesh.size(axis) != num_stages:
        raise ValueError(f"mesh axis {axis!r} has size {mesh.size(axis)}, "
                         f"need num_stages={num_stages}")


def _squeeze(stage_params):
    """A stage's parameters without the leading stage dim of size 1."""
    return tree_replace(stage_params, [p[0] for p in tree_leaves(
        stage_params)])


def _with_aux(stage_fn, has_aux):
    if has_aux:
        return stage_fn
    return lambda p, x: (stage_fn(p, x), torch.zeros((), device=x.device))


def _replicated_grads(params, mesh, data_axes, stage_param_specs):
    """Each leaf with its gradient summed over the data axes it is not
    split over (the identity forward of `net.allreduce_backward`)."""
    def wrap(p, spec):
        if not p.requires_grad:
            return p
        for a in data_axes:
            if a not in _spec_axes(spec) and mesh.size(a) > 1:
                p = net.allreduce_backward(p, mesh.group(a))
        return p
    return _walk(wrap, params, stage_param_specs)


def _gpipe_local(stage_fn, mesh, axis, num_stages, n_micro, remat, has_aux,
                 data_axes, stage_param_specs, stage_params, xm):
    """This rank's GPipe schedule. Returns ([n_micro, rows, ...], aux sum
    / n_micro), both replicated over `axis`."""
    sid, group = mesh.index(axis), mesh.group(axis)
    last = sid == num_stages - 1
    params = _replicated_grads(_squeeze(stage_params), mesh, data_axes,
                               stage_param_specs)
    apply = _with_aux(stage_fn, has_aux)
    if remat:
        base = apply

        def apply(p, x):
            return torch.utils.checkpoint.checkpoint(base, p, x,
                                                     use_reentrant=False)
    ticks = n_micro + num_stages - 1
    dev = xm.device
    no = torch.zeros((), dtype=torch.bool, device=dev)
    state = torch.zeros_like(xm[0])
    if torch.is_grad_enabled():
        # the first state depends, with zero weight, on every input that
        # takes a gradient, so every hop of every rank lies on the path from
        # the loss to any of them: no rank's backward skips a hop (a
        # backward hop waits for both neighbours)
        anchor = [t.reshape(-1)[:1].sum() for t in tree_leaves(params)
                  + [xm] if t.requires_grad]
        if anchor:
            state = state + torch.where(no, sum(anchor).to(state.dtype),
                                        torch.zeros((), dtype=state.dtype,
                                                    device=dev))
    outs, aux = [None] * n_micro, torch.zeros((), device=dev)
    for t in range(ticks):
        m = t - sid
        valid = 0 <= m < n_micro
        if sid == 0 and t < n_micro:
            # the received state joins the graph with zero weight
            state = torch.where(~no, xm[t], state)
        if valid:
            y, a = apply(params, state)
            aux = aux + a.float()
            outs[m] = y
        else:
            y = torch.where(no, state, torch.zeros_like(state))
        if t < ticks - 1:
            state = net.ppermute(y, 1, group)
    # replicate the last stage's outputs; the last tick's output (a bubble
    # except on the last stage) joins with zero weight
    keep = torch.full((), last, dtype=torch.bool, device=dev)
    outs = torch.stack(outs)
    outs = torch.where(keep, outs, torch.zeros_like(outs)) + torch.where(
        no, y.sum(), torch.zeros((), dtype=y.dtype, device=dev))
    outs = net.allreduce_forward(outs, group)
    aux = net.allreduce_forward(aux, group) / n_micro
    return outs, aux


def pipeline(stage_fn, num_stages, mesh, axis="pp", n_micro=None,
             remat=False, has_aux=False, data_spec=None,
             stage_param_specs=None):
    """A GPipe-pipelined `stage_fn` over mesh axis `axis`.

    stage_fn(stage_params, x) -> y (or (y, aux scalar) with has_aux=True,
    e.g. a MoE block and its l_aux); shape-preserving in x. Returns
    fn(stage_params, x) -> y (or (y, aux mean over microbatches)):
    stage_params this rank's slice of the stacked parameters (leading dim
    1), x the global batch (divisible by n_micro, default num_stages), y
    this rank's rows (see the module doc)."""
    _check_mesh(mesh, axis, num_stages)
    nm = n_micro or num_stages
    data_axes = _data_axes(data_spec)

    def fn(stage_params, x):
        xm = _micro(x, nm, mesh, data_spec)
        outs, aux = _gpipe_local(stage_fn, mesh, axis, num_stages, nm, remat,
                                 has_aux, data_axes, stage_param_specs,
                                 stage_params, xm)
        y = outs.reshape(-1, *outs.shape[2:])
        return (y, aux) if has_aux else y
    return fn


def _1f1b_local(stage_fn, loss_fn, mesh, axis, num_stages, n_micro, has_aux,
                data_axes, stage_param_specs, stage_params, xm):
    """This rank's 1F1B schedule. Forward of micro m at stage s at tick
    m + s, its backward at tick m + 2(S-1) - s. Returns (loss, aux,
    grads): the loss and aux replicated, grads of this rank's slice."""
    sid, group = mesh.index(axis), mesh.group(axis)
    last = sid == num_stages - 1
    data_world = 1
    for a in data_axes:
        data_world *= mesh.size(a)
    leaves = [p[0].detach().requires_grad_(True)
              for p in tree_leaves(stage_params)]
    params = tree_replace(stage_params, leaves)
    apply = _with_aux(stage_fn, has_aux)
    ticks = n_micro + 2 * (num_stages - 1)
    depth = 2 * (num_stages - 1) + 1       # stash slots
    zeros = torch.zeros_like(xm[0])
    stash = [None] * depth
    gacc = [torch.zeros_like(p) for p in leaves]
    loss_acc = torch.zeros((), device=xm.device)
    aux_acc = torch.zeros((), device=xm.device)
    fwd_state = bwd_state = zeros
    for t in range(ticks):
        # forward slot: micro m_f enters at stage 0 and flows along
        m_f = t - sid
        y = zeros
        if 0 <= m_f < n_micro:
            x_in = xm[m_f] if sid == 0 else fwd_state
            with torch.no_grad():
                y = apply(params, x_in)[0]
            stash[m_f % depth] = x_in
        # backward slot: recompute from the stashed input, seed the loss's
        # gradient (last stage) or the received one, accumulate
        m_b = t - 2 * (num_stages - 1) + sid
        dx = zeros
        if 0 <= m_b < n_micro:
            x_b = stash[m_b % depth].detach().requires_grad_(True)
            with torch.enable_grad():
                y_b, aux_b = apply(params, x_b)
                if last:
                    loss_m = loss_fn(y_b).float()
                    outputs = [loss_m]
                    cts = [torch.full_like(loss_m, 1.0 / n_micro)]
                else:
                    outputs, cts = [y_b], [bwd_state]
                if has_aux:
                    # the aux is replicated over the data axes: each rank
                    # seeds its share
                    outputs.append(aux_b.float())
                    cts.append(torch.full_like(
                        outputs[-1], 1.0 / (n_micro * data_world)))
                got = torch.autograd.grad(outputs, leaves + [x_b], cts,
                                          allow_unused=True)
            for g, d in zip(gacc, got[:-1]):
                if d is not None:
                    g.add_(d)
            if got[-1] is not None:
                dx = got[-1].detach()
            if last:
                loss_acc = loss_acc + loss_m.detach()
            aux_acc = aux_acc + aux_b.detach().float()
        # both hops, every tick, on every rank
        fwd_state = net.ppermute(y, 1, group)
        bwd_state = net.ppermute(dx, -1, group)
    # the last stage's rows sum over the data shards
    loss = net.simple_all_reduce(loss_acc, group)
    aux = net.simple_all_reduce(aux_acc, group) / n_micro
    for a in data_axes:
        if mesh.size(a) > 1:
            loss = net.simple_all_reduce(loss, mesh.group(a))
            aux = net.simple_all_reduce(aux, mesh.group(a)) / mesh.size(a)
    loss = loss / n_micro
    # leaves replicated over a data axis saw that shard's rows only; leaves
    # split over it (experts over 'e') have their whole gradient already
    specs = [None] * len(leaves)
    if stage_param_specs is not None:
        specs = []
        _walk(lambda _, s: specs.append(s), stage_params, stage_param_specs)
    for i, spec in enumerate(specs):
        for a in data_axes:
            if a not in _spec_axes(spec) and mesh.size(a) > 1:
                gacc[i] = net.simple_all_reduce(gacc[i], mesh.group(a))
    grads = tree_replace(stage_params, [g[None] for g in gacc])
    return loss, aux, grads


def pipeline_1f1b(stage_fn, loss_fn, num_stages, mesh, axis="pp",
                  n_micro=None, has_aux=False, data_spec=None,
                  stage_param_specs=None):
    """A 1F1B (one forward, one backward) pipelined training step.

    stage_fn as for `pipeline`; loss_fn(y) -> scalar for each last-stage
    microbatch output (with data axes, each rank's rows of it: write it as
    a sum over rows, since the shards' losses are summed). Returns
    fn(stage_params, x) -> (loss, grads): loss = the mean over
    microbatches of loss_fn plus the mean over microbatches of the
    stages' summed aux (the total GPipe + autograd differentiates),
    replicated; grads a tree like stage_params (this rank's slice)."""
    _check_mesh(mesh, axis, num_stages)
    nm = n_micro or num_stages
    data_axes = _data_axes(data_spec)

    def fn(stage_params, x):
        xm = _micro(x, nm, mesh, data_spec)
        loss, aux, grads = _1f1b_local(stage_fn, loss_fn, mesh, axis,
                                       num_stages, nm, has_aux, data_axes,
                                       stage_param_specs, stage_params, xm)
        return loss + aux, grads
    return fn
