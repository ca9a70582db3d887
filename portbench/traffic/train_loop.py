"""Training traffic: one training object stepped over a pool of batches.

A cell's "params" fix the job: `batch` x `seq` tokens a step, the
`capacity_factor`, the SGD `lr`, and `batches_in_pool` distinct batches
made from the seed (the window steps through them in turn).

Set-up builds the training object of the configuration's entry (its
model, its parameters made from the seed), and drives it through its
first `checked_steps` steps on distinct batches through the same `step`
call the window uses; those steps also warm up every kernel. It keeps
their losses, each leaf's first gradient norm as `sgd_step` hands it to
the update, and each leaf's change after the checked steps. The window
then steps on, each step ending in `torch.cuda.synchronize()`, until
`seconds` have passed. After it the plain reference follows the checked
steps from the same seed and batches (`check`)."""

import torch

from portbench import trees


def leaf_norms(leaves):
    return torch.stack([t.float().norm() for t in leaves])


def run(ctx):
    p = ctx.params
    entry = ctx.entry
    trainer = entry.Trainer(ctx.config, p, ctx.seed, ctx.device)
    ctx.apply_fault(trainer)
    pool = entry.train_pool(ctx.config, p, ctx.seed, ctx.device)
    n_pool, n_check = pool.shape[0], p["checked_steps"]
    losses, first_norms, first_grads = [], None, None
    for i in range(n_check):
        loss, grads = trainer.step(pool[i % n_pool])
        losses.append(loss.detach().float())
        if i == 0:
            # norms on the card (a float32 sum on the host over 1e8
            # values reads low); the gradients kept on the host for the
            # reference's difference
            first_norms = leaf_norms(grads)
            first_grads = [g.detach().to("cpu") for g in grads]
        del grads
    # each leaf's change over the checked steps, against the seed's start
    start = entry.train_weights(ctx.config, p, ctx.seed, ctx.device)
    change = torch.stack([(a.float() - b.float()).norm() for a, b in zip(
        trees.leaves(trainer.params), trees.leaves(start))])
    readings = {"param_norms": leaf_norms(trees.leaves(start)).tolist(),
                "losses": torch.stack(losses).tolist(),
                "grad_norms": first_norms.tolist(),
                "change_norms": change.tolist()}
    del start
    ctx.sync()
    step_losses, steps, t_ends = [], 0, []
    t0 = ctx.clock()
    ctx.window_start(t0)
    i = n_check
    while ctx.running():
        ctx.maybe_trace(lambda: steps)
        loss = trainer.step(pool[i % n_pool])[0]
        ctx.sync()
        t_ends.append(ctx.clock())
        step_losses.append(loss.float())
        steps += 1
        i += 1
        ctx.maybe_trace(lambda: steps)
    t1 = ctx.clock()
    ctx.window_end(t1, lambda: steps)
    finite = torch.isfinite(torch.stack(step_losses)) if step_losses \
        else torch.ones(0, dtype=torch.bool)
    per_step = entry.tokens_per_step(p)
    ends = [t0] + t_ends
    durs = [b - a for a, b in zip(ends, ends[1:])]
    tenth = max(1, len(durs) // 10)
    ctx.note(step_s_by_tenth=[sum(durs[j:j + tenth]) / len(durs[j:j + tenth])
                              for j in range(0, len(durs), tenth)])
    rec = {"steps": steps, "tokens_per_step": per_step,
           "tokens": steps * per_step, "attempted": steps,
           "failed": int((~finite).sum())}
    ctx.read_memory()
    del trainer, pool
    ctx.free()
    ctx.outcome(rec, check(ctx, readings, first_grads))


def reference_readings(ctx, prec_name="fp32", against=None,
                       keep_first=False):
    """The plain reference's losses, first gradient norms and changes over
    the checked steps from the seed's weights and batches, in float32
    (or in the control's precision). `against`: {name: first gradients,
    leaf by leaf} to measure the reference's first gradient against
    ("diff_norms": {name: each leaf's norm of the difference});
    keep_first: also return the first gradients (on the host)."""
    from portbench.reference.numerics import Precision, no_tf32
    no_tf32()
    p, entry = ctx.params, ctx.entry
    if p["capacity_factor"]:
        raise ValueError("the training reference routes dropless: "
                         "capacity_factor must be 0")
    pool = entry.train_pool(ctx.config, p, ctx.seed, ctx.device)
    tree = entry.train_weights(ctx.config, p, ctx.seed, ctx.device)
    leaves = [t.float().requires_grad_(True) for t in trees.leaves(tree)]
    shape = trees.replace(tree, [None] * len(leaves))
    del tree
    prec = Precision(prec_name)
    out = {"losses": []}
    for i in range(p["checked_steps"]):
        loss = ctx.reference.loss(trees.replace(shape, leaves),
                                  pool[i % pool.shape[0]],
                                  ctx.config["port"], prec)
        grads = torch.autograd.grad(loss, leaves)
        out["losses"].append(float(loss.detach()))
        if i == 0:
            out["grad_norms"] = [float(g.norm()) for g in grads]
            out["diff_norms"] = {
                name: [float((g - a.to(g.device).float()).norm())
                       for g, a in zip(grads, other)]
                for name, other in (against or {}).items()}
            if keep_first:
                out["first_grads"] = [g.detach().to("cpu") for g in grads]
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.sub_(g, alpha=p["lr"])
        del grads, loss
    start = trees.leaves(entry.train_weights(ctx.config, p, ctx.seed,
                                             ctx.device))
    with torch.no_grad():
        out["change_norms"] = [float((a - b.float()).norm())
                               for a, b in zip(leaves, start)]
    return out


def gaps(prog, ref, diff=None):
    """The numbers a training check can compare. Losses: the first step's
    relative gap (`loss1_gap`) and the worst over the checked steps
    (`loss_gap`). Gradients and changes: for each leaf the gap between
    the program's and the reference's norm, over the larger of that
    leaf's reference norm and the median leaf's; the worst leaf
    (`grad_gap`, `change_gap`) and the median leaf (`*_median`); with
    `diff` (each leaf's norm of the difference between the two first
    gradients) that over the same denominator (`grad_diff`, worst leaf,
    and `grad_diff_median`). Leaves whose reference gradient is
    under a thousandth of the median leaf's move by round-off alone and
    are left out of the change."""
    import statistics
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"])]

    def each(a, b, keep):
        med = statistics.median(b)
        return [abs(x - y) / max(y, med) for x, y, k in zip(a, b, keep) if k]
    gmed = statistics.median(ref["grad_norms"])
    moves = [g >= 1e-3 * gmed for g in ref["grad_norms"]]
    grad = each(prog["grad_norms"], ref["grad_norms"], [True] * len(moves))
    change = each(prog["change_norms"], ref["change_norms"], moves)
    out = {"loss1_gap": losses[0], "loss_gap": max(losses),
           "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
           "change_gap": max(change),
           "change_gap_median": statistics.median(change)}
    if diff is not None:
        rel = [d / max(y, gmed) for d, y in zip(diff, ref["grad_norms"])]
        out["grad_diff"] = max(rel)
        out["grad_diff_median"] = statistics.median(rel)
    return out


def check(ctx, readings, first_grads):
    """The numbers the cell's limits name are compared; the others go to
    the notes. With a control, the control stands in the program's
    place: its readings, taken against the same reference, are what is
    compared, and the program's go to the notes."""
    against = {"program": first_grads}
    if ctx.control:
        ctl = reference_readings(ctx, ctx.control, keep_first=True)
        against["control"] = ctl.pop("first_grads")
    ref = reference_readings(ctx, against=against)
    diffs = ref.pop("diff_norms")
    g = gaps(readings, ref, diffs["program"])
    ctx.note(program=readings, reference=ref, gaps=g)
    if ctx.control:
        g = gaps(ctl, ref, diffs["control"])
        ctx.note(control=g, control_readings=ctl)
    limits = ctx.cell["limits"]
    return {k: {"value": g[k], "limit": v} for k, v in limits.items()}
