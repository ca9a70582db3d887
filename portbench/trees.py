"""Parameter trees of dicts and lists, flattened in the order the port's
`sgd_step` hands out its gradients: dict entries by sorted key, list
entries in order. The benchmark's own copy, so the reference side needs
nothing of the program."""


def leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def replace(tree, new):
    """`tree` with its leaves replaced, in `leaves` order, by `new`."""
    it = iter(new)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(it)
    return rebuild(tree)
