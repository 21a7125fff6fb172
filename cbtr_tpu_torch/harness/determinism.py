"""Where a backward stops being reproducible.

Two backward passes of the same loss at the same parameters should give the
same gradients bit for bit.  Where they do not, some node of the autograd
graph adds in an order that moves between runs (an atomic accumulation on the
card).  `divergent_sites` finds those nodes: it runs the loss and its backward
a few times with a hook on every node of the graph, takes a digest of the
gradients flowing into each node and out of it, and reports the nodes whose
incoming gradients agree in every run while their outgoing ones do not.  A
node downstream of such a site differs too, but only because its input did.

Digests are integer sums of the gradients' bits (exact, so the digest of a
tensor is reproducible whatever order the sum takes), kept on the device
until the runs are compared.

    sites, nodes, differ = divergent_sites(lambda: loss_of(params), runs=2)

`loss_fn` must build a fresh graph at every call (the same lens, the same
rays) and return a scalar tensor; the caller clears `.grad` if it reads it.
"""
from __future__ import annotations

import torch

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def digest(t):
    """Three int64 sums of a tensor's bits (plain, squared, position-
    weighted), or None for a missing gradient."""
    if t is None:
        return None
    bits = t.detach().contiguous().reshape(-1).view(_BITS[t.element_size()]).to(torch.int64)
    weight = torch.arange(bits.numel(), device=bits.device) % 251 + 1
    return torch.stack([bits.sum(), (bits * bits).sum(), (bits * weight).sum()])


def graph_nodes(root):
    """The nodes of the autograd graph below `root` (a grad_fn), in a
    depth-first order that only the graph's structure decides."""
    order, seen, stack = [], set(), [root]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        order.append(node)
        stack.extend(nxt for nxt, _ in reversed(node.next_functions))
    return order


def backward_digests(loss_fn):
    """Run loss_fn() and its backward once: [(node name, digests of the
    gradients into the node, digests of those out of it)] in `graph_nodes`
    order."""
    loss = loss_fn()
    nodes = graph_nodes(loss.grad_fn)
    seen = [None] * len(nodes)
    handles = []
    for i, node in enumerate(nodes):
        def hook(grad_inputs, grad_outputs, i=i):
            seen[i] = ([digest(g) for g in grad_outputs], [digest(g) for g in grad_inputs])
        handles.append(node.register_hook(hook))
    try:
        loss.backward()
    finally:
        for h in handles:
            h.remove()
    return [(type(n).__name__,) + (s if s is not None else ([], [])) for n, s in zip(nodes, seen)]


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        (x is None and y is None) or (x is not None and y is not None and torch.equal(x, y))
        for x, y in zip(a, b))


def divergent_sites(loss_fn, runs: int = 2):
    """(sites, nodes, differ): the nodes (index in `graph_nodes` order and
    name) whose incoming gradients are equal in every run and whose outgoing
    ones are not; the nodes of the graph; the nodes whose outgoing gradients
    differ between runs at all."""
    records = [backward_digests(loss_fn) for _ in range(runs)]
    first = records[0]
    for other in records[1:]:
        if [r[0] for r in other] != [r[0] for r in first]:
            raise RuntimeError("loss_fn built graphs of different shapes")
    sites, differ = [], 0
    for i, (name, grads_in, grads_out) in enumerate(first):
        out_same = all(_same(grads_out, r[i][2]) for r in records[1:])
        if out_same:
            continue
        differ += 1
        if all(_same(grads_in, r[i][1]) for r in records[1:]):
            sites.append((i, name))
    return sites, len(first), differ
