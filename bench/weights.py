"""A configuration's weights, drawn on the device from the run's seed in
one call: every leaf is a slice of one standard normal draw, a matrix
scaled by 1/sqrt(fan-in), a bias by 0.1. The same tree is handed to the
port and to the reference."""
from __future__ import annotations

import math

import torch


def _leaves(tree: dict, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v)


def make(shapes: dict, seed: int, device) -> dict:
    """``shapes`` (a nested dict of leaf shapes) -> the same tree of
    float32 tensors on ``device``."""
    leaves = list(_leaves(shapes))
    total = sum(math.prod(s) for _, s in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    tree, at = {}, 0
    for path, shape in leaves:
        size = math.prod(shape)
        std = 1.0 / math.sqrt(shape[0]) if len(shape) == 2 else 0.1
        leaf = flat[at:at + size].view(shape).mul_(std)
        at += size
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
