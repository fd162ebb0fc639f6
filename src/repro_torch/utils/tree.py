"""Parameter-dict utilities in JAX's leaf order.

Parameters are plain ``dict[str, Tensor]``. JAX flattens a dict in SORTED
key order, so the logistic regression ``{"w", "b"}`` ravels as ``b`` then
``w``; the [K, P] AirComp buffer and the per-leaf order of the AWGN vector
depend on that order (``repro/core/aircomp.py``). Python dicts keep
insertion order, so every function here sorts the keys explicitly.
"""
from __future__ import annotations

import torch


def leaf_names(tree: dict) -> list[str]:
    """The keys of ``tree`` in JAX's flattening order (sorted)."""
    return sorted(tree)


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    return [tree[k] for k in leaf_names(tree)]


def tree_size(tree: dict) -> int:
    """Total number of scalar elements (the paper's M)."""
    return sum(int(v.numel()) for v in tree.values())


def ravel(tree: dict, dtype=None) -> torch.Tensor:
    """An unstacked tree as one contiguous [P] vector, leaves concatenated
    in sorted-key order."""
    return torch.cat([leaf.reshape(-1).to(dtype or leaf.dtype)
                      for leaf in tree_leaves(tree)])


def ravel_stack(trees: dict, dtype=None, lead: int = 1) -> torch.Tensor:
    """A stacked tree (the same ``lead`` leading axes on every leaf: [K], or
    [G, K] in a batched round) as one contiguous [..., P] buffer, leaves
    concatenated in sorted-key order; ``lead=0`` is :func:`ravel`."""
    leaves = tree_leaves(trees)
    shape = tuple(leaves[0].shape[:lead])
    return torch.cat([leaf.reshape(*shape, -1).to(dtype or leaf.dtype)
                      for leaf in leaves], dim=-1)


def unravel(template: dict, flat: torch.Tensor, lead: int = 1) -> dict:
    """Split a [..., P] buffer back into ``template``'s leaves (sorted-key
    order), each shaped like the template leaf without its first ``lead``
    axes, behind ``flat``'s own leading axes, and cast to its dtype."""
    out, off = {}, 0
    for name in leaf_names(template):
        shape = template[name].shape[lead:]
        size = int(torch.Size(shape).numel())
        out[name] = (flat[..., off:off + size].reshape(*flat.shape[:-1], *shape)
                     .to(template[name].dtype))
        off += size
    return out


def tree_l2_norm(tree: dict) -> torch.Tensor:
    """The f32 L2 norm over every leaf: sqrt of the per-leaf sums of
    squares, added in sorted-key order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))
