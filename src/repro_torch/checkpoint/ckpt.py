"""msgpack checkpoints of nested dicts, NamedTuples and sequences of numpy
arrays or tensors; port of ``repro.checkpoint.ckpt``, in the same format.

Layout: ``<dir>/step_<n>.msgpack`` (``n`` written as ``%010d``), each a
msgpack map ``{flat_key: {"dtype", "shape", "data"}}`` of raw C-order bytes.
A flat key joins the path to a leaf with ``/`` the way the reference's
``jax.tree_util`` paths print: a dict key as itself (keys sorted, as JAX
flattens a dict), a sequence index as its number, and a NamedTuple field as
``.<name>`` with the dot (``hist/<label>/.avg_acc``). An empty tuple and
None hold no leaf and write no key. So either package reads what the other
wrote. The structure comes back from a template at restore time. ``msgpack``
is imported only when a checkpoint is read or written.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

_KEY_SEP = "/"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaves_with_keys(tree, path=()):
    """``(flat_key, leaf)`` pairs in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _leaves_with_keys(v, path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_keys(v, path + (str(i),))
    else:
        yield _KEY_SEP.join(path), tree


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _numpy_dtype(leaf) -> Optional[np.dtype]:
    """The leaf's dtype as numpy names it; None for a dtype-less leaf (a
    Python scalar carries no intent about width)."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.dtype(leaf.dtype) if hasattr(leaf, "dtype") else None


def _flatten(tree) -> dict:
    flat = {}
    for key, leaf in _leaves_with_keys(tree):
        arr = _as_numpy(leaf)
        flat[key] = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                     "data": arr.tobytes()}
    return flat


def save_checkpoint(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    """Write ``tree`` as ``<directory>/step_<step>.msgpack`` (atomically) and
    keep only the ``keep`` most recent checkpoints."""
    import msgpack

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:010d}.msgpack")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(_flatten(tree)))
    os.replace(tmp, path)
    for s in all_steps(directory)[:-keep]:
        os.remove(os.path.join(directory, f"step_{s:010d}.msgpack"))
    return path


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for fn in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)\.msgpack", fn)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None) -> Any:
    """Restore into the structure of ``template`` (shapes and dtypes must
    match; a mismatch raises instead of reinterpreting bytes). A numpy or
    scalar leaf comes back as a fresh writeable numpy array, a tensor leaf
    as a tensor on the template leaf's device."""
    import msgpack

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:010d}.msgpack")
    with open(path, "rb") as f:
        flat = msgpack.unpackb(f.read())
    out = []
    for key, leaf in _leaves_with_keys(template):
        rec = flat[key]
        want = _numpy_dtype(leaf)
        if want is not None and np.dtype(rec["dtype"]) != want:
            raise ValueError(
                f"dtype mismatch for {key}: checkpoint has {rec['dtype']}, "
                f"template wants {want}")
        arr = (np.frombuffer(rec["data"], dtype=rec["dtype"])
               .reshape(rec["shape"]).copy())
        shape = tuple(np.shape(leaf))
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {shape}")
        out.append(torch.from_numpy(arr).to(leaf.device)
                   if isinstance(leaf, torch.Tensor) else arr)
    return _rebuild(template, iter(out))
