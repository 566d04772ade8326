"""State checkpoint / resume (mirror of ``aosx/io/checkpoint.py``).

A state is a tree of dataclasses, tuples, lists and dicts with tensors at
the leaves. ``save_state`` writes ``<path>.npz`` with one array per leaf,
``leaf_{i}`` in depth-first field-declaration order (dict entries by sorted
key, None skipped): the order in which the JAX package flattens the same
state, so that a checkpoint written by either package loads in the other.
``<path>.tree`` lists the leaf paths for a reader. ``load_state`` takes the
structure, dtypes and devices from a ``like`` state. ``save_cluster_info``
persists a graph and its tree rows for the map-save chain.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """(path, leaf) pairs in depth-first declaration order."""
    if tree is None:
        return
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _flatten(getattr(tree, f.name), f"{prefix}.{f.name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _rebuild(like, leaves):
    """A tree shaped like ``like`` whose leaves come from the iterator."""
    if like is None:
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{f.name: _rebuild(getattr(like, f.name), leaves)
                                            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def save_state(path: str, state) -> None:
    """Save a state tree to <path>.npz (+ <path>.tree, the leaf paths)."""
    named = list(_flatten(state))
    np.savez_compressed(path + ".npz", **{
        f"leaf_{i}": (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for i, (_, v) in enumerate(named)})
    with open(path + ".tree", "w") as f:
        f.write("\n".join(p.lstrip(".") for p, _ in named) + "\n")


def load_state(path: str, like):
    """Restore a state saved by save_state (by this package or by
    ``aosx.io.checkpoint``); ``like`` gives the structure and each leaf's
    dtype and device."""
    data = np.load(path + ".npz")
    leaves_like = [v for _, v in _flatten(like)]
    if len(data.files) != len(leaves_like):
        raise ValueError(f"{path}.npz holds {len(data.files)} leaves, the state {len(leaves_like)}")
    out = []
    for i, ref in enumerate(leaves_like):
        arr = data[f"leaf_{i}"]
        if isinstance(ref, torch.Tensor):
            t = torch.from_numpy(np.array(arr))  # a contiguous copy; keeps 0-d
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"leaf_{i}: shape {tuple(t.shape)}, expected {tuple(ref.shape)}")
            out.append(t.to(dtype=ref.dtype, device=ref.device))
        else:
            out.append(np.asarray(arr, dtype=np.asarray(ref).dtype))
    return _rebuild(like, iter(out))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_cluster_info(path: str, graph, rows_sorted) -> None:
    """The /gvd/save_cluster_info service the reference declares clients
    for (aos_path_gen_node.cpp:106, panel) but never implements: the graph
    and the cluster/label tables as <path>.json + <path>.npz, the same keys
    and arrays as ``aosx.io.checkpoint.save_cluster_info``."""
    n = int(graph.num_nodes)
    e = int(graph.num_edges)
    with open(path + ".json", "w") as f:
        json.dump(dict(num_nodes=n, num_edges=e), f)
    np.savez_compressed(
        path + ".npz",
        nodes=_np(graph.nodes)[:n],
        node_labels=_np(graph.node_labels)[:n],
        label_node=_np(graph.label_node),
        edges=_np(graph.edges)[:e],
        edge_lengths=_np(graph.edge_lengths)[:e],
        row_centers=_np(rows_sorted.center),
        row_ep1=_np(rows_sorted.ep1),
        row_ep2=_np(rows_sorted.ep2),
        row_valid=_np(rows_sorted.valid),
    )
