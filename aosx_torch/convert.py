"""State carried across the package boundary as numpy arrays.

``to_torch(obj, cls, device)`` builds a port dataclass from any object (or
dict) whose same-named fields hold array-likes: a port value, a dict from
``to_numpy``, or a JAX value, since ``np.asarray`` reads each leaf. So the
port never needs jax to take a JAX package's output as its input.

``to_numpy(obj)`` walks a dataclass (of this package or any other), a dict,
a list or a tuple down to nested dicts of numpy arrays.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch


def _get(obj, name):
    if isinstance(obj, dict):
        return obj[name]
    return getattr(obj, name)


def to_torch(obj, cls, device):
    """A ``cls`` (a dataclass of this package) on ``device`` from ``obj``'s
    same-named fields. Leaves keep their dtype; None stays None."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = _get(obj, f.name)
        hint = hints.get(f.name)
        if v is None:
            kwargs[f.name] = None
        elif isinstance(hint, type) and dataclasses.is_dataclass(hint):
            kwargs[f.name] = to_torch(v, hint, device)
        else:
            kwargs[f.name] = _leaf(v, device)
    return cls(**kwargs)


def _leaf(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_numpy(obj):
    """Nested dicts of numpy arrays from dataclasses, dicts, lists, tuples
    and tensors or array-likes."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_numpy(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)
