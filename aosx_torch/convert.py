"""State carried across the package boundary as numpy arrays.

``to_torch(obj, cls, device)`` builds a port dataclass from any object (or
dict) whose same-named fields hold array-likes: a port value, a dict from
``to_numpy``, or a JAX value, since ``np.asarray`` reads each leaf. So the
port never needs jax to take a JAX package's output as its input: a JAX
``ServeState`` becomes ``to_torch(sv, serving.ServeState, device)``.

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
    same-named fields. Fields annotated with a dataclass or a
    ``tuple[...]`` of them (``IncrementalState.cfg``) are rebuilt nested;
    leaves keep their dtype; None stays None."""
    hints = typing.get_type_hints(cls)
    return cls(**{f.name: _field(_get(obj, f.name), hints.get(f.name), device)
                  for f in dataclasses.fields(cls)})


def _field(v, hint, device):
    if v is None:
        return None
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        return to_torch(v, hint, device)
    if typing.get_origin(hint) is tuple:
        return tuple(_field(x, h, device) for x, h in zip(v, typing.get_args(hint), strict=True))
    return _leaf(v, device)


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
