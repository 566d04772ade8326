"""Compact storage of jump-flood planes for the stored flood references.

A flood's owner plane (i32, S = no owner) compresses well; its x and y
planes hold a seed's coordinate in every cell, nearly always the owner's
(row S of the seed table, 1e9, where no owner). ``pack`` keeps the owner
plane of each state and, of the x and y planes, only the cells whose value
is not their owner's seed's; ``unpack`` rebuilds the planes bitwise. No JAX and no torch:
the reference scripts write with it and the tests read with it.
"""

from __future__ import annotations

import numpy as np


def _table(xy):
    return np.concatenate([np.asarray(xy, np.float32), np.float32([[1e9, 1e9]])])


def pack(prefix, states, xy, out):
    """Add the planes of ``states`` (a list of (owner, x, y) or of owner
    planes alone) to the dict ``out`` under ``prefix``."""
    table = _table(xy)
    out[f"{prefix}n"] = np.int32(len(states))
    for k, st in enumerate(states):
        o = np.asarray(st[0] if isinstance(st, tuple) else st, np.int32)
        flat = o.reshape(-1)
        # 16 bits where every owner fits (S <= 65535, no -1)
        out[f"{prefix}o{k}"] = o.astype(np.uint16) if o.min() >= 0 and o.max() < 65536 else o
        if isinstance(st, tuple):
            seed_of = table[np.minimum(flat, len(table) - 1)]
            for q, name in ((1, "x"), (2, "y")):
                v = np.asarray(st[q], np.float32).reshape(-1)
                idx = np.flatnonzero(v.view(np.uint32) != seed_of[:, q - 1].view(np.uint32))
                out[f"{prefix}{name}{k}_idx"] = idx.astype(np.int32)
                out[f"{prefix}{name}{k}_val"] = v[idx]


def unpack(prefix, data, xy, shape):
    """The states stored under ``prefix``: a list of (owner, x, y) numpy
    planes, or of owner planes where no x and y were stored."""
    table = _table(xy)
    states = []
    for k in range(int(data[f"{prefix}n"])):
        flat = np.array(data[f"{prefix}o{k}"], np.int32).reshape(-1)
        if flat.shape == (1,):
            # stored once, under owner/ (the flood's live owner plane, -1 for
            # none): the same cells, S for none
            flat = np.array(data["owner/o0"], np.int32).reshape(-1)
            flat = np.where(flat < 0, len(table) - 1, flat)
        if f"{prefix}x{k}_idx" not in data:
            states.append(flat.reshape(shape))
            continue
        seed_of = table[np.minimum(flat, len(table) - 1)]
        planes = []
        for q, name in ((1, "x"), (2, "y")):
            v = seed_of[:, q - 1].copy()
            v[data[f"{prefix}{name}{k}_idx"]] = data[f"{prefix}{name}{k}_val"]
            planes.append(v.reshape(shape))
        states.append((flat.reshape(shape), *planes))
    return states
