"""What the drivers share: the configuration's shapes and parameters built
for the program, and the seed's population keys."""

from __future__ import annotations

import dataclasses


def statics(config_module, cfg: dict):
    """The configuration's Statics preset (by name, from the program's
    ``config`` module) with the file's ``statics_overrides`` applied."""
    s = getattr(config_module, cfg["statics"])
    return dataclasses.replace(s, **cfg.get("statics_overrides", {}))


def orchard_spec(spec_type, cfg: dict):
    d = dict(cfg["orchard"])
    d["origin"] = tuple(d["origin"])
    return spec_type(**d)


def params(config_module, cfg: dict, device):
    """AosParams() with the file's overrides as f32 tensors on ``device``."""
    return config_module.params_as_f32(config_module.AosParams(**cfg.get("params", {})), device)


def population_keys(seed: int, n: int):
    """The population's first n keys, int64 [n, 2] (the benchmark's own
    threefry split of the seed's key, ``reference.keys``): the input both
    the program and the reference draw the orchards from."""
    import torch

    from portbench.reference.keys import population_keys as keys

    return torch.from_numpy(keys(seed, n))
