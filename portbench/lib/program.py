"""The system under test, as the harness builds it: a SegCLIP of the port
(`segclip_tpu_torch`) made on the device, holding the weights the harness
drew from the seed."""
from __future__ import annotations

import dataclasses

import torch

from portbench.reference.model import Params


def model_config(config: dict, overrides: dict):
    from segclip_tpu_torch.config import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in {**config, **overrides}.items() if k in fields})


def build_model(config: dict, overrides: dict, params: Params, device: torch.device):
    """(model, its ModelConfig): the port's SegCLIP with every parameter
    copied from `params`, which must name each of them with its shape."""
    from segclip_tpu_torch.models.segclip import SegCLIP
    cfg = model_config(config, overrides)
    with torch.device(device):
        model = SegCLIP(cfg)
    model.to(device)
    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"the program's parameters differ from the reference's: only the "
                       f"program has {sorted(set(own) - set(params))[:5]}, only the "
                       f"reference {sorted(set(params) - set(own))[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            if tuple(p.shape) != tuple(params[name].shape):
                raise ValueError(f"{name}: the program's shape {tuple(p.shape)} is not "
                                 f"the reference's {tuple(params[name].shape)}")
            p.copy_(params[name])
    return model, cfg
