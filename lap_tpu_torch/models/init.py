"""Seeded random initialisation of the port's modules (no checkpoint needed)."""

from __future__ import annotations

import math

import torch
from torch import nn


def random_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter of ``module`` with seeded, non-zero random values.

    Modules that define ``random_init_`` fill their own direct parameters; ``Linear``
    weights get std fan_in**-0.5, ``LayerNorm`` weights 1 + N(0, 0.1^2), other
    biases N(0, 0.02^2). Nothing is left zero: a zero adaRMS modulation would
    make every action-expert layer an identity. The generator lives on the
    parameters' device, so a full-size model is filled on the card.
    """
    params = list(module.parameters())
    if not params:
        return module
    gen = torch.Generator(device=params[0].device).manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "random_init_") and m is not module:
                m.random_init_(gen)
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features**-0.5, generator=gen)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.02, generator=gen)
            elif isinstance(m, nn.Conv2d):
                fan_in = math.prod(m.weight.shape[1:])
                m.weight.normal_(0.0, fan_in**-0.5, generator=gen)
                m.bias.normal_(0.0, 0.02, generator=gen)
            elif isinstance(m, nn.LayerNorm):
                m.weight.normal_(1.0, 0.1, generator=gen)
                m.bias.normal_(0.0, 0.02, generator=gen)
    return module
