"""Weights made from the seed, on the device, in one draw.

One ``torch.rand`` call on a generator seeded from the run's seed fills
every floating tensor of the parameter spec (``reference.param_spec``),
each slice scaled by the rule of its kind:

  * ``scratch``: what a model built from scratch starts from (torch's
    default initialisation: conv and linear weights and biases uniform in
    +-1/sqrt(fan_in), the attention in-projection Xavier-uniform with a zero
    bias, batch norm and LayerNorm at weight 1, bias 0, running mean 0 and
    running variance 1);
  * ``trained``: the same scales with every batch-norm and LayerNorm
    parameter, the running statistics and the in-projection bias moved off
    their initial values, so that the eval path reads each of them.
"""

from __future__ import annotations

import math

import torch


def make_state(spec, seed: int, device, style: str = "scratch") -> dict:
    """{state-dict name: float32 tensor on ``device``} (and int64 counts)."""
    if style not in ("scratch", "trained"):
        raise ValueError(f"style must be 'scratch' or 'trained', got {style!r}")
    trained = style == "trained"
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    sizes = [math.prod(shape) for _, shape, kind in spec if kind[0] != "count"]
    u = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    state, start = {}, 0
    for name, shape, kind in spec:
        if kind[0] == "count":
            state[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        x = u[start:start + n].view(shape)
        start += n
        k = kind[0]
        if k == "fan":
            v = x / math.sqrt(kind[1])
        elif k == "xavier":
            v = x * math.sqrt(6.0 / kind[1])
        elif k in ("weight", "ln_weight"):
            v = 1.0 + 0.2 * x if trained else torch.ones_like(x)
        elif k in ("bias", "ln_bias", "running_mean", "in_bias"):
            v = 0.1 * x if trained else torch.zeros_like(x)
        elif k == "running_var":
            v = 1.0 + 0.5 * x if trained else torch.ones_like(x)
        else:
            raise ValueError(f"unknown parameter kind {kind!r} of {name}")
        state[name] = v.contiguous()
    return state
