"""Parameter initializers with torch's distributions, drawn from an
explicit ``torch.Generator`` (counterpart of pytorch_ddp_resnet_tpu/ops/
initializers.py; same distributions, different draws):

- top-level convs: ``kaiming_normal`` = N(0, 2/fan_in), fan_in = K*K*Cin;
- every other conv/linear weight and bias: torch's default
  ``kaiming_uniform_(a=sqrt(5))`` = U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def kaiming_normal(shape: Sequence[int], fan_in: int,
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.float32) -> torch.Tensor:
    std = (2.0 / fan_in) ** 0.5
    return std * torch.randn(tuple(shape), generator=generator, dtype=dtype)


def torch_default_uniform(shape: Sequence[int], fan_in: int,
                          generator: Optional[torch.Generator] = None,
                          dtype=torch.float32) -> torch.Tensor:
    bound = fan_in ** -0.5
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
    return u * (2 * bound) - bound
