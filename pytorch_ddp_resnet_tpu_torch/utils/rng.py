"""Random streams keyed like the JAX package's PRNG keys.

The JAX package derives every random draw of a train step from one key by
``fold_in`` and ``split``: the step key is ``fold_in(root, global_step)``,
the augmentation takes ``fold_in(step, 0)`` and the model
``fold_in(step, 1)``, and each layer of a ``Sequential`` folds in its index.
``Key`` keeps that tree of derivations, so every draw is a pure function of
(seed, path) and does not depend on the order in which layers run, but the
streams themselves are torch's: a node seeds a ``torch.Generator`` from its
path. The numbers differ from JAX's for the same seed (PARITY.md divergence
6); the tests hand the port a key that answers with the JAX draws instead
(``tests/_torch_port_helpers.py`` ``JaxKey``), through the same five draw
methods below.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_SPLIT = 1 << 32  # path tag of a split() child; fold_in data stay below it


class Key:
    """One node of a fold_in/split tree rooted at ``seed``."""

    def __init__(self, seed: int, path: Tuple[int, ...] = ()):
        if seed < 0:
            raise ValueError(f"seed must be non-negative, got {seed}")
        self.seed = int(seed)
        self.path = tuple(path)

    def fold_in(self, data: int) -> "Key":
        if not 0 <= data < _SPLIT:
            raise ValueError(f"fold_in data {data} out of [0, 2^32)")
        return Key(self.seed, self.path + (int(data),))

    def split(self, num: int = 2) -> Tuple["Key", ...]:
        return tuple(Key(self.seed, self.path + (_SPLIT, i))
                     for i in range(num))

    def generator(self, device) -> torch.Generator:
        words = np.random.SeedSequence(
            [self.seed, *self.path]).generate_state(2, np.uint32)
        g = torch.Generator(device=device)
        g.manual_seed(int(words[0]) << 32 | int(words[1]))
        return g

    # --- draws --------------------------------------------------------------

    def bits(self, shape: Sequence[int], device) -> torch.Tensor:
        """Uniform uint8 bits (dropout masks)."""
        return torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                             generator=self.generator(device), device=device)

    def dropout_seed(self, device) -> torch.Tensor:
        """A uniform 32-bit draw as a 0-d int32 tensor on ``device`` (the
        in-kernel dropout seed; it stays on the device, and the kernels
        read it through its pointer)."""
        return torch.randint(-2 ** 31, 2 ** 31, (), dtype=torch.int64,
                             generator=self.generator(device),
                             device=device).to(torch.int32)

    def randint(self, shape: Sequence[int], low: int, high: int,
                device) -> torch.Tensor:
        """Uniform int32 in [low, high) (crop corners)."""
        return torch.randint(low, high, tuple(shape), dtype=torch.int32,
                             generator=self.generator(device), device=device)

    def bernoulli(self, p: float, shape: Sequence[int],
                  device) -> torch.Tensor:
        """Bool, True with probability p (flips)."""
        u = torch.rand(tuple(shape), generator=self.generator(device),
                       device=device)
        return u < p
