"""The random draws of a training step, named by the site that makes them.

The JAX package threads ``jax.random`` keys through the step
(``engine/trainer.py::_train_step`` folds the step into the key, :326). The
port draws from one explicit ``torch.Generator`` a step instead, seeded from
(seed, step) by :func:`step_generator`, so that a resumed run draws what an
unbroken one does. Every draw names its site (a tuple such as
``("match", "final")`` or ``("noise", t, "perm")``); :class:`Draws` ignores
the name and draws in call order, and a test may stand in an object with the
same three methods that answers by name (the parity tests answer with the
JAX package's own draws for that site).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

Site = Tuple


class Draws:
    """Uniform floats, permutations and integers from one generator, on the
    generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def uniform(self, site: Site, shape: Sequence[int]) -> torch.Tensor:
        """float32 in [0, 1)."""
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def permutation(self, site: Site, batch: int, n: int) -> torch.Tensor:
        """(batch, n) int64: one permutation of range(n) a row."""
        keys = torch.rand((batch, n), generator=self.generator, device=self.device)
        return keys.argsort(dim=1)

    def randint(self, site: Site, low: int, high: int, shape: Sequence[int]) -> torch.Tensor:
        """int64 in [low, high)."""
        return torch.randint(low, high, tuple(shape), generator=self.generator, device=self.device)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of training step ``step`` (the counterpart of
    ``jax.random.fold_in(key(seed), step)``)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(step)) % (2**63))
    return g
