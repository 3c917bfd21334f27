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

A DVIS-DAQ step trains its clips one at a time, and what a clip draws
depends on its data; so clip b draws from a generator of its own
(:func:`clip_draws`: :meth:`Draws.for_clip`, seeded by the step's seed and
b), or, from a draws object that answers by name, under the sites
``("clip", b, ...)``. Under data parallelism a rank draws through
:class:`BlockDraws`: every draw at the whole batch's shape, the rank's rows
kept, and clip b of its block is clip ``start + b`` of the batch; so a rank
draws what the one-process step draws for its clips.
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
        self._clips = {}

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

    def for_clip(self, b: int) -> "Draws":
        """Clip b's draws: one generator a clip, seeded by this generator's
        seed and b, the same object at every call (a clip's forward and
        loss draw from one stream)."""
        if b not in self._clips:
            g = torch.Generator(device=self.device)
            g.manual_seed((self.generator.initial_seed() * 7_919 + 1 + int(b)) % (2**63))
            self._clips[b] = Draws(g)
        return self._clips[b]


def clip_draws(draws, b: int):
    """Clip b's draws of a step: ``draws.for_clip(b)`` where it has one,
    else ``draws`` with the sites under ``("clip", b)``."""
    for_clip = getattr(draws, "for_clip", None)
    return for_clip(b) if for_clip is not None else Scoped(draws, ("clip", b))


class BlockDraws:
    """A rank's draws when it holds clips ``[start, start + size)`` of a
    ``total``-clip batch: a draw whose leading axis is k rows a clip (the
    clips' frames, instances, queries, clip-major) is made at the whole
    batch's k·total rows and the rank's k·size rows are kept."""

    def __init__(self, draws, start: int, size: int, total: int):
        self.draws, self.start, self.size, self.total = draws, start, size, total

    def _rows(self, n: int):
        if n % self.size:
            raise ValueError(f"a draw of {n} rows over a block of {self.size} clips")
        k = n // self.size
        return k * self.total, slice(k * self.start, k * (self.start + self.size))

    def uniform(self, site: Site, shape: Sequence[int]) -> torch.Tensor:
        n, rows = self._rows(shape[0])
        return self.draws.uniform(site, (n, *shape[1:]))[rows]

    def permutation(self, site: Site, batch: int, n: int) -> torch.Tensor:
        b, rows = self._rows(batch)
        return self.draws.permutation(site, b, n)[rows]

    def randint(self, site: Site, low: int, high: int, shape: Sequence[int]) -> torch.Tensor:
        n, rows = self._rows(shape[0])
        return self.draws.randint(site, low, high, (n, *shape[1:]))[rows]

    def for_clip(self, b: int):
        return clip_draws(self.draws, self.start + b)


class Scoped:
    """A draws object whose sites carry ``prefix`` first (a clip's draws in
    a batch, the slot branch's beside the main one)."""

    def __init__(self, draws, prefix: Site):
        self.draws, self.prefix = draws, tuple(prefix)

    def uniform(self, site: Site, shape: Sequence[int]) -> torch.Tensor:
        return self.draws.uniform((*self.prefix, *site), shape)

    def permutation(self, site: Site, batch: int, n: int) -> torch.Tensor:
        return self.draws.permutation((*self.prefix, *site), batch, n)

    def randint(self, site: Site, low: int, high: int, shape: Sequence[int]) -> torch.Tensor:
        return self.draws.randint((*self.prefix, *site), low, high, shape)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of training step ``step`` (the counterpart of
    ``jax.random.fold_in(key(seed), step)``)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(step)) % (2**63))
    return g
