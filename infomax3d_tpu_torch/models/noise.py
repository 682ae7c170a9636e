"""Noise sources and dropout for the port's random models.

A noise source hands out float32 draws: ``normal(shape)`` (standard
normal), ``uniform(shape)`` (U[0, 1)) and ``bernoulli(p, shape)`` (a bool
mask, true with probability p), called in the JAX model's order of
`jax.random` draws.  `GeneratorNoise` draws from a `torch.Generator` and
records its draws; `ReplayNoise` hands out given draws again, in order.
The JAX package draws the normal and uniform noise from its ``random`` rng
and the dropout masks from its ``dropout`` rng, two streams: a
`ReplayNoise` given a `fresh` source replays the first and draws the masks
from `fresh`, so a gradient pass can repeat a cost pass's noise (which
draws no masks: it runs in eval mode) with masks of its own.

`dropout` is flax's ``nn.Dropout``: ``where(keep, x / keep_prob, 0)`` with
``keep`` a Bernoulli(keep_prob) mask of x's shape, in training mode only.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


class GeneratorNoise:
    """Draws from `generator` on the generator's own device (a CUDA
    generator draws on the card, with no copy from the host); every draw
    is kept in `draws` as ``(kind, tensor)`` so that `ReplayNoise` can hand
    the same draws to a second pass."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.draws: List[Tuple[str, torch.Tensor]] = []

    def _draw(self, kind: str, shape, p: float = 0.0) -> torch.Tensor:
        dev = self.generator.device
        if kind == "normal":
            t = torch.randn(tuple(shape), generator=self.generator, device=dev)
        else:
            t = torch.rand(tuple(shape), generator=self.generator, device=dev)
            if kind == "bernoulli":
                t = t < p
        self.draws.append((kind, t))
        return t

    def normal(self, shape) -> torch.Tensor:
        return self._draw("normal", shape)

    def uniform(self, shape) -> torch.Tensor:
        return self._draw("uniform", shape)

    def bernoulli(self, p: float, shape) -> torch.Tensor:
        return self._draw("bernoulli", shape, p)


class ReplayNoise:
    """Given draws ``(kind, tensor)`` handed out in order; a draw of another
    kind or shape than the next one raises, as does running out.  With
    `fresh`, Bernoulli draws come from `fresh` instead (module
    docstring)."""

    def __init__(self, draws: Sequence[Tuple[str, torch.Tensor]],
                 fresh=None):
        self.draws = list(draws)
        self.used = 0
        self.fresh = fresh

    def _next(self, kind: str, shape) -> torch.Tensor:
        if self.used >= len(self.draws):
            raise RuntimeError(f"ReplayNoise: no draw left for {kind} "
                               f"{tuple(shape)}")
        k, t = self.draws[self.used]
        if k != kind or tuple(t.shape) != tuple(shape):
            raise RuntimeError(f"ReplayNoise: draw {self.used} is {k} "
                               f"{tuple(t.shape)}, asked for {kind} "
                               f"{tuple(shape)}")
        self.used += 1
        return t

    def normal(self, shape) -> torch.Tensor:
        return self._next("normal", shape)

    def uniform(self, shape) -> torch.Tensor:
        return self._next("uniform", shape)

    def bernoulli(self, p: float, shape) -> torch.Tensor:
        if self.fresh is not None:
            return self.fresh.bernoulli(p, shape)
        return self._next("bernoulli", shape)


class MasksOnly:
    """Dropout masks from `source` and no noise: `noise_columns` gives
    zeros for this source, as the JAX models do without their 'random'
    rng; any other draw raises."""

    gives_noise = False

    def __init__(self, source):
        self.source = source

    def bernoulli(self, p: float, shape) -> torch.Tensor:
        return self.source.bernoulli(p, shape)


def dropout(x: torch.Tensor, rate: float, noise, training: bool
            ) -> torch.Tensor:
    """flax's ``nn.Dropout(rate)`` on x: identity in eval mode or at rate
    0, zeros at rate 1, else the kept entries scaled by 1 / keep_prob, the
    mask drawn from `noise` (required in training)."""
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if noise is None:
        raise ValueError("dropout in training mode needs a noise source")
    keep_prob = 1.0 - rate
    keep = noise.bernoulli(keep_prob, x.shape).to(x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def noise_columns(noise: Optional[object], rows: int, dim: int, std: float,
                  like: torch.Tensor) -> torch.Tensor:
    """``std * normal((rows, dim))`` from `noise` in `like`'s dtype, or
    zeros without a source or from a source of masks alone (the JAX models
    without their 'random' rng)."""
    if noise is None or not getattr(noise, "gives_noise", True):
        return like.new_zeros((rows, dim))
    return std * noise.normal((rows, dim)).to(like.dtype)
