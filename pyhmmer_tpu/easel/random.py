"""Pseudo-random number generation.

Mirrors ``pyhmmer.easel.Randomness`` (reference ``easel.pyx:6958-7118``;
Easel ``esl_random``): a Mersenne-twister generator with ``seed``,
``random``, ``normalvariate``, and copy/pickle support.  The underlying
stream is NumPy's MT19937, not Easel's (seed-for-seed parity with Easel
streams is not promised -- reference for the consequences:
PARITY_NOTES.md, sampler-dependent values are statistical)."""

from __future__ import annotations

import numpy as np

__all__ = ["Randomness"]


class Randomness:
    """A Mersenne-twister pseudo-random number generator."""

    def __init__(self, seed: int = 0):
        self._seed = seed
        self._rng = np.random.RandomState(seed if seed != 0 else None)

    def seed(self, n: int = 0) -> None:
        """Reseed the generator (0 selects an arbitrary seed, as Easel)."""
        self._seed = n
        self._rng = np.random.RandomState(n if n != 0 else None)

    def random(self) -> float:
        """A uniform deviate in ``[0, 1)``."""
        return float(self._rng.random_sample())

    def normalvariate(self, mean: float, stddev: float) -> float:
        """A Gaussian deviate."""
        return float(self._rng.normal(mean, stddev))

    def uniformvariate(self, a: float, b: float) -> float:
        return float(self._rng.uniform(a, b))

    def choice(self, n, p=None) -> int:
        return int(self._rng.choice(n, p=p))

    @property
    def fast(self) -> bool:
        """`bool`: whether this is the "fast" linear congruential
        generator (always `False`: this package only ships MT)."""
        return False

    def copy(self) -> "Randomness":
        out = Randomness.__new__(Randomness)
        out._seed = self._seed
        out._rng = np.random.RandomState()
        out._rng.set_state(self._rng.get_state())
        return out

    def getstate(self):
        return self._rng.get_state()

    def setstate(self, state) -> None:
        self._rng.set_state(state)

    def __getstate__(self):
        return {"seed": self._seed, "state": self._rng.get_state()}

    def __setstate__(self, state):
        self._seed = state["seed"]
        self._rng = np.random.RandomState()
        self._rng.set_state(state["state"])

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._seed!r})"
