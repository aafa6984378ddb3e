"""Epsilon-greedy multi-armed-bandit router — the port's counterpart of
``seldon_core_tpu/models/mab.py`` (the reference's ROUTER example,
examples/routers/epsilon_greedy/EpsilonGreedy.py:12-61):

  * ``route``: with probability 1 - epsilon exploit the best branch,
    otherwise explore uniformly among the *other* branches (the current
    best is never explored);
  * ``send_feedback``: a reward in [0, 1] over a batch of n rows counts
    floor(reward * n) successes and n tries on the routed branch; the best
    branch is the argmax of the Laplace-smoothed ratio (success + 1) /
    (tries + 1).

The state (``success``, ``tries`` and the router's key) is an explicit
dict of tensors on the engine's device, threaded by the executor; the
feedback pass replays ``meta.routing``.  The key is the port's own
(``models/prng.py``), not ``jax.random``'s: the two draw different bits,
and ``_draws`` is the one place a route takes its random numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from seldon_core_tpu_torch.graph.units import Unit, UnitAux, register_unit
from seldon_core_tpu_torch.models import prng

__all__ = ["EpsilonGreedyRouter"]


@register_unit("EpsilonGreedyRouter")
class EpsilonGreedyRouter(Unit):
    def __init__(self, n_branches: int = None, epsilon: float = 0.1, seed: int = 0):
        if n_branches is None:
            raise ValueError("n_branches parameter must be given")
        self.n = int(n_branches)
        self.epsilon = float(epsilon)
        self.seed = int(seed)

    def init_state(self, rng):
        return {"success": torch.zeros(self.n), "tries": torch.zeros(self.n),
                "key": prng.key(self.seed if rng is None else rng.initial_seed())}

    def _best(self, state):
        return torch.argmax((state["success"] + 1.0) / (state["tries"] + 1.0))

    def _draws(self, key):
        """(the next key, a uniform draw in [0, 1) for the explore coin, a
        uniform index in [0, n - 2] among the other branches) from ``key``."""
        key, sub = prng.split(key)
        k_explore, k_choice = prng.split(sub)
        u = prng.uniform(k_explore, 1)[0]
        other = (prng.uniform(k_choice, 1)[0] * max(self.n - 1, 1)).long()
        return key, u, other

    def route(self, state, X):
        key, u, other = self._draws(state["key"])
        best = self._best(state)
        # the draw in [0, n - 2] shifted past the best branch
        other = other + (other >= best).long()
        branch = torch.where(u <= self.epsilon, other, best)
        return branch, UnitAux(state={**state, "key": key})

    def send_feedback(self, state, X, branch, reward, truth):
        n_rows = np.float32(X.shape[0] if X is not None else 1)
        n_success = float(np.floor(np.float32(reward) * n_rows))  # in f32, as the reference
        # branch -1 (feedback without recorded routing), or one out of
        # range, matches no branch: a no-op, as the reference's one-hot is
        onehot = (torch.arange(self.n, device=state["success"].device) == int(branch)).float()
        return {"success": state["success"] + onehot * n_success,
                "tries": state["tries"] + onehot * float(n_rows),
                "key": state["key"]}
