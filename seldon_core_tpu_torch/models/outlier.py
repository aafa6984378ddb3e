"""Streaming Mahalanobis outlier detector — the port's counterpart of
``seldon_core_tpu/models/outlier.py``: a TRANSFORMER that tracks a running
mean and covariance, projects each batch onto the top ``n_components``
principal components, scores each row by its Mahalanobis distance in that
subspace and tags the scores into ``meta.tags["outlierScore"]``, passing
the data through unchanged.

Each call is one batched state transition: the mean and covariance take
the batch in one rank-nb correction, ``torch.linalg.eigh`` gives the
components and ``torch.linalg.solve`` the distances against the
regularised projected covariance.  On the card both are library calls
(cuSOLVER), as XLA's are in the JAX package: no Pallas kernel computes
them.  The state moves on every predict (``updates_state_on_predict``),
so the engine runs this unit's dispatches one at a time.
"""

from __future__ import annotations

import torch

from seldon_core_tpu_torch.graph.units import Unit, UnitAux, register_unit

__all__ = ["MahalanobisOutlier"]

_EPS = 1e-6


@register_unit("MahalanobisOutlier")
class MahalanobisOutlier(Unit):
    updates_state_on_predict = True  # the running mean/cov count every row seen

    def __init__(self, n_features: int, n_components: int = 3, max_n: int = -1):
        self.p = int(n_features)
        self.k = min(int(n_components), self.p)
        self.max_n = int(max_n)  # -1: unbounded (the reference's max_n=None)

    def init_state(self, rng):
        return {"mean": torch.zeros(self.p), "C": torch.zeros(self.p, self.p),
                "n": torch.tensor(0.0)}

    def transform_input(self, state, X):
        X = X.reshape(X.shape[0], -1).float()
        nb = X.shape[0]
        n = state["n"]
        if self.max_n > 0:
            n = torch.clamp(n, max=float(self.max_n))

        # the running mean and covariance with this batch
        batch_mean = X.mean(dim=0)
        new_mean = state["mean"] + (nb / (n + nb)) * (batch_mean - state["mean"])
        centered = X - new_mean[None, :]
        batch_cov = (centered.T @ centered) / nb
        new_C = torch.where(n > 0, (n / (n + nb)) * state["C"] + (nb / (n + nb)) * batch_cov,
                            batch_cov)

        # the top-k principal components
        _, eigvects = torch.linalg.eigh(new_C)  # ascending
        top = eigvects[:, -self.k:]  # [p, k]
        proj = centered @ top  # [nb, k]
        proj_cov = top.T @ new_C @ top + _EPS * torch.eye(self.k, device=X.device)

        # the Mahalanobis distance in the components' subspace
        solved = torch.linalg.solve(proj_cov, proj.T)  # [k, nb]
        scores = (proj * solved.T).sum(dim=1)  # [nb]

        new_state = {"mean": new_mean, "C": new_C, "n": state["n"] + nb}
        return X, UnitAux(state=new_state, tags={"outlierScore": scores})
