"""Tabular model families — the port's counterpart of
``seldon_core_tpu/models/tabular.py``, under the same unit names and
parameters:

  * ``MeanClassifier``        sigmoid(mean(x) - threshold);
  * ``SigmoidPredictor``      a 2-layer tanh MLP fitted at construction on
                              the synthetic y = [sigmoid(x0 * x1) >= 0.5]
                              task, by full-batch gradient steps from the
                              port's own ``torch.Generator`` (its weights
                              differ from the JAX unit's: carry those
                              across with ``convert.params_from_jax`` where
                              the two must agree);
  * ``MeanTransformer``       min-max normalisation of the whole batch, a
                              ``batch_coupled`` TRANSFORMER (the engine
                              never coalesces requests through it);
  * ``ObliviousTreeEnsemble`` boosted oblivious trees fitted in numpy at
                              construction by the reference's own greedy
                              fit (``_synthetic`` and ``fit_arrays``
                              copied), so its fitted state is bit-identical
                              to the JAX unit's from the same seed; a row's
                              leaf in each tree is d comparisons, its
                              value a gather.

All are plain PyTorch on the engine's device; none reaches a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from seldon_core_tpu_torch.graph.units import Unit, register_unit
from seldon_core_tpu_torch.models.transformer import seeded_generator

__all__ = ["MeanClassifier", "SigmoidPredictor", "MeanTransformer", "ObliviousTreeEnsemble"]


@register_unit("MeanClassifier")
class MeanClassifier(Unit):
    """P(positive) = sigmoid(mean(x) - threshold)."""

    class_names = ["proba"]

    def __init__(self, threshold: float = 0.0, intValue: int = 0):
        # the reference's intValue shifts the trained threshold; keep both
        self.threshold = float(threshold) + int(intValue)

    def init_state(self, rng):
        return {"threshold": torch.tensor(self.threshold, dtype=torch.float32)}

    def predict(self, state, X):
        m = X.float().mean(dim=1, keepdim=True)
        return torch.sigmoid(m - state["threshold"])


@register_unit("SigmoidPredictor")
class SigmoidPredictor(Unit):
    """Binary classifier on the synthetic y = [sigmoid(x0*x1) >= 0.5] task,
    fitted with ``train_steps`` full-batch gradient steps (lr 0.5) at
    ``init_state``."""

    class_names = ["p0", "p1"]

    def __init__(self, n_features: int = 10, hidden: int = 32, train_samples: int = 2048,
                 train_steps: int = 300, seed: int = 0):
        self.n_features = int(n_features)
        self.hidden = int(hidden)
        self.train_samples = int(train_samples)
        self.train_steps = int(train_steps)
        self.seed = int(seed)

    def init_state(self, rng):
        g = seeded_generator(rng, self.seed)
        X = torch.randn(self.train_samples, self.n_features, generator=g)
        y = (torch.sigmoid(X[:, 0] * X[:, 1]) >= 0.5).long()
        params = {
            "w1": torch.randn(self.n_features, self.hidden, generator=g)
            * self.n_features ** -0.5,
            "b1": torch.zeros(self.hidden),
            "w2": torch.randn(self.hidden, 2, generator=g) * self.hidden ** -0.5,
            "b2": torch.zeros(2),
        }
        with torch.inference_mode(False), torch.enable_grad():
            p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            for _ in range(self.train_steps):
                logits = torch.tanh(X @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
                loss = torch.nn.functional.cross_entropy(logits, y)
                grads = torch.autograd.grad(loss, list(p.values()))
                with torch.no_grad():
                    for v, gr in zip(p.values(), grads):
                        v -= 0.5 * gr
        return {k: v.detach().clone() for k, v in p.items()}

    def predict(self, state, X):
        h = torch.tanh(X.float() @ state["w1"] + state["b1"])
        return torch.softmax(h @ state["w2"] + state["b2"], dim=-1)


@register_unit("MeanTransformer")
class MeanTransformer(Unit):
    """Min-max normalise the whole batch to [0, 1]; a constant batch gives
    zeros.  The reduction couples rows, so a request must see only its own
    rows: ``batch_coupled``."""

    batch_coupled = True

    def transform_input(self, state, X):
        X = X.float()
        lo, hi = X.min(), X.max()
        span = hi - lo
        safe = torch.where(span == 0.0, torch.ones_like(span), span)
        return torch.where(span == 0.0, torch.zeros_like(X), (X - lo) / safe)


@register_unit("ObliviousTreeEnsemble")
class ObliviousTreeEnsemble(Unit):
    """Boosted oblivious trees fitted at ``init_state`` on a synthetic
    regression task: every level of a tree shares one (feature, threshold)
    split, so a depth-d tree sends a row to one of 2^d leaves by d
    comparisons.  The greedy CatBoost-style fit is the reference's, in
    numpy."""

    class_names = ["prediction"]

    def __init__(self, n_features: int = 8, n_trees: int = 16, depth: int = 3,
                 learning_rate: float = 0.3, train_samples: int = 1024, seed: int = 0):
        self.n_features = int(n_features)
        self.n_trees = int(n_trees)
        self.depth = int(depth)
        self.lr = float(learning_rate)
        self.train_samples = int(train_samples)
        self.seed = int(seed)

    # -- fitting (host-side numpy, the reference's own) --------------------

    def _synthetic(self, rng):
        X = rng.normal(size=(self.train_samples, self.n_features))
        y = (
            np.sin(X[:, 0]) + 0.5 * X[:, 1] * (X[:, 2] > 0)
            + 0.25 * rng.normal(size=self.train_samples)
        )
        return X, y

    def fit_arrays(self, X, y):
        """Greedy fit; returns (feat [T,d], thresh [T,d], leaves [T,2^d], base)."""
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        base = float(y.mean())
        resid = y - base
        feats = np.zeros((self.n_trees, self.depth), np.int32)
        thrs = np.zeros((self.n_trees, self.depth), np.float64)
        leaves = np.zeros((self.n_trees, 2 ** self.depth), np.float64)
        qgrid = np.linspace(0.1, 0.9, 9)
        # candidate thresholds depend only on X: one vectorised pass
        cand_thrs = np.quantile(X, qgrid, axis=0)  # [Q, F]
        for t in range(self.n_trees):
            codes = np.zeros(len(X), np.int64)
            for lvl in range(self.depth):
                best = (None, None, np.inf)
                for f in range(self.n_features):
                    for qi in range(len(qgrid)):
                        thr = cand_thrs[qi, f]
                        cand = codes * 2 + (X[:, f] > thr)
                        # SSE after assigning mean residual per candidate leaf
                        sums = np.bincount(cand, weights=resid, minlength=2 ** (lvl + 1))
                        cnts = np.bincount(cand, minlength=2 ** (lvl + 1))
                        means = sums / np.maximum(cnts, 1)
                        sse = np.sum((resid - means[cand]) ** 2)
                        if sse < best[2]:
                            best = (f, thr, sse)
                feats[t, lvl], thrs[t, lvl] = best[0], best[1]
                codes = codes * 2 + (X[:, feats[t, lvl]] > thrs[t, lvl])
            sums = np.bincount(codes, weights=resid, minlength=2 ** self.depth)
            cnts = np.bincount(codes, minlength=2 ** self.depth)
            leaf_vals = self.lr * sums / np.maximum(cnts, 1)
            leaves[t] = leaf_vals
            resid = resid - leaf_vals[codes]
        return feats, thrs, leaves, base

    def init_state(self, rng):
        X, y = self._synthetic(np.random.default_rng(self.seed))
        feats, thrs, leaves, base = self.fit_arrays(X, y)
        return {
            "feat": torch.from_numpy(feats),                              # [T, d] int32
            "thresh": torch.from_numpy(thrs.astype(np.float32)),          # [T, d]
            "leaves": torch.from_numpy(leaves.astype(np.float32)),        # [T, 2^d]
            "base": torch.tensor(base, dtype=torch.float32),
        }

    # -- inference ---------------------------------------------------------

    def predict(self, state, X):
        X = X.float()                                                     # [B, F]
        T, d = state["feat"].shape
        gathered = X[:, state["feat"].reshape(-1).long()].reshape(-1, T, d)
        bits = (gathered > state["thresh"][None]).long()                  # [B, T, d]
        weights = 2 ** torch.arange(d - 1, -1, -1, device=X.device)
        codes = (bits * weights).sum(dim=-1)                              # [B, T]
        per_tree = state["leaves"][torch.arange(T, device=X.device), codes]  # [B, T]
        return (state["base"] + per_tree.sum(dim=1))[:, None]
