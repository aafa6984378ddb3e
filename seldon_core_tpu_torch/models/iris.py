"""Iris classifier — the port's counterpart of
``seldon_core_tpu/models/iris.py``: softmax regression fitted at
construction on the classic iris data, serving class probabilities (the
reference's ``predict_proba`` contract).

The JAX unit reads the rows through scikit-learn's ``load_iris``; the
machine with the card has no scikit-learn, so the port bundles the same
150 rows (scikit-learn's own ``datasets/data/iris.csv``) in
``models/data/iris.csv`` and never falls back to synthetic data.  The
features are standardised in numpy float32, as the JAX unit does, and the
fit is ``steps`` full-batch gradient steps from the port's own
``torch.Generator``: carry the JAX unit's fitted state across with
``convert.params_from_jax`` where the two must agree.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.graph.units import Unit, register_unit

__all__ = ["IrisClassifier", "load_iris"]

IRIS_CSV = Path(__file__).resolve().parent / "data" / "iris.csv"


def load_iris() -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(X [150, 4] float32, y [150] int32, the class names) from the bundled
    csv, whose first line is "150,4,setosa,versicolor,virginica"."""
    with open(IRIS_CSV) as f:
        head = f.readline().strip().split(",")
        rows = np.loadtxt(f, delimiter=",")
    n, n_features, names = int(head[0]), int(head[1]), head[2:]
    if rows.shape != (n, n_features + 1):
        raise ValueError(f"{IRIS_CSV}: {rows.shape} rows, the header says {n} x {n_features}")
    return rows[:, :n_features].astype(np.float32), rows[:, -1].astype(np.int32), names


@register_unit("IrisClassifier")
class IrisClassifier(Unit):
    """Multinomial logistic regression; ``predict`` returns class
    probabilities."""

    def __init__(self, steps: int = 200, lr: float = 0.5, seed: int = 0):
        X, y, names = load_iris()
        self.class_names = names
        # standardise features; keep the scaler in the unit for serving
        self._mu = X.mean(axis=0)
        self._sigma = X.std(axis=0) + 1e-6
        Xn = torch.from_numpy((X - self._mu) / self._sigma)
        target = torch.from_numpy(y).long()
        n_classes = int(y.max()) + 1
        g = torch.Generator(device="cpu").manual_seed(int(seed))
        w = 0.01 * torch.randn(Xn.shape[1], n_classes, generator=g)
        b = torch.zeros(n_classes)
        with torch.inference_mode(False), torch.enable_grad():
            w.requires_grad_(True)
            b.requires_grad_(True)
            for _ in range(int(steps)):
                loss = torch.nn.functional.cross_entropy(Xn @ w + b, target)
                gw, gb = torch.autograd.grad(loss, (w, b))
                with torch.no_grad():
                    w -= lr * gw
                    b -= lr * gb
        self._params = {"w": w.detach().clone(), "b": b.detach().clone()}
        with torch.no_grad():
            pred = (Xn @ self._params["w"] + self._params["b"]).argmax(dim=1)
        self._train_accuracy = float((pred == target).float().mean())

    def init_state(self, rng):
        return {"w": self._params["w"].clone(), "b": self._params["b"].clone(),
                "mu": torch.from_numpy(self._mu.copy()),
                "sigma": torch.from_numpy(self._sigma.copy())}

    def predict(self, state, X):
        Xn = (X.float() - state["mu"]) / state["sigma"]
        return torch.softmax(Xn @ state["w"] + state["b"], dim=-1)
