"""The operator's renderer and packager for the port: Kubernetes manifests
for GPU engine pods (``manifests.py``, helm-equivalent) and model images
(``packaging.py``, s2i-equivalent).  The JAX package's local operator
(materializer, reconciler, rollouts, scale-ahead, bundles) is not ported
yet.  The names load at first use, so ``python -m
seldon_core_tpu_torch.operator.manifests`` runs its module once."""

import importlib

__all__ = ["generate_manifests", "to_yaml_stream", "ImageSpec", "package_model"]

_HOME = {"generate_manifests": "manifests", "to_yaml_stream": "manifests",
         "ImageSpec": "packaging", "package_model": "packaging"}


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
