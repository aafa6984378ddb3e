"""The port's deployment operator: materializes SeldonDeployment specs into
running engines and units on the card, watches a spec directory and tracks
status (``materializer.py``); walks canary rollouts with automatic rollback
(``rollouts.py``) and plans replicas ahead of load (``scaleahead.py``);
reconciles CRs against a (pluggable) Kubernetes API server with CRD
bootstrap and status write-back (``reconciler.py``); renders Kubernetes
manifests for GPU engine pods (``manifests.py``, helm-equivalent), the
platform bundle (``bundle.py``) and model images (``packaging.py``,
s2i-equivalent).  The names load at first use, so ``python -m
seldon_core_tpu_torch.operator.<module>`` runs its module once."""

import importlib

__all__ = ["Materializer", "generate_manifests", "to_yaml_stream", "ImageSpec",
           "package_model", "FakeKubeApi", "KubeClient", "KubectlClient", "Reconciler"]

_HOME = {"Materializer": "materializer",
         "generate_manifests": "manifests", "to_yaml_stream": "manifests",
         "ImageSpec": "packaging", "package_model": "packaging",
         "FakeKubeApi": "reconciler", "KubeClient": "reconciler",
         "KubectlClient": "reconciler", "Reconciler": "reconciler"}


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
