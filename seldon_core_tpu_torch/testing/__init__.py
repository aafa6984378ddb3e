"""Test harnesses and tooling of the port: ``faults.py``, the seeded fault
injection the resilience layer is held to; ``contract.py`` (contract-based
request generation), ``api_tester.py`` and ``loadtest.py`` (the reference's
wrappers/testing/tester.py, util/api_tester, util/loadtester); and
``toy_engine.py``, a killable engine for chaos drills.  The names load at
first use, so ``python -m seldon_core_tpu_torch.testing.<module>`` runs its
module once."""

import importlib

__all__ = ["Contract", "generate_batch", "validate_response"]


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.contract"), name)
