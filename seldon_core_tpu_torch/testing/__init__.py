"""Test harnesses of the port: ``faults.py``, the seeded fault injection
the resilience layer is held to (the JAX package's ``testing/faults.py``)."""
