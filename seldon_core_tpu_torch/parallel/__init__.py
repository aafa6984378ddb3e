"""Parallel layers of the port: device meshes (``mesh.py``), the sharded
ensemble (``ensemble.py``), the mixture-of-experts layer with its
expert-parallel layout (``moe.py``), ring attention over ``sp``
(``ring_attention.py``), the GPipe pipeline over ``pp`` (``pipeline.py``)
and processes that run one sharded program together, one process a card
(``multihost.py``)."""

from seldon_core_tpu_torch.parallel import multihost  # noqa: F401
