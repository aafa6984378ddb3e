"""Parallel layers of the port: device meshes held by one process
(``mesh.py``), the sharded ensemble (``ensemble.py``), the mixture-of-
experts layer with its expert-parallel layout (``moe.py``), ring attention
over ``sp`` (``ring_attention.py``) and the GPipe pipeline over ``pp``
(``pipeline.py``).  ``multihost`` (a process a card) is ROADMAP item [6b]."""
