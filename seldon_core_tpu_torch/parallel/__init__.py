"""Parallel layers of the port: device meshes held by one process
(``mesh.py``), the sharded ensemble (``ensemble.py``) and the
mixture-of-experts layer with its expert-parallel layout (``moe.py``).
Ring attention, the pipeline and ``multihost`` are ROADMAP item [6b]."""
