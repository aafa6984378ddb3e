"""Parallel layers of the port.  Only the mixture-of-experts layer's
single-device half is here (``moe.py``); meshes, sharding, expert and
pipeline parallelism and ring attention are ROADMAP item [6]."""
