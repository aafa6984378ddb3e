"""Model families of the port.  Importing this package registers them in
``graph.units.UNIT_REGISTRY`` under the JAX package's names.

Ported so far: ``MnistClassifier``.
"""

from seldon_core_tpu_torch.models.mnist import MnistClassifier  # noqa: F401
