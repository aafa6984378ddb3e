"""Model families of the port.  Importing this package registers them in
``graph.units.UNIT_REGISTRY`` under the JAX package's names.

Ported so far: ``MnistClassifier``, ``TransformerLM`` and
``TransformerGenerator`` (greedy, static per-request generation).
"""

from seldon_core_tpu_torch.models.generate import TransformerGenerator  # noqa: F401
from seldon_core_tpu_torch.models.mnist import MnistClassifier  # noqa: F401
from seldon_core_tpu_torch.models.transformer import TransformerLM  # noqa: F401
