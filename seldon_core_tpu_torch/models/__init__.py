"""Model families of the port.  Importing this package registers them in
``graph.units.UNIT_REGISTRY`` under the JAX package's names.

Ported so far: ``MnistClassifier``, ``TransformerLM``,
``TransformerGenerator`` (greedy and sampled decoding, the shared prefix)
and ``SpeculativeGenerator``.
"""

from seldon_core_tpu_torch.models.generate import TransformerGenerator  # noqa: F401
from seldon_core_tpu_torch.models.mnist import MnistClassifier  # noqa: F401
from seldon_core_tpu_torch.models.speculative import SpeculativeGenerator  # noqa: F401
from seldon_core_tpu_torch.models.transformer import TransformerLM  # noqa: F401
