"""Model families of the port.  Importing this package registers them in
``graph.units.UNIT_REGISTRY`` under the JAX package's names.

Ported: ``MnistClassifier``, ``MnistCNN``, ``TransformerLM``,
``TransformerGenerator`` (greedy and sampled decoding, the shared prefix),
``SpeculativeGenerator``, ``IrisClassifier``, the tabular families
(``MeanClassifier``, ``SigmoidPredictor``, ``MeanTransformer``,
``ObliviousTreeEnsemble``), ``MahalanobisOutlier`` and
``EpsilonGreedyRouter``.  Not yet: ``QuantizedMnistClassifier`` and the
int8 generator (ROADMAP Queue 1 item [2q]).
"""

from seldon_core_tpu_torch.models.generate import TransformerGenerator  # noqa: F401
from seldon_core_tpu_torch.models.iris import IrisClassifier  # noqa: F401
from seldon_core_tpu_torch.models.mab import EpsilonGreedyRouter  # noqa: F401
from seldon_core_tpu_torch.models.mnist import MnistClassifier, MnistCNN  # noqa: F401
from seldon_core_tpu_torch.models.outlier import MahalanobisOutlier  # noqa: F401
from seldon_core_tpu_torch.models.speculative import SpeculativeGenerator  # noqa: F401
from seldon_core_tpu_torch.models.tabular import (  # noqa: F401
    MeanClassifier,
    MeanTransformer,
    ObliviousTreeEnsemble,
    SigmoidPredictor,
)
from seldon_core_tpu_torch.models.transformer import TransformerLM  # noqa: F401
