"""Model families of the port.  Importing this package registers them in
``graph.units.UNIT_REGISTRY`` under the JAX package's names.

Ported: ``MnistClassifier``, ``QuantizedMnistClassifier``, ``MnistCNN``,
``TransformerLM``, ``TransformerGenerator`` (greedy and sampled decoding,
the shared prefix, int8 weights and the int8 K/V cache),
``SpeculativeGenerator``, ``IrisClassifier``, the tabular families
(``MeanClassifier``, ``SigmoidPredictor``, ``MeanTransformer``,
``ObliviousTreeEnsemble``), ``MahalanobisOutlier``,
``EpsilonGreedyRouter`` and ``SharedEnsembleUnit``
(``parallel/ensemble.py``).  The training functions beside them: the LM's
``lm_train_step`` (one device or a ``dp x tp x sp`` mesh) and
``lm_pipeline_train_step`` (``pp``), MNIST's ``train_step`` (one device or
``dp``).
"""

from seldon_core_tpu_torch.models.generate import TransformerGenerator  # noqa: F401
from seldon_core_tpu_torch.models.iris import IrisClassifier  # noqa: F401
from seldon_core_tpu_torch.models.mab import EpsilonGreedyRouter  # noqa: F401
from seldon_core_tpu_torch.models.mnist import (  # noqa: F401
    MnistClassifier,
    MnistCNN,
    QuantizedMnistClassifier,
)
from seldon_core_tpu_torch.models.outlier import MahalanobisOutlier  # noqa: F401
from seldon_core_tpu_torch.models.speculative import SpeculativeGenerator  # noqa: F401
from seldon_core_tpu_torch.models.tabular import (  # noqa: F401
    MeanClassifier,
    MeanTransformer,
    ObliviousTreeEnsemble,
    SigmoidPredictor,
)
from seldon_core_tpu_torch.models.transformer import TransformerLM  # noqa: F401
from seldon_core_tpu_torch.parallel.ensemble import SharedEnsembleUnit  # noqa: F401
