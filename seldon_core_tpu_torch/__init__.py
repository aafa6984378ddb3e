"""seldon_core_tpu_torch — the PyTorch/CUDA port of seldon_core_tpu.

The same SeldonDeployment JSON, unit names and SeldonMessage REST contract
as the JAX package, with tensors in torch on an NVIDIA Hopper card.  The
JAX package (``seldon_core_tpu``) stays the reference; this package
imports nothing of it and nothing of JAX.

Layout (mirrors the JAX package so each counterpart is easy to find):
  device          ``resolve_device``: CUDA by default, CPU only on request
  messages        SeldonMessage / Meta / Status / DefaultData codecs
  protoconv       the same messages as protobuf bytes (a stdlib codec)
  convert         weights carried across from the JAX package's states
  native/         the protobuf tensor scan and HPACK of the gRPC lane
  graph/          spec, defaulting, units, interpreter helpers, the
                  eager compiled-graph executor
  models/         model families (MnistClassifier)
  ops/            hand-written Hopper kernels with their plain versions
  runtime/        micro-batcher, engine service, the REST lane, the binary
                  tensor wire, gRPC, the unix-socket relay, remote-node
                  clients, the unit microservice, the engine entry point
"""

__version__ = "0.1.0"

from seldon_core_tpu_torch.device import resolve_device  # noqa: F401
from seldon_core_tpu_torch.messages import (  # noqa: F401
    DefaultData,
    Meta,
    SeldonMessage,
    Status,
)
