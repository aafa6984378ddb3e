"""Ingress gateway: auth, deployment routing, canary traffic split,
request/response firehose."""

from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore  # noqa: F401
from seldon_core_tpu_torch.gateway.firehose import Firehose  # noqa: F401
