"""Prometheus metrics — the port's counterpart of
``seldon_core_tpu/utils/metrics.py``, with the reference's metric families so existing
Grafana dashboards keep working (engine application.properties:24-27,
SeldonRestTemplateExchangeTagsProvider.java:84-161, monitoring/grafana/
configs/predictions-analytics-dashboard.json):

  * seldon_api_engine_server_requests_duration_seconds   (histogram)
  * seldon_api_engine_client_requests_duration_seconds   (per-node histogram)
  * seldon_api_ingress_server_requests_duration_seconds  (gateway histogram)
  * seldon_api_model_feedback_total / seldon_api_model_feedback_reward_total

All tagged with deployment_name / predictor_name / model_name / model_image /
model_version / project_name where applicable.

Beyond the reference families, ``exposition()`` merges in the process-level
``seldon_tpu_*`` serving families owned by the flight recorder
(utils/telemetry.py) — batch occupancy, queue wait, inflight dispatches,
TTFT, decode rate, speculative acceptance, kernel-build cache and KV-cache
state — so every existing ``/prometheus`` scrape target picks them up with
zero config.  The families are written by ``utils/promtext.py``, not by
``prometheus_client``: the port depends on torch and the standard library
alone.  ``family_names()`` enumerates everything exported; the
dashboard-honesty test (tests/test_monitoring_configs.py) checks
monitoring/ configs against it."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import FrozenSet

from seldon_core_tpu_torch.utils.promtext import (
    CONTENT_TYPE_LATEST,
    OPENMETRICS_CONTENT_TYPE,
    CollectorRegistry,
    Counter,
    Histogram,
    generate_latest,
    generate_latest_openmetrics,
)
from seldon_core_tpu_torch.utils.quality import QUALITY
from seldon_core_tpu_torch.utils.telemetry import RECORDER, TPU_METRIC_FAMILIES

HAVE_PROMETHEUS = True
# OPENMETRICS_CONTENT_TYPE is the format that carries the trace_id
# exemplars on seldon_tpu_dispatch_seconds buckets (served by /prometheus
# under Accept negotiation or ?format=openmetrics)

__all__ = [
    "MetricsRegistry",
    "CONTENT_TYPE_LATEST",
    "OPENMETRICS_CONTENT_TYPE",
]

_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0,
)

#: reference-parity families owned by MetricsRegistry itself
_OWN_FAMILIES = (
    "seldon_api_engine_server_requests_duration_seconds",
    "seldon_api_engine_client_requests_duration_seconds",
    "seldon_api_ingress_server_requests_duration_seconds",
    "seldon_api_model_feedback_total",
    "seldon_api_model_feedback_reward_total",
)


class MetricsRegistry:
    """Per-process metric registry."""

    def __init__(self, deployment_name: str = "", predictor_name: str = "",
                 project_name: str = ""):
        self.deployment_name = deployment_name
        self.predictor_name = predictor_name
        self.project_name = project_name
        self._server_children: dict = {}
        if not HAVE_PROMETHEUS:
            self.registry = None
            return
        self.registry = CollectorRegistry()
        common = ["deployment_name", "predictor_name", "project_name"]
        self.server_requests = Histogram(
            "seldon_api_engine_server_requests_duration_seconds",
            "Engine request latency",
            common + ["service", "method", "code"],
            registry=self.registry,
            buckets=_BUCKETS,
        )
        self.client_requests = Histogram(
            "seldon_api_engine_client_requests_duration_seconds",
            "Per-node dispatch latency",
            common + ["model_name", "model_image", "model_version", "method"],
            registry=self.registry,
            buckets=_BUCKETS,
        )
        self.ingress_requests = Histogram(
            "seldon_api_ingress_server_requests_duration_seconds",
            "Gateway request latency",
            common + ["service", "method", "code"],
            registry=self.registry,
            buckets=_BUCKETS,
        )
        self.feedback_total = Counter(
            "seldon_api_model_feedback_total",
            "Feedback events",
            common,
            registry=self.registry,
        )
        self.feedback_reward_total = Counter(
            "seldon_api_model_feedback_reward_total",
            "Accumulated feedback reward",
            common,
            registry=self.registry,
        )

    def _common(self):
        return {
            "deployment_name": self.deployment_name,
            "predictor_name": self.predictor_name,
            "project_name": self.project_name,
        }

    def _server_child(self, service: str, method: str, code: str):
        """Memoized labeled child — ``labels(**kwargs)`` costs ~10us per call,
        which matters at 10k+ req/s; the label set per engine is tiny."""
        key = (service, method, code)
        child = self._server_children.get(key)
        if child is None:
            child = self.server_requests.labels(
                **self._common(), service=service, method=method, code=code
            )
            self._server_children[key] = child
        return child

    @contextmanager
    def time_server(self, service: str, method: str):
        start = time.perf_counter()
        code_holder = {"code": "200"}
        try:
            yield code_holder
        except Exception:
            code_holder["code"] = "500"
            raise
        finally:
            dt = time.perf_counter() - start
            # /stats percentile reservoirs run even without prometheus_client
            RECORDER.request_latency(f"server:{service}", dt)
            if service == "predictions":
                # the SLO engine (utils/quality.py): burn rates ride the
                # request stream this histogram observes; a 5xx burns the
                # error budget, anything over SELDON_TPU_SLO_P99_MS the
                # latency budget.  A policy refusal (code["shed"]) is flow
                # control, not a failure
                QUALITY.record_request(
                    dt, error=(code_holder["code"].startswith("5")
                               and not code_holder.get("shed")))
            if self.registry is not None:
                self._server_child(service, method, code_holder["code"]).observe(dt)

    def merge_server_counts(self, service: str, method: str, code: str, bucket_counts,
                            sum_s: float) -> None:
        """Add observations counted elsewhere (the native data plane's C++
        lanes) to the server histogram's child: ``bucket_counts`` per
        bucket (not cumulative, +Inf last) and their sum in seconds."""
        if self.registry is not None:
            self._server_child(service, method, code).add_counts(bucket_counts, sum_s)

    @contextmanager
    def time_client(self, model_name: str, method: str, model_image: str = "",
                    model_version: str = ""):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.registry is not None:
                self.client_requests.labels(
                    **self._common(), model_name=model_name,
                    model_image=model_image, model_version=model_version,
                    method=method,
                ).observe(time.perf_counter() - start)

    @contextmanager
    def time_ingress(self, service: str, method: str):
        start = time.perf_counter()
        code_holder = {"code": "200"}
        try:
            yield code_holder
        except Exception:
            code_holder["code"] = "500"
            raise
        finally:
            dt = time.perf_counter() - start
            RECORDER.request_latency(f"ingress:{service}", dt)
            if self.registry is not None:
                self.ingress_requests.labels(
                    **self._common(), service=service, method=method,
                    code=code_holder["code"],
                ).observe(dt)

    def record_feedback(self, reward: float) -> None:
        if self.registry is not None:
            self.feedback_total.labels(**self._common()).inc()
            self.feedback_reward_total.labels(**self._common()).inc(max(reward, 0.0))

    @classmethod
    def family_names(cls) -> FrozenSet[str]:
        """Every Prometheus family base name this process exports through
        ``exposition()`` — reference-parity families plus the flight
        recorder's ``seldon_tpu_*`` set."""
        return frozenset(_OWN_FAMILIES) | frozenset(TPU_METRIC_FAMILIES)

    def exposition(self, openmetrics: bool = False) -> bytes:
        """Own (deployment-labelled) families + the process-level
        ``seldon_tpu_*`` families — one scrape target per serving process
        carries both layers.  ``openmetrics=True`` renders the OpenMetrics
        format (exemplar-carrying); the two registries' outputs merge with
        a single trailing ``# EOF`` terminator."""
        if self.registry is None:
            return RECORDER.exposition(openmetrics=openmetrics)
        if openmetrics:
            own = generate_latest_openmetrics(self.registry, eof=False)
            return own + RECORDER.exposition(openmetrics=True)
        return generate_latest(self.registry) + RECORDER.exposition()
