"""Observability: the flight recorder, metrics, the causal tracer, the perf
observatory, the telemetry spine and the generation-lane recorder."""
