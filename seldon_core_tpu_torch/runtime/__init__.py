"""Serving runtime: micro-batcher, engine service, the REST lane (JSON and
the binary tensor wire), gRPC, the unix-socket relay, remote-node clients,
the unit microservice and the engine entry point."""
