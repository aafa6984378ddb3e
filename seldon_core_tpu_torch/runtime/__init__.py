"""Serving runtime: micro-batcher, engine service, asyncio REST lane and the
engine entry point."""
