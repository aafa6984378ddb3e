"""Request/response firehose — the port's copy of
``seldon_core_tpu/gateway/firehose.py``: the same JSONL lines in the same
file layout, so the JAX consumer and ``runtime/replay.py`` read a port
gateway's firehose unchanged.  The Kafka publish path of the reference
gateway (api-frontend kafka/KafkaRequestResponseProducer.java:30-62: topic =
deployment id, key = puid, fire-and-forget with MAX_BLOCK_MS=20 so logging
can never stall serving).

Here the sink is pluggable: an append-only JSONL file per deployment by
default (one line per RequestResponse, key fields first so consumers can
stream-grep), or any callable sink.  Writes happen on a background task fed
by a bounded queue; when the queue is full events are DROPPED, never
blocking the serving path — the same trade the reference makes."""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Callable, Optional

from seldon_core_tpu_torch.messages import SeldonMessage

__all__ = ["Firehose"]


def _default_base_dir() -> str:
    return os.environ.get(
        "SELDON_TPU_FIREHOSE_DIR", os.path.expanduser("~/.seldon_tpu_firehose")
    )


class Firehose:
    def __init__(
        self,
        base_dir: Optional[str] = None,
        sink: Optional[Callable[[str, dict], None]] = None,
        max_queue: int = 4096,
    ):
        self.base_dir = base_dir or _default_base_dir()
        self.sink = sink
        self.dropped = 0
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=max_queue)
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._drain())

    async def stop(self) -> None:
        if self._task is not None:
            await self._queue.join()
            self._task.cancel()
            self._task = None

    def snapshot(self) -> dict:
        """Backpressure picture for ``/stats`` — queue depth vs bound and
        the lifetime drop count."""
        return {
            "queued": self._queue.qsize(),
            "max_queue": self._queue.maxsize,
            "dropped": self.dropped,
        }

    def publish(
        self, deployment: str, request: SeldonMessage,
        response: SeldonMessage, tenant: Optional[str] = None,
        tier: Optional[str] = None,
    ) -> None:
        """Fire-and-forget; drops when the queue is full (never blocks).
        ``tenant``/``tier`` (runtime/qos.py) land as top-level fields so
        a grep over the JSONL attributes traffic per tenant; absent for
        pre-tenancy producers — consumers must tolerate both."""
        event = {
            "puid": response.meta.puid or request.meta.puid,
            "deployment": deployment,
            "ts": time.time(),
            "request": request.to_json_dict(),
            "response": response.to_json_dict(),
        }
        if tenant is not None:
            event["tenant"] = tenant
        if tier is not None:
            event["tier"] = tier
        try:
            self._queue.put_nowait(event)
        except asyncio.QueueFull:
            self.dropped += 1

    def publish_event(self, deployment: str, kind: str, **fields) -> None:
        """Control-plane event on the same firehose (fire-and-forget,
        same drop-when-full trade): rollout stage shifts and rollbacks
        (operator/rollouts.py) land next to the request stream they
        acted on, so one grep over the JSONL reconstructs WHY traffic
        moved.  ``kind`` becomes the line's ``event`` field; request/
        response stay absent so stream consumers keyed on them skip
        these lines cleanly."""
        event = {
            "puid": "",
            "deployment": deployment,
            "ts": time.time(),
            "event": kind,
            **fields,
        }
        try:
            self._queue.put_nowait(event)
        except asyncio.QueueFull:
            self.dropped += 1

    async def _drain(self) -> None:
        while True:
            event = await self._queue.get()
            try:
                if self.sink is not None:
                    self.sink(event["deployment"], event)
                else:
                    os.makedirs(self.base_dir, exist_ok=True)
                    path = os.path.join(self.base_dir, f"{event['deployment']}.jsonl")
                    with open(path, "a") as f:
                        f.write(json.dumps(event, separators=(",", ":")) + "\n")
            except Exception:
                self.dropped += 1
            finally:
                self._queue.task_done()


def main(argv=None) -> None:
    """Consumer CLI — the reference's Kafka reader example
    (kafka/tests/src/read_predictions.py:22-30): stream a deployment's
    request/response log, one summarised line per event.

        python -m seldon_core_tpu_torch.gateway.firehose <deployment> [--follow]
    """
    import argparse
    import sys
    import time as _time

    parser = argparse.ArgumentParser(description="firehose consumer")
    parser.add_argument("deployment", help="deployment id (topic)")
    parser.add_argument("--dir", default=None, help="firehose base dir")
    parser.add_argument("--follow", action="store_true", help="tail -f mode")
    parser.add_argument("--raw", action="store_true", help="print full JSONL")
    args = parser.parse_args(argv)
    base = args.dir or _default_base_dir()
    path = os.path.join(base, f"{args.deployment}.jsonl")
    if not os.path.exists(path) and not args.follow:
        raise SystemExit(f"no firehose log at {path}")

    def emit(line: str) -> None:
        line = line.strip()
        if not line:
            return
        if args.raw:
            sys.stdout.write(line + "\n")
            return
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            return
        status = ((ev.get("response") or {}).get("status") or {})
        sys.stdout.write(
            f"{ev.get('ts', 0):.3f} puid={ev.get('puid', '')} "
            f"status={status.get('status', 'SUCCESS')}\n"
        )

    pos = 0
    while True:
        if os.path.exists(path):
            if os.path.getsize(path) < pos:
                pos = 0  # truncated/rotated: restart from the top
            with open(path) as f:
                f.seek(pos)
                while True:
                    line_start = f.tell()
                    line = f.readline()
                    if not line:
                        break
                    if not line.endswith("\n"):
                        # producer mid-write: hold the fragment back and
                        # re-read the whole line once it is terminated
                        pos = line_start
                        break
                    emit(line)
                    pos = f.tell()
        if not args.follow:
            break
        _time.sleep(1.0)
        sys.stdout.flush()


if __name__ == "__main__":
    main()
