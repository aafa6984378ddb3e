"""Deployment materializer for the port — the reference operator without
Kubernetes; the port's copy of ``seldon_core_tpu/operator/materializer.py``.

The reference's cluster-manager watches the SeldonDeployment CRD, rewrites
the resource (defaulting), validates it, and materializes k8s Deployments +
Services with an injected engine container; a second watcher feeds pod
availability back into the CR status (SURVEY.md §2.4, §3.1).

Here the same control loop materializes a deployment spec into this host's
runtime:

  * ``apply``   defaulting + validation, then per predictor: spawn unit
    microservice subprocesses (``python -m
    seldon_core_tpu_torch.runtime.microservice ... --device <device>``) for
    remote (rest/grpc) bindings with the reference env contract injected
    (PREDICTIVE_UNIT_SERVICE_PORT, PREDICTIVE_UNIT_PARAMETERS, ids —
    graph/defaulting.py), build the port's ``EngineService`` on the
    materializer's device (``cuda`` unless asked for the CPU), and register
    the deployment with the gateway's DeploymentStore.  A spawned unit
    that exits before its port accepts connections leaves the status
    ``Degraded`` and fails the ``apply``: nothing carries on elsewhere.
  * ``delete``  stop processes, unregister (the reference's ownerReference GC).
  * ``watch_dir``  poll a directory of ``*.json`` specs every interval;
    ADDED/MODIFIED (mtime dedup, like resourceVersion) -> apply, file gone ->
    delete (SeldonDeploymentWatcher.java:89-171's 5 s scheduled loop).
  * ``status``  per-predictor {replicas, replicasAvailable} where available =
    live engine + live unit subprocesses
    (SeldonDeploymentStatusUpdateImpl.java:49-104).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from seldon_core_tpu_torch.device import DeviceLike
from seldon_core_tpu_torch.gateway.apife import DeploymentStore
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.spec import GraphSpecError, SeldonDeploymentSpec

__all__ = ["Materializer", "MaterializedDeployment"]

#: seconds a spawned unit has to accept connections (a unit on the card
#: imports torch, builds its kernel and probes it first)
UNIT_START_TIMEOUT_S = 180.0


class _UnitDied(RuntimeError):
    """A spawned unit exited (or never served) during ``apply``."""


@dataclass
class _UnitProc:
    name: str
    popen: subprocess.Popen
    port: int
    binding: object = None
    predictor_id: str = ""
    deployment_id: str = ""
    restarts: int = 0
    last_restart: float = 0.0


@dataclass
class MaterializedDeployment:
    spec: SeldonDeploymentSpec
    engines: Dict[str, object] = field(default_factory=dict)  # predictor -> engine
    unit_procs: List[_UnitProc] = field(default_factory=list)
    applied_at: float = 0.0


class Materializer:
    def __init__(
        self,
        store: Optional[DeploymentStore] = None,
        spawn_units: bool = True,
        python: str = sys.executable,
        device: DeviceLike = None,
    ):
        self.store = store or DeploymentStore()
        self.spawn_units = spawn_units
        self.python = python
        #: the engines' and the spawned units' device: ``cuda`` unless the
        #: caller asks for the CPU
        self.device = device
        self.deployments: Dict[str, MaterializedDeployment] = {}

    # ------------------------------------------------------------------

    def apply(self, spec: SeldonDeploymentSpec) -> MaterializedDeployment:
        """Defaulting -> validation -> materialize -> register."""
        from seldon_core_tpu_torch.runtime.engine import EngineService

        default_and_validate(spec)
        existing = self.deployments.get(spec.name)
        if existing is not None:
            self._teardown(existing)

        md = MaterializedDeployment(spec=spec, applied_at=time.time())
        try:
            for predictor in spec.predictors:
                # 1. unit subprocesses for remote bindings (the reference's
                #    per-componentSpec Deployments)
                for binding in predictor.components:
                    if binding.runtime in ("rest", "grpc") and self.spawn_units:
                        md.unit_procs.append(
                            self._spawn_unit(binding, predictor.name, spec.name)
                        )
                # 2. the engine for this predictor (reference: injected
                #    engine container per predictor)
                md.engines[predictor.name] = EngineService(
                    spec, predictor.name, device=self.device)
            for proc in md.unit_procs:
                self._await_unit(proc)
        except _UnitDied:
            # the status reads Degraded until the unit is restarted
            # (``supervise``) or the deployment deleted
            self.deployments[spec.name] = md
            self.store.register(spec, md.engines)
            raise
        except Exception:
            self._teardown(md)
            for engine in md.engines.values():
                engine.close()
            raise
        self.deployments[spec.name] = md
        self.store.register(spec, md.engines)
        return md

    def delete(self, name: str) -> None:
        md = self.deployments.pop(name, None)
        if md is None:
            return
        self._teardown(md)
        self.store.unregister(md.spec.oauth_key or md.spec.name)
        for engine in md.engines.values():
            engine.close()

    def _teardown(self, md: MaterializedDeployment) -> None:
        for proc in md.unit_procs:
            if proc.popen.poll() is None:
                proc.popen.terminate()
                try:
                    proc.popen.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.popen.kill()
                    proc.popen.wait()
        md.unit_procs.clear()

    def _spawn_unit(self, binding, predictor_id: str, deployment_id: str) -> _UnitProc:
        """Launch the port's ``microservice`` with the reference env contract
        (SeldonDeploymentOperatorImpl.updateContainer:195-292) on the
        materializer's device."""
        if not binding.class_path:
            raise GraphSpecError(
                f"remote binding {binding.name!r} needs class_path to run "
                f"locally (no container images here)"
            )
        env = dict(os.environ)
        env.update(binding.env)
        env["PREDICTIVE_UNIT_SERVICE_PORT"] = str(binding.port)
        env["PREDICTIVE_UNIT_ID"] = binding.name
        env["PREDICTOR_ID"] = predictor_id
        env["SELDON_DEPLOYMENT_ID"] = deployment_id
        api = "GRPC" if binding.runtime == "grpc" else "REST"
        device = "cuda" if self.device is None else str(self.device)
        popen = subprocess.Popen(
            [
                self.python,
                "-m",
                "seldon_core_tpu_torch.runtime.microservice",
                binding.class_path,
                api,
                "--port",
                str(binding.port),
                "--device",
                device,
            ],
            env=env,
        )
        return _UnitProc(
            name=binding.name,
            popen=popen,
            port=binding.port,
            binding=binding,
            predictor_id=predictor_id,
            deployment_id=deployment_id,
        )

    def _await_unit(self, proc: _UnitProc, timeout_s: float = UNIT_START_TIMEOUT_S) -> None:
        """Wait until a spawned unit accepts connections on its port; raise
        when it exits first or does not come up in ``timeout_s``."""
        host = getattr(proc.binding, "host", "") or "127.0.0.1"
        if host in ("0.0.0.0", "localhost"):
            host = "127.0.0.1"
        deadline = time.monotonic() + timeout_s
        while True:
            code = proc.popen.poll()
            if code is not None:
                raise _UnitDied(f"unit {proc.name!r} exited with code {code} before "
                                f"it served on port {proc.port}")
            try:
                with socket.create_connection((host, proc.port), timeout=1.0):
                    return
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise _UnitDied(f"unit {proc.name!r} did not serve on port {proc.port} "
                                f"within {timeout_s:.0f} s")
            time.sleep(0.1)

    # ------------------------------------------------------------------

    def supervise(self) -> int:
        """Restart dead unit subprocesses with exponential backoff — the
        reference delegates this to the kubelet (k8s Deployment restart
        policy, SURVEY.md §2.7 elasticity row); a local materializer must
        supervise its own children.  Returns the number of restarts made."""
        restarted = 0
        now = time.time()
        for md in self.deployments.values():
            for proc in md.unit_procs:
                if proc.popen.poll() is None or proc.binding is None:
                    continue
                backoff = min(2.0 ** min(proc.restarts, 5), 30.0)
                if now - proc.last_restart < backoff:
                    continue
                fresh = self._spawn_unit(
                    proc.binding, proc.predictor_id, proc.deployment_id
                )
                proc.popen = fresh.popen
                proc.restarts += 1
                proc.last_restart = now
                restarted += 1
        return restarted

    # ------------------------------------------------------------------

    def status(self, name: str) -> dict:
        """Per-predictor availability — the reference CR status block
        (seldon_deployment.proto PredictorStatus)."""
        md = self.deployments.get(name)
        if md is None:
            return {"state": "absent"}
        predictors = []
        units_alive = all(p.popen.poll() is None for p in md.unit_procs)
        for predictor in md.spec.predictors:
            available = 1 if (predictor.name in md.engines and units_alive) else 0
            predictors.append(
                {
                    "name": predictor.name,
                    "replicas": predictor.replicas,
                    "replicasAvailable": available * predictor.replicas,
                }
            )
        return {
            "state": "Available" if units_alive else "Degraded",
            "predictorStatus": predictors,
            "unitRestarts": sum(p.restarts for p in md.unit_procs),
        }

    # ------------------------------------------------------------------

    async def watch_dir(self, path: str, interval_s: float = 5.0, once: bool = False):
        """Reference watch loop: 5 s schedule, mtime dedup (resourceVersion
        bookkeeping, SeldonDeploymentWatcher.java:89-171); a file removed
        from the directory deletes its deployment (ownerReference GC)."""
        seen_mtime: Dict[str, float] = {}
        file_to_name: Dict[str, str] = {}
        while True:
            self.supervise()  # restart any dead unit subprocess (backoff)
            files: Dict[str, float] = {}
            if os.path.isdir(path):
                for fn in sorted(os.listdir(path)):
                    if fn.endswith(".json"):
                        full = os.path.join(path, fn)
                        try:
                            files[full] = os.path.getmtime(full)
                        except OSError:
                            continue
            # ADDED / MODIFIED
            for full, mtime in files.items():
                if seen_mtime.get(full) == mtime:
                    continue
                seen_mtime[full] = mtime  # never retry an unchanged bad file
                try:
                    with open(full) as f:
                        spec = SeldonDeploymentSpec.from_json(f.read())
                    self.apply(spec)
                    file_to_name[full] = spec.name
                except _UnitDied as e:
                    file_to_name[full] = spec.name  # registered, Degraded
                    logging.getLogger(__name__).error("apply %s: %s", full, e)
                except (GraphSpecError, json.JSONDecodeError, OSError) as e:
                    logging.getLogger(__name__).error("apply %s failed: %s", full, e)
            # DELETED
            for full in [f for f in seen_mtime if f not in files]:
                del seen_mtime[full]
                name = file_to_name.pop(full, None)
                if name is not None:
                    self.delete(name)
                    try:
                        os.remove(full + ".status")
                    except OSError:
                        pass
            # status write-back: the reference patches the CR status
            # (SeldonDeploymentStatusUpdateImpl.java:49-104); a sibling
            # ``<spec>.json.status`` file is this materializer's CR
            for full, name in file_to_name.items():
                try:
                    with open(full + ".status", "w") as f:
                        json.dump(self.status(name), f)
                except OSError:
                    pass
            if once:
                return
            await asyncio.sleep(interval_s)

    def shutdown(self) -> None:
        for name in list(self.deployments):
            self.delete(name)


def main(argv=None) -> None:
    """``python -m seldon_core_tpu_torch.operator.materializer <spec-dir>`` —
    run the watch/supervise/status loop over a directory of deployment
    specs (the reference's cluster-manager as a local process)."""
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("spec_dir")
    parser.add_argument("--interval", type=float, default=5.0)
    parser.add_argument("--no-spawn", action="store_true",
                        help="do not launch unit subprocesses (engines only)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu: the engines' and units' device")
    args = parser.parse_args(argv)
    m = Materializer(spawn_units=not args.no_spawn, device=args.device)
    try:
        asyncio.run(m.watch_dir(args.spec_dir, interval_s=args.interval))
    except KeyboardInterrupt:
        pass
    finally:
        m.shutdown()


if __name__ == "__main__":
    main()
