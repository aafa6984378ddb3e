#!/usr/bin/env python3
"""Run named phases of ``chip_smoke.py`` alone, from one or more trees, in
turns, and print each phase's wall.

    python3 smoke_turns.py [--batch-walls] PHASE[,PHASE ...] TREE [TREE ...]

PHASE is the name of a phase function of ``chip_smoke.py`` that takes
``(torch, dev, smi)`` (``serving_modes_phases``, ``observability_phase``,
``policies_phase``, ``gateway_phase``, ...).  Each TREE is a checkout of
the repo (``.`` for this one; an earlier commit unpacked with ``git
archive`` into a directory under ``build/``).  Each runs in a process of
its own, in the order given (parent, change, change, parent for a
comparison), after building every kernel of ``KERNEL_SOURCES`` from that
tree's sources, with the environment ``chip_smoke.main`` sets before its
phases.  ``--batch-walls`` also records the wall of every batch-tier
request (``Seldon-Tier: batch``, as 10q's brownout part sends) by wrapping
the tree's ``chip_smoke.request_headers``, so trees whose smoke does not
print it are timed alike.  One ``TURN`` line a tree gives each phase's
wall in seconds, the batch-tier walls (host, seconds, HTTP status) when
asked, and the card with its power limit, after the phases' own output;
then a final JSON object.  The PHASE ``whole`` runs ``python3
chip_smoke.py`` itself from each tree instead (its own build, its own
exit code), and its ``TURN`` line gives the run's wall.  It needs one
NVIDIA card and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def one(phases: str, root: str, batch_walls: bool) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import _build

    os.environ["SELDON_TPU_GEN_CONTINUOUS"] = "0"
    os.environ["ENGINE_HTTP_IMPL"] = "fast"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(cs.KERNEL_SOURCES)
    smi = cs.nvidia_smi_line()
    batch = []
    if batch_walls:
        orig = cs.request_headers

        def timed(method, url, body, headers, *a, **k):
            t = time.perf_counter()
            out = orig(method, url, body, headers, *a, **k)
            if headers.get("Seldon-Tier") == "batch":
                batch.append((url.split("/")[2], round(time.perf_counter() - t, 3), out[0]))
            return out

        cs.request_headers = timed
    walls, rc = {}, 0
    for name in phases.split(","):
        t0 = time.perf_counter()
        try:
            getattr(cs, name)(torch, torch.device("cuda"), smi)
        except Exception as e:  # noqa: BLE001 - the turn's line says what failed
            rc = 1
            print(f"FAILED {name} {e!r}"[:2000], flush=True)
            break
        walls[name] = round(time.perf_counter() - t0, 2)
    tail = f" batch-tier walls {batch}" if batch_walls else ""
    print(f"TURN {root} rc {rc} walls {json.dumps(walls)}{tail} ({smi})", flush=True)
    os._exit(rc)  # phases leave server threads that are not joined


def whole(root: str) -> None:
    """``python3 chip_smoke.py`` run from ``root`` on its own: its
    output, then a ``TURN`` line with its exit code and wall."""
    root = os.path.abspath(root)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root, capture_output=True,
                       text=True, timeout=1500)
    wall = time.perf_counter() - t0
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    except OSError as e:
        smi = f"no nvidia-smi: {e}"
    sys.stdout.write(p.stdout)
    sys.stdout.write(p.stderr[-4000:])
    print(f"TURN {root} rc {p.returncode} walls {json.dumps({'whole': round(wall, 2)})} "
          f"({smi})", flush=True)
    os._exit(p.returncode)


def main(argv) -> int:
    flags = [a for a in argv if a == "--batch-walls"]
    argv = [a for a in argv if a != "--batch-walls"]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    phases, trees = argv[0], argv[1:]
    turns = []
    for tree in trees:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", *flags, phases,
                            tree], capture_output=True, text=True, timeout=1800)
        sys.stderr.write(p.stderr[-4000:])
        print(p.stdout, end="", flush=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith(("TURN", "FAILED"))]
        turns.append({"tree": tree, "rc": p.returncode, "lines": lines})
    print(json.dumps({"turns": turns}))
    return 0 if all(t["rc"] == 0 for t in turns) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        rest = sys.argv[2:]
        if rest[-2] == "whole":
            whole(rest[-1])
        one(rest[-2], rest[-1], "--batch-walls" in rest)
    sys.exit(main(sys.argv[1:]))
