#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 10w (one process a card) alone, beside the
one-process mesh it replaces, on the card(s) of this machine.

    python3 multihost_turns.py

It builds the port's kernels, times the flagship generator's 4x128 static
request (``chip_smoke.MESH_NEW`` new tokens) over 10u's one-process
``{"tp": 4}`` mesh (four cards when the machine has four, else four
shards of ``cuda:0``) and on one device, in turns (a warm call each, then
two turns of two walls a side, ABBA), frees them, and runs
``chip_smoke.multihost_phase`` with that wall: its
workers (four processes over NCCL on four cards, else two sharing
``cuda:0`` over gloo) hold every path to the one-process meshes and time
the same request across processes.  It prints the card, the phase's
lines and a final JSON object.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("multihost_turns: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from seldon_core_tpu_torch.models import generate as gm
    from seldon_core_tpu_torch.ops import _build
    from seldon_core_tpu_torch.parallel.mesh import build_mesh

    os.environ["SELDON_TPU_GEN_CONTINUOUS"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    cs.log(smi)
    cs.log(f"[turns] torch {torch.__version__} cuda {torch.version.cuda}, "
           f"{torch.cuda.device_count()} card(s)")
    t = time.perf_counter()
    _build.build_all(cs.KERNEL_SOURCES)
    cs.log(f"[build] {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    one, state, prompts = cs.mh_flagship_inputs(torch, dev)
    mesh = build_mesh({"tp": cs.MH_SHARDS}, devices=cs.mesh_devices(torch))
    tp = gm.TransformerGenerator(**{**cs.GEN_DIMS, "max_new_tokens": cs.MESH_NEW},
                                 dtype="bfloat16", mesh=mesh)
    sstate = tp.shard_state(state)
    X = torch.as_tensor(prompts, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        walls = cs.turns_p50(torch, {"tp4": lambda: tp.predict(sstate, X),
                                     "one": lambda: one.predict(state, X)}, turns=2)
    del tp, sstate, one, state
    torch.cuda.empty_cache()
    cs.log(f"[turns] the 4x128 request over the one-process tp=4 mesh on "
           f"{[str(d) for d in mesh.device_list]}: wall p50 {walls['tp4']:.3f} ms against "
           f"{walls['one']:.3f} ms on one device, in turns ({time.perf_counter() - t:.2f} s) "
           f"on {smi}")
    out = cs.multihost_phase(torch, dev, smi, walls)
    cs.log(json.dumps({"one_process_mesh": walls, "multihost": out, "card": smi}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
