#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 10q (``policies_phase``: the autopilot,
the sheds, the brownout ladder) alone, from one or more trees, in turns.

    python3 policies_turns.py TREE [TREE ...]

Each TREE is a checkout of the repo (``.`` for this one; an earlier
commit unpacked with ``git archive`` into a directory under ``build/``).
Each is run in a process of its own, in the order given (parent, change,
change, parent for a comparison), after building the kernels 10q launches
from that tree's sources.  Every batch-tier request's wall is recorded by
wrapping the tree's ``chip_smoke.request_headers``, so trees whose smoke
does not print it are timed alike.  One ``TURN`` line a tree gives the
phase's wall, the batch-tier walls (host, seconds, HTTP status) and the
card with its power limit; then a final JSON object.  It imports nothing
of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def one(root: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import _build

    # as chip_smoke.main sets them before its phases
    os.environ["SELDON_TPU_GEN_CONTINUOUS"] = "0"
    os.environ["ENGINE_HTTP_IMPL"] = "fast"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(("fused_mlp", "flash_decode", "flash_decode_paged", "kv_write"))
    smi = cs.nvidia_smi_line()
    walls = []
    orig = cs.request_headers

    def timed(method, url, body, headers, *a, **k):
        t = time.perf_counter()
        out = orig(method, url, body, headers, *a, **k)
        if headers.get("Seldon-Tier") == "batch":
            walls.append((url.split("/")[2], round(time.perf_counter() - t, 3), out[0]))
        return out

    cs.request_headers = timed
    t0 = time.perf_counter()
    rc = 0
    try:
        cs.policies_phase(torch, torch.device("cuda"), smi)
    except Exception as e:  # noqa: BLE001 - the turn's line says what failed
        rc = 1
        print(f"FAILED {e!r}"[:2000], flush=True)
    print(f"TURN {root} rc {rc} phase {time.perf_counter() - t0:.2f} s batch-tier walls "
          f"{walls} ({smi})", flush=True)
    os._exit(rc)  # the phase's server threads are not joined


def main(trees) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    turns = []
    for tree in trees:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                           capture_output=True, text=True, timeout=600)
        sys.stderr.write(p.stderr[-4000:])
        line = [ln for ln in p.stdout.splitlines() if ln.startswith(("TURN", "FAILED"))]
        print("\n".join(line), flush=True)
        turns.append({"tree": tree, "rc": p.returncode, "lines": line})
    print(json.dumps({"turns": turns}))
    return 0 if all(t["rc"] == 0 for t in turns) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
    sys.exit(main(sys.argv[1:]))
