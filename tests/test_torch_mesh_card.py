"""The multi-device generator on the card, in a file that imports no JAX
(so the card's machine can run it as it is): ``generator_tp`` through the
engine when four cards exist, else the engine's refusal ("needs 4
devices, have N") and the unit over four shards of ``cuda:0``; its f32
greedy tokens equal the unsharded unit's with the same weights."""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.models.generate import TransformerGenerator
from seldon_core_tpu_torch.parallel import mesh as pmesh
from seldon_core_tpu_torch.runtime.engine import EngineService

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.cuda
def test_generator_tp_on_the_card_matches_one_device():
    """On the card: generator_tp through the engine when four cards exist
    (else the engine refuses with "needs 4 devices, have N" and the unit
    runs over four shards of cuda:0); its f32 greedy tokens equal the
    unsharded unit's with the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    text = (ROOT / "examples" / "generator_tp_deployment.json").read_text()
    spec = SeldonDeploymentSpec.from_json(text)
    kw = {p.name: p.value for p in spec.predictors[0].components[0].parameters}
    kw = dict(vocab=int(kw["vocab"]), d_model=int(kw["d_model"]), n_heads=int(kw["n_heads"]),
              n_layers=int(kw["n_layers"]), d_ff=int(kw["d_ff"]),
              max_new_tokens=int(kw["max_new_tokens"]), dtype=kw["dtype"], device="cuda")
    one = TransformerGenerator(**kw)
    state = one.init_state(torch.Generator().manual_seed(0))
    X = torch.randint(0, 256, (2, 9), device="cuda").float()
    want = one.predict(state, X)
    if torch.cuda.device_count() >= 4:
        engine = EngineService(spec, device="cuda")
        try:
            unit = engine.compiled.units["gen"]
            assert [str(d) for d in unit.mesh.device_list] == [f"cuda:{i}" for i in range(4)]
            engine.load_states({"gen": unit.shard_state(state)})
            got, status = asyncio.run(engine.predict_json(json.dumps(
                {"data": {"ndarray": X.cpu().tolist()}})))
            assert status == 200
            assert np.array_equal(np.asarray(json.loads(got)["data"]["ndarray"]),
                                  want.cpu().numpy())
        finally:
            engine.close()
    else:
        with pytest.raises(ValueError, match=f"needs 4 devices, have {torch.cuda.device_count()}"):
            EngineService(spec, device="cuda")
        tp = TransformerGenerator(**kw, mesh=pmesh.build_mesh({"tp": 4}, devices=["cuda:0"] * 4))
        assert torch.equal(tp.predict(tp.shard_state(state), X), want)
