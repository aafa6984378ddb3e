"""Contract-based request generation — per-model schema fuzzing; the port's
copy of ``seldon_core_tpu/testing/contract.py`` (the same numpy draws, so a
seed gives the reference's arrays).

The reference drives every example model from a ``contract.json`` describing
feature distributions, then fires randomly generated batches at the service
(wrappers/testing/tester.py:42-66, util/api_tester/api-tester.py:24-120).
Same contract schema here::

    {"features": [{"name": "x", "dtype": "FLOAT", "ftype": "continuous",
                   "range": [0, 1], "repeat": 784}],
     "targets":  [{"name": "class", "dtype": "FLOAT", "ftype": "continuous",
                   "range": [0, 1], "repeat": 10}]}

Feature kinds: ``continuous`` (uniform in range; "inf" bounds -> normal /
lognormal tails like the reference) and ``categorical`` (uniform over
``values``).  ``repeat`` expands one definition into k columns; ``shape``
generates an [n, *shape] block.  ``validate_response`` checks a response
against the ``targets`` section — shape, dtype, and range.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from seldon_core_tpu_torch.messages import SeldonMessage

__all__ = ["Contract", "ContractError", "generate_batch", "validate_response"]


class ContractError(ValueError):
    pass


def _gen_continuous(rng, lo, hi, shape) -> np.ndarray:
    if lo == "inf" and hi == "inf":
        return rng.normal(size=shape)
    if lo == "inf":
        return float(hi) - rng.lognormal(size=shape)
    if hi == "inf":
        return float(lo) + rng.lognormal(size=shape)
    return rng.uniform(float(lo), float(hi), size=shape)


@dataclass
class Contract:
    features: List[dict]
    targets: List[dict] = field(default_factory=list)

    @staticmethod
    def from_json(s) -> "Contract":
        try:
            d = json.loads(s) if isinstance(s, (str, bytes)) else dict(s)
        except json.JSONDecodeError as e:
            raise ContractError(f"invalid contract JSON: {e}") from e
        if "features" not in d:
            raise ContractError("contract needs a 'features' section")
        return Contract(
            features=list(d["features"]), targets=list(d.get("targets", []))
        )

    @staticmethod
    def from_file(path: str) -> "Contract":
        with open(path) as f:
            return Contract.from_json(f.read())


def _columns_for(defs: List[dict], n: int, rng) -> Tuple[np.ndarray, List[str]]:
    blocks, names = [], []
    for fd in defs:
        if "name" not in fd:
            raise ContractError("feature definition missing 'name'")
        ftype = fd.get("ftype", "continuous")
        repeat = int(fd.get("repeat", 1))
        if ftype == "continuous":
            if "shape" in fd:
                shape = [n] + [int(s) for s in fd["shape"]]
            else:
                shape = [n, repeat]
            lo, hi = fd.get("range", ["inf", "inf"])
            block = np.around(_gen_continuous(rng, lo, hi, shape), decimals=3)
            if fd.get("dtype") == "INT":
                block = np.floor(block + 0.5)
            block = block.reshape(n, -1)
        elif ftype == "categorical":
            values = fd.get("values")
            if not values:
                raise ContractError(f"categorical feature {fd['name']!r} needs 'values'")
            idx = rng.integers(0, len(values), size=(n, repeat))
            block = np.asarray(values, dtype=object)[idx]
        else:
            raise ContractError(f"unknown ftype {ftype!r}")
        blocks.append(block)
        cols = block.shape[1]
        names.extend(
            [fd["name"]] if cols == 1 else [f"{fd['name']}:{i}" for i in range(cols)]
        )
    return np.concatenate(blocks, axis=1), names


def generate_batch(
    contract: Contract, n: int, seed: Optional[int] = None
) -> SeldonMessage:
    """Random request batch drawn from the contract's feature distributions
    (tester.py generate_batch)."""
    rng = np.random.default_rng(seed)
    data, names = _columns_for(contract.features, n, rng)
    try:
        arr = data.astype(np.float64)
        kind = "tensor"
    except (ValueError, TypeError):
        arr = data  # mixed categorical: ndarray wire form
        kind = "ndarray"
    return SeldonMessage.from_array(arr, names=names, kind=kind)


def validate_response(contract: Contract, resp: SeldonMessage) -> List[str]:
    """Check a response against the contract's targets; returns a list of
    violations (empty == conforming)."""
    problems: List[str] = []
    if resp.status is not None and resp.status.status == "FAILURE":
        return [f"FAILURE status: {resp.status.info}"]
    if not contract.targets:
        return problems
    try:
        arr = np.asarray(resp.array(), dtype=np.float64)
    except Exception as e:
        return [f"response has no numeric payload: {e}"]
    want_cols = sum(
        int(np.prod(td["shape"])) if "shape" in td else int(td.get("repeat", 1))
        for td in contract.targets
    )
    got_cols = int(np.prod(arr.shape[1:])) if arr.ndim > 1 else arr.shape[0]
    if got_cols != want_cols:
        problems.append(f"target width {got_cols} != contract {want_cols}")
    col = 0
    flat = arr.reshape(arr.shape[0], -1) if arr.ndim > 1 else arr.reshape(1, -1)
    for td in contract.targets:
        width = int(np.prod(td["shape"])) if "shape" in td else int(td.get("repeat", 1))
        block = flat[:, col : col + width]
        col += width
        rng_spec = td.get("range")
        if rng_spec and block.size:
            lo, hi = rng_spec
            if lo != "inf" and block.min() < float(lo) - 1e-9:
                problems.append(
                    f"target {td.get('name')!r} below range: {block.min()} < {lo}"
                )
            if hi != "inf" and block.max() > float(hi) + 1e-9:
                problems.append(
                    f"target {td.get('name')!r} above range: {block.max()} > {hi}"
                )
    return problems
