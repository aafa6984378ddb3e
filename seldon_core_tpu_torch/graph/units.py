"""Predictive-unit protocol and the built-in units — the port's counterpart
of ``seldon_core_tpu/graph/units.py``.

A unit is a bundle of functions over an explicit state (a dict of tensors,
or None) and a batch of tensors with a leading batch axis:

    init_state(rng: torch.Generator) -> state (None if stateless)
    predict(state, X)                -> Y            | (Y, UnitAux)
    transform_input(state, X)        -> X'           | (X', UnitAux)
    transform_output(state, Y)       -> Y'           | (Y', UnitAux)
    route(state, X)                  -> branch int   | (branch, UnitAux)
    aggregate(state, Ys)             -> Y            | (Y, UnitAux)  # Ys stacked [n_children, ...]
    send_feedback(state, X, branch, reward, truth) -> state

The executors hold every unit's state and thread updates through
``UnitAux``, as the JAX package does, so the same unit classes fit a later
graph capture.  Built-ins ported so far:

  * SimpleModelUnit     — fixed [0.1, 0.9, 0.5] / class0..2 stub
    (engine SimpleModelUnit.java:29-44)
  * SimpleRouterUnit    — always child 0 (engine SimpleRouterUnit.java:24-31)
  * RandomABTestUnit    — a seeded uniform <= ratioA picks child 0, else 1
    (engine RandomABTestUnit.java:35-58); its state is the port's own key
    (``models/prng.py``), never ``jax.random``'s
  * AverageCombinerUnit — element-wise mean over child outputs
    (engine AverageCombinerUnit.java:30-95)
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Type

import torch

from seldon_core_tpu_torch.graph.spec import GraphSpecError, UnitImplementation

__all__ = [
    "UnitAux",
    "Unit",
    "normalize_output",
    "register_unit",
    "resolve_unit_class",
    "instantiate_bound_unit",
    "speaks_unit_protocol",
    "host_only_reason",
    "UNIT_REGISTRY",
    "SimpleModelUnit",
    "SimpleRouterUnit",
    "RandomABTestUnit",
    "AverageCombinerUnit",
]


class UnitAux(NamedTuple):
    """Optional second return value of any unit method."""

    state: Any = None  # replacement state, or None = unchanged
    tags: Optional[Dict[str, Any]] = None  # data-dependent meta tags


def normalize_output(out, old_state):
    """Normalize ``Y`` or ``(Y, UnitAux)`` to ``(Y, state, tags)``."""
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], UnitAux):
        y, aux = out
        state = aux.state if aux.state is not None else old_state
        return y, state, (aux.tags or {})
    return out, old_state, {}


class Unit:
    """Base class for in-process units.  Subclasses override the methods for
    their unit type; unimplemented methods raise."""

    #: True if every method is a pure function of (state, inputs); the
    #: compiled executor refuses impure units
    pure: bool = True
    #: True when predict returns a state update that depends on the rows
    #: seen (a request counter, streaming statistics): the engine gives such
    #: a unit no batcher, runs one dispatch at a time and writes the state
    #: back after each
    updates_state_on_predict: bool = False
    #: True when a row's output depends on the other rows of its batch (one
    #: sampling key for the batch, a batch-global reduction): the engine
    #: never coalesces concurrent requests through such a unit
    batch_coupled: bool = False
    #: optional output feature names (the wrappers' class_names)
    class_names: Optional[list] = None
    #: static meta tags merged into every response this unit touches
    static_tags: Optional[dict] = None

    def dispatch_cost(self, state, rows: int) -> Optional[dict]:
        """The analytic cost of one call on ``rows`` rows in the perf
        observatory's feature keys (``flops``, ``bytes_accessed``,
        ``output_bytes``), or None when the unit gives no count (its
        executables are latency-only rows on ``/perf``)."""
        return None

    def init_state(self, rng: Optional[torch.Generator]) -> Any:
        return None

    def predict(self, state, X):
        raise NotImplementedError(f"{type(self).__name__} does not implement predict")

    def transform_input(self, state, X):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement transform_input"
        )

    def transform_output(self, state, Y):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement transform_output"
        )

    def route(self, state, X):
        raise NotImplementedError(f"{type(self).__name__} does not implement route")

    def aggregate(self, state, Ys):
        raise NotImplementedError(f"{type(self).__name__} does not implement aggregate")

    def send_feedback(self, state, X, branch, reward, truth):
        return state


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

UNIT_REGISTRY: Dict[str, Type[Unit]] = {}


def register_unit(name: str) -> Callable[[Type[Unit]], Type[Unit]]:
    def deco(cls: Type[Unit]) -> Type[Unit]:
        UNIT_REGISTRY[name] = cls
        return cls

    return deco


def resolve_unit_class(class_path: str) -> type:
    """Resolve ``registered-name`` or ``module:Class`` to a class.  The
    port's model families register when ``seldon_core_tpu_torch.models``
    is imported, so a bare name like "MnistClassifier" resolves."""
    if class_path not in UNIT_REGISTRY:
        importlib.import_module("seldon_core_tpu_torch.models")
    if class_path in UNIT_REGISTRY:
        return UNIT_REGISTRY[class_path]
    if ":" in class_path:
        mod_name, _, cls_name = class_path.partition(":")
        try:
            mod = importlib.import_module(mod_name)
        except ImportError as e:
            raise ValueError(f"cannot import unit module {mod_name!r}: {e}") from e
        try:
            return getattr(mod, cls_name)
        except AttributeError as e:
            raise ValueError(f"module {mod_name!r} has no class {cls_name!r}") from e
    raise ValueError(
        f"unknown unit {class_path!r}: not registered and not a module:Class path"
    )


def speaks_unit_protocol(obj) -> bool:
    """True for a Unit class or instance, or any class or object declaring
    the protocol's ``pure`` marker; False for a plain user object, which
    serves behind the microservice's ``as_unit`` adapter."""
    return hasattr(obj, "pure")


def host_only_reason(node, binding) -> Optional[str]:
    """Why ``node`` (bound by ``binding``, or None) cannot run as an
    in-process pure unit, so that only the host interpreter serves it
    (None: it can), read from class-level facts: no unit is built here.
    The compiled executor and the fusion planner both ask it."""
    if node.implementation is not UnitImplementation.UNKNOWN_IMPLEMENTATION:
        cls = UNIT_REGISTRY.get(node.implementation.value)
        if cls is None:
            return f"no registered unit for {node.implementation.value}"
    else:
        if binding is None:
            return "no implementation, binding, or runtime"
        if binding.runtime != "inprocess":
            return f"remote {binding.runtime} binding"
        try:
            cls = resolve_unit_class(binding.class_path)
        except ValueError as e:
            return f"unresolvable unit class: {e}"
    if not speaks_unit_protocol(cls):
        # a plain user object: bound through the as_unit adapter, host-mode only
        return f"user-object class {getattr(cls, '__name__', cls)!r} serves host-mode only"
    if not getattr(cls, "pure", False):
        return f"impure unit {getattr(cls, '__name__', cls)}"
    return None


def instantiate_bound_unit(binding, node, device: Optional[torch.device] = None) -> Unit:
    """Build the in-process Unit of a component binding.  A unit class whose
    constructor takes ``device`` gets the engine's device, so it can choose
    its kernel path at construction from static shapes.  A binding's
    ``mesh_axes`` (``{"tp": 4}``, ``{"ens": 8}``) builds a device mesh on
    the engine's platform (``parallel/mesh.py``) and hands it to a unit
    whose constructor takes ``mesh``; any other unit is refused, in the
    reference's words.  A reference-style
    plain user object (``predict(X, feature_names)``, a torch or sklearn
    model) gets the microservice's ``as_unit`` adapter, whose ``pure =
    False`` keeps it out of the compiled and fused executors: the engine
    serves it through the host interpreter, like a remote wrapper node."""
    try:
        cls = resolve_unit_class(binding.class_path)
    except ValueError as e:
        raise GraphSpecError(f"component {binding.name!r}: {e}") from e
    mesh = None
    if binding.mesh_axes:
        import inspect

        axes = dict(binding.mesh_axes)
        if "mesh" not in inspect.signature(cls.__init__).parameters:
            raise GraphSpecError(
                f"component {binding.name!r} declares mesh_axes "
                f"{axes} but unit {cls.__name__} takes no "
                f"mesh; drop mesh_axes or use a mesh-capable unit"
            )
        from seldon_core_tpu_torch.parallel.mesh import build_mesh

        # over the engine's platform: cuda:0..n-1, or the CPU's device count;
        # too few devices raise "needs N devices, have M", never a smaller mesh
        mesh = build_mesh(axes, platform="cpu" if device is not None
                          and torch.device(device).type == "cpu" else "cuda")
    from seldon_core_tpu_torch.graph.interpreter import effective_type
    from seldon_core_tpu_torch.runtime.microservice import build_unit

    # the implementation-implied type, as the interpreter's dispatch reads it
    etype = effective_type(node)
    return build_unit(cls, binding.parameters or node.parameters,
                      etype.name if etype is not None else "MODEL", device, mesh)


# ---------------------------------------------------------------------------
# Built-in (hardcoded) units
# ---------------------------------------------------------------------------


@register_unit("SIMPLE_MODEL")
class SimpleModelUnit(Unit):
    """Test stub: the fixed row [0.1, 0.9, 0.5] per batch element
    (engine SimpleModelUnit.java:33-44)."""

    values = (0.1, 0.9, 0.5)
    class_names = ["class0", "class1", "class2"]

    def predict(self, state, X):
        batch = X.shape[0] if X.ndim >= 1 else 1
        row = torch.tensor(self.values, dtype=torch.float32, device=X.device)
        return row.expand(batch, -1).clone()


@register_unit("SIMPLE_ROUTER")
class SimpleRouterUnit(Unit):
    """Always routes to child 0 (engine SimpleRouterUnit.java:24-31)."""

    def route(self, state, X):
        return 0


@register_unit("RANDOM_ABTEST")
class RandomABTestUnit(Unit):
    """Seeded random A/B split: a uniform draw <= ratioA routes to child 0,
    else to child 1 (engine RandomABTestUnit.java:35-58).  The state is the
    key, split once a request, so a fixed seed gives a fixed sequence of
    branches, like the reference's ``Random(1337)``."""

    def __init__(self, ratioA: float = 0.5, seed: int = 1337):
        self.ratioA = float(ratioA)
        self.seed = int(seed)

    def init_state(self, rng):
        from seldon_core_tpu_torch.models import prng  # the models package imports this module

        return prng.key(self.seed if rng is None else rng.initial_seed())

    def _draw(self, key):
        """(the next key, a uniform draw in [0, 1)) from ``key``."""
        from seldon_core_tpu_torch.models import prng

        key, sub = prng.split(key)
        return key, prng.uniform(sub, 1)[0]

    def route(self, state, X):
        key, u = self._draw(state)
        return (u > self.ratioA).long(), UnitAux(state=key)


@register_unit("AVERAGE_COMBINER")
class AverageCombinerUnit(Unit):
    """Element-wise mean over child outputs stacked on a leading children
    axis (engine AverageCombinerUnit.java:30-95), computed as XLA computes
    ``jnp.mean``: the sum, child by child in order, times 1/n in the
    outputs' dtype.  So the answer has the JAX package's bits, and a row's
    bits never depend on the other rows of its batch."""

    def aggregate(self, state, Ys):
        y = Ys[0]
        for child in Ys[1:]:
            y = y + child
        return y * (1.0 / Ys.shape[0])
