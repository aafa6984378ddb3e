"""The port's MnistClassifier and weight converter against the JAX unit."""

import json

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.mnist import MnistClassifier as JaxMnist
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph.compiled import build_units
from seldon_core_tpu_torch.graph.defaulting import default_and_validate
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.graph.units import resolve_unit_class
from seldon_core_tpu_torch.models.mnist import MnistClassifier, mlp_init


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_state():
    """The JAX unit's own weights at a narrow width, as numpy."""
    state = JaxMnist(hidden=32, use_pallas="never").init_state(jax.random.key(0))
    return {k: np.asarray(v) for k, v in state.items()}


def test_params_from_jax_is_bit_exact(jax_state):
    assert jax_state["w0"].dtype.name == "bfloat16"
    params = params_from_jax(jax_state, device="cpu")
    for k, arr in jax_state.items():
        assert params[k].dtype == torch.bfloat16
        assert tuple(params[k].shape) == arr.shape
        np.testing.assert_array_equal(params[k].view(torch.int16).numpy(), arr.view(np.int16))
    f32 = params_from_jax({"w": np.arange(6, dtype=np.float32).reshape(2, 3)}, device="cpu")
    np.testing.assert_array_equal(f32["w"].numpy(), np.arange(6, dtype=np.float32).reshape(2, 3))


@pytest.mark.parametrize("mode,atol", [
    # kernel twins (the port's plain kernel version vs JAX's XLA path on the
    # CPU for "auto"; vs the Pallas interpreter for "interpret"): bf16
    # tolerance of tests/test_ops_pallas.py:56
    ("auto", 2e-2),
    ("interpret", 2e-2),
    # torch.matmul vs XLA, both rounding matmul outputs to bf16
    ("never", 2e-2),
])
def test_unit_modes_match_jax_unit(jax_state, mode, atol):
    port = MnistClassifier(hidden=32, use_pallas=mode, device="cpu")
    ref = JaxMnist(hidden=32, use_pallas=mode)
    x = np.random.default_rng(2).random((6, 784)).astype(np.float32)
    got = port.predict(params_from_jax(jax_state, device="cpu"), torch.from_numpy(x)).numpy()
    want = np.asarray(ref.predict({k: jax.numpy.asarray(v) for k, v in jax_state.items()},
                                  jax.numpy.asarray(x)))
    assert got.shape == (6, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_kernel_twin_matches_pallas_interpreter_closely(jax_state):
    """The port's plain kernel version and the Pallas kernel interpret the
    same bf16 casts: far tighter than the bf16 tolerance."""
    port = MnistClassifier(hidden=32, use_pallas="interpret", device="cpu")
    ref = JaxMnist(hidden=32, use_pallas="interpret")
    x = np.random.default_rng(5).random((6, 784)).astype(np.float32)
    got = port.predict(params_from_jax(jax_state, device="cpu"), torch.from_numpy(x)).numpy()
    want = np.asarray(ref.predict({k: jax.numpy.asarray(v) for k, v in jax_state.items()},
                                  jax.numpy.asarray(x)))
    # only f32 sum order differs; it may flip a bf16 rounding (2^-8 rel.)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_unit_paths_are_chosen_at_construction():
    assert MnistClassifier(hidden=32, device="cpu").path == "kernel"
    assert MnistClassifier(hidden=32, use_pallas="interpret", device="cpu").path == "reference"
    assert MnistClassifier(hidden=32, use_pallas="never", device="cpu").path == "mlp_apply"
    with pytest.raises(ValueError, match="use_pallas"):
        MnistClassifier(use_pallas="sometimes", device="cpu")


@pytest.mark.parametrize("dtype,probe_fails,want", [
    ("bfloat16", False, "kernel"),     # kernel taken: built and launched once
    ("float32", False, "mlp_apply"),   # kernel refused: no build, no probe
    ("bfloat16", True, RuntimeError),  # a failing build raises at construction
])
def test_unit_probes_the_kernel_at_construction_on_cuda(monkeypatch, dtype, probe_fails, want):
    """The CUDA branch of the constructor, with the card and the library
    stood in for: the unit decides and probes once, never per request."""
    from seldon_core_tpu_torch.models import mnist
    from seldon_core_tpu_torch.ops import fused_mlp

    probed = []

    def probe(dims, device):
        probed.append((list(dims), device.type))
        if probe_fails:
            raise RuntimeError("nvcc failed to build fused_mlp.cu")

    def shape_error(dims, dtypes):
        # the dtype rule of the real check; the widths are the library's
        if any(dt != torch.bfloat16 for dt in dtypes):
            return fused_mlp.kernel_shape_error(dims, dtypes)
        return None

    monkeypatch.setattr(mnist, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(mnist, "kernel_shape_error", shape_error)
    monkeypatch.setattr(mnist, "probe_kernel", probe)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            MnistClassifier(hidden=32, dtype=dtype)
    else:
        assert MnistClassifier(hidden=32, dtype=dtype).path == want
    assert probed == ([] if dtype == "float32" else [([784, 32, 32, 10], "cuda")])


def test_unit_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MnistClassifier(hidden=32)


def test_unit_rejects_wrong_feature_width():
    unit = MnistClassifier(hidden=32, device="cpu")
    state = unit.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="in_dim"):
        unit.predict(state, torch.zeros(2, 100))


def test_mlp_init_is_seeded_and_he_scaled():
    a = mlp_init(torch.Generator().manual_seed(7), hidden=64, depth=2, device="cpu")
    b = mlp_init(torch.Generator().manual_seed(7), hidden=64, depth=2, device="cpu")
    assert sorted(a) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    assert [tuple(a[f"w{i}"].shape) for i in range(3)] == [(784, 64), (64, 64), (64, 10)]
    for k in a:
        assert a[k].dtype == torch.bfloat16 and torch.equal(a[k], b[k])
    # He init: std sqrt(2 / fan_in)
    assert abs(float(a["w0"].float().std()) - (2 / 784) ** 0.5) < 0.005


def test_example_deployment_resolves_port_unit():
    with open("examples/mnist_deployment.json") as f:
        spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(json.load(f)))
    assert resolve_unit_class("MnistClassifier") is MnistClassifier
    units = build_units(spec.predictor(), device=torch.device("cpu"))
    unit = units["mnist"]
    assert isinstance(unit, MnistClassifier)
    assert (unit.hidden, unit.depth, unit.dtype) == (256, 2, torch.bfloat16)
    assert unit.path == "kernel"
