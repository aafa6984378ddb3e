"""The port's other model families against the JAX units on the same numpy
inputs, with the JAX units' fitted or drawn state carried across:
MeanClassifier, SigmoidPredictor, MeanTransformer, ObliviousTreeEnsemble,
IrisClassifier, MahalanobisOutlier, MnistCNN, EpsilonGreedyRouter and the
built-in SIMPLE_ROUTER / RANDOM_ABTEST, at small sizes on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph import units as jax_units
from seldon_core_tpu.models import iris as jiris
from seldon_core_tpu.models import mab as jmab
from seldon_core_tpu.models import mnist as jmnist
from seldon_core_tpu.models import outlier as joutlier
from seldon_core_tpu.models import tabular as jtab
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.graph import units as tunits
from seldon_core_tpu_torch.graph.units import UNIT_REGISTRY, normalize_output, resolve_unit_class
from seldon_core_tpu_torch.models import iris as tiris
from seldon_core_tpu_torch.models import mab as tmab
from seldon_core_tpu_torch.models import mnist as tmnist
from seldon_core_tpu_torch.models import outlier as toutlier
from seldon_core_tpu_torch.models import prng
from seldon_core_tpu_torch.models import tabular as ttab

# f32 units: the same f32 arithmetic in other summation orders
RTOL, ATOL = 1e-5, 1e-6
# outlierScore: eigh and solve of two LAPACK builds; the scores are
# invariant to the eigenvectors' signs but not to their last bits
SCORE_RTOL = 1e-3
# bf16 MnistCNN probabilities: the reference's own bar (tests/test_models.py:184)
CNN_ATOL = 1e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(jstate):
    return params_from_jax(_np(jstate), device="cpu")


def _rows(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def test_every_family_registers_under_the_reference_name():
    names = ["MeanClassifier", "SigmoidPredictor", "MeanTransformer", "ObliviousTreeEnsemble",
             "IrisClassifier", "MahalanobisOutlier", "MnistCNN", "EpsilonGreedyRouter",
             "SIMPLE_ROUTER", "RANDOM_ABTEST"]
    for name in names:
        assert resolve_unit_class(name) is UNIT_REGISTRY[name]
        assert resolve_unit_class(name).__module__.startswith("seldon_core_tpu_torch.")


@pytest.mark.parametrize("threshold,int_value", [(0.0, 0), (0.5, 0), (0.25, 1)])
def test_mean_classifier_matches(threshold, int_value):
    ref = jtab.MeanClassifier(threshold=threshold, intValue=int_value)
    port = ttab.MeanClassifier(threshold=threshold, intValue=int_value)
    jstate = ref.init_state(None)
    np.testing.assert_array_equal(port.init_state(None)["threshold"].numpy(),
                                  np.asarray(jstate["threshold"]))
    x = _rows(1, (7, 5))
    np.testing.assert_allclose(port.predict(_port(jstate), torch.from_numpy(x)).numpy(),
                               np.asarray(ref.predict(jstate, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def test_sigmoid_predictor_fits_and_matches_with_the_reference_state():
    kw = dict(n_features=6, hidden=8, train_samples=256, train_steps=60, seed=3)
    ref, port = jtab.SigmoidPredictor(**kw), ttab.SigmoidPredictor(**kw)
    jstate = ref.init_state(jax.random.key(0))
    x = _rows(2, (9, 6))
    np.testing.assert_allclose(port.predict(_port(jstate), torch.from_numpy(x)).numpy(),
                               np.asarray(ref.predict(jstate, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    # at the defaults its own fit, from its own generator, learns the task
    # as well as the reference's does from its key
    ref, port = jtab.SigmoidPredictor(), ttab.SigmoidPredictor()
    own = port.init_state(torch.Generator().manual_seed(0))
    X = torch.randn(4096, 10, generator=torch.Generator().manual_seed(9))
    y = (torch.sigmoid(X[:, 0] * X[:, 1]) >= 0.5).long()
    acc = float((port.predict(own, X).argmax(1) == y).float().mean())
    jout = ref.predict(ref.init_state(jax.random.key(0)), jnp.asarray(X.numpy()))
    jacc = float(np.mean(np.argmax(np.asarray(jout), 1) == y.numpy()))
    assert acc > 0.85 and abs(acc - jacc) < 0.05, (acc, jacc)


@pytest.mark.parametrize("x", [
    _rows(3, (4, 6), 5.0),
    np.full((3, 4), 2.5, np.float32),   # constant batch: zeros
    _rows(4, (1, 9)),
])
def test_mean_transformer_matches(x):
    ref, port = jtab.MeanTransformer(), ttab.MeanTransformer()
    assert port.batch_coupled
    np.testing.assert_allclose(port.transform_input(None, torch.from_numpy(x)).numpy(),
                               np.asarray(ref.transform_input(None, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(n_features=5, n_trees=4, depth=2, train_samples=200),
                                dict(n_features=8, n_trees=6, depth=3, train_samples=300,
                                     seed=2)])
def test_oblivious_trees_fit_bit_identical_and_predict(kw):
    ref, port = jtab.ObliviousTreeEnsemble(**kw), ttab.ObliviousTreeEnsemble(**kw)
    jstate, tstate = _np(ref.init_state(None)), port.init_state(None)
    assert tstate["feat"].dtype == torch.int32
    for k in ("feat", "thresh", "leaves", "base"):
        np.testing.assert_array_equal(tstate[k].numpy(), jstate[k])  # bit-identical fit
    x = _rows(5, (11, kw["n_features"]))
    got = port.predict(tstate, torch.from_numpy(x)).numpy()
    want = np.asarray(ref.predict(ref.init_state(None), jnp.asarray(x)))
    assert got.shape == want.shape == (11, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_iris_data_is_scikit_learns_and_the_fit_matches():
    from sklearn.datasets import load_iris as sk_load

    X, y, names = tiris.load_iris()
    sk = sk_load()
    np.testing.assert_array_equal(X, np.asarray(sk.data, np.float32))
    np.testing.assert_array_equal(y, np.asarray(sk.target, np.int32))
    assert names == [str(n) for n in sk.target_names]
    ref, port = jiris.IrisClassifier(), tiris.IrisClassifier()
    assert port.class_names == ref.class_names
    np.testing.assert_array_equal(port._mu, ref._mu)
    np.testing.assert_array_equal(port._sigma, ref._sigma)
    # the port's own fit, from its own generator, fits as well as the reference's
    assert port._train_accuracy > 0.9 and abs(port._train_accuracy - ref._train_accuracy) < 0.05
    jstate = ref.init_state(None)
    x = np.concatenate([X[::17], _rows(6, (3, 4)) + 5.0])
    np.testing.assert_allclose(port.predict(_port(jstate), torch.from_numpy(x)).numpy(),
                               np.asarray(ref.predict(jstate, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p,k,max_n,batches", [
    (8, 3, -1, [1, 5, 5, 7]),     # a 1-row first call, then batches of k + 2 and more
    (6, 2, 10, [4, 6, 9]),        # max_n caps the running count's weight
    (12, 3, -1, [12, 5]),
])
def test_outlier_scores_and_state_match(p, k, max_n, batches):
    ref, port = joutlier.MahalanobisOutlier(p, k, max_n), toutlier.MahalanobisOutlier(p, k, max_n)
    assert port.updates_state_on_predict
    jstate, tstate = ref.init_state(None), port.init_state(None)
    for i, nb in enumerate(batches):
        x = _rows(10 + i, (nb, p)) + np.arange(p, dtype=np.float32)
        jy, jaux = ref.transform_input(jstate, jnp.asarray(x))
        ty, tstate, ttags = normalize_output(port.transform_input(tstate, torch.from_numpy(x)),
                                             tstate)
        jstate = jaux.state
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))  # data passes through
        want = np.asarray(jaux.tags["outlierScore"])
        got = ttags["outlierScore"].numpy()
        assert got.shape == (nb,)
        if nb == 1 and i == 0:
            np.testing.assert_array_equal(got, want)  # zero covariance: both score 0
        else:
            np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=1e-5)
        for key in ("mean", "C", "n"):
            np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]),
                                       rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("channels,B", [(4, 3), (8, 1)])
def test_mnist_cnn_matches_with_the_reference_weights(channels, B):
    ref = jmnist.MnistCNN(channels=channels)
    port = tmnist.MnistCNN(channels=channels, device="cpu")
    jstate = ref.init_state(jax.random.key(1))
    tstate = _port(jstate)
    assert tstate["c1"].shape == (3, 3, 1, channels) and tstate["c1"].dtype == torch.bfloat16
    x = np.random.default_rng(7).random((B, 784)).astype(np.float32)
    got = port.predict(tstate, torch.from_numpy(x))
    want = np.asarray(ref.predict(jstate, jnp.asarray(x)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=CNN_ATOL)
    # NHWC input is the same function
    nhwc = port.predict(tstate, torch.from_numpy(x.reshape(B, 28, 28, 1)))
    assert torch.equal(nhwc, got)
    own = port.init_state(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in
                                                           _np(jstate).items()}


def _jax_eg_draws(key, n, count):
    """The reference route's draws for ``count`` requests from ``key``:
    (explore uniform, index among the other branches) each, and the key
    after them."""
    draws = []
    for _ in range(count):
        key, k_explore, k_choice = jax.random.split(key, 3)
        draws.append((float(jax.random.uniform(k_explore)),
                      int(jax.random.randint(k_choice, (), 0, max(n - 1, 1), jnp.int32))))
    return draws


def _inject(unit, draws):
    it = iter(draws)

    def fake(key):
        u, other = next(it)
        return key, torch.tensor(u, dtype=torch.float32), torch.tensor(other)

    unit._draws = fake


@pytest.mark.parametrize("n,epsilon", [(2, 0.1), (3, 0.5), (4, 1.0)])
def test_epsilon_greedy_routes_and_learns_as_the_reference(n, epsilon):
    """Several rounds of route then feedback, with the reference's own draws
    injected: the same branches and the same success / tries."""
    ref = jmab.EpsilonGreedyRouter(n_branches=n, epsilon=epsilon, seed=5)
    port = tmab.EpsilonGreedyRouter(n_branches=n, epsilon=epsilon, seed=5)
    jstate = ref.init_state(None)
    tstate = port.init_state(None)
    assert tstate["key"].shape == (2,)
    _inject(port, _jax_eg_draws(jstate["key"], n, 12))
    rewards = np.random.default_rng(n).random(12)
    for i in range(12):
        x = _rows(20 + i, (1 + i % 3, 4))
        jb, jaux = ref.route(jstate, jnp.asarray(x))
        tb, tstate, _ = normalize_output(port.route(tstate, torch.from_numpy(x)), tstate)
        jstate = jaux.state
        assert int(tb) == int(jb)
        jstate = ref.send_feedback(jstate, jnp.asarray(x), int(jb), float(rewards[i]), None)
        tstate = port.send_feedback(tstate, torch.from_numpy(x), int(tb), float(rewards[i]),
                                    None)
        for key in ("success", "tries"):
            np.testing.assert_array_equal(tstate[key].numpy(), np.asarray(jstate[key]))
    # a feedback with no recorded branch, or out of range, moves nothing
    for branch in (-1, n):
        same = port.send_feedback(tstate, None, branch, 1.0, None)
        assert torch.equal(same["success"], tstate["success"])


def test_epsilon_greedy_own_draws_explore_at_epsilon():
    port = tmab.EpsilonGreedyRouter(n_branches=3, epsilon=0.25, seed=1)
    state = port.init_state(None)
    state["success"] = torch.tensor([0.0, 9.0, 0.0])
    state["tries"] = torch.tensor([9.0, 9.0, 9.0])  # branch 1 is best
    picks = []
    for _ in range(2000):
        b, state, _ = normalize_output(port.route(state, torch.zeros(1, 2)), state)
        picks.append(int(b))
    counts = np.bincount(picks, minlength=3) / len(picks)
    # exploit 0.75; explore 0.25 split evenly over the two others, never the best
    assert abs(counts[1] - 0.75) < 0.04 and abs(counts[0] - counts[2]) < 0.05


def test_simple_router_and_random_abtest():
    assert tunits.SimpleRouterUnit().route(None, torch.zeros(2, 3)) == 0
    ref = jax_units.RandomABTestUnit(ratioA=0.3)
    port = tunits.RandomABTestUnit(ratioA=0.3)
    jkey, tkey = ref.init_state(None), port.init_state(None)
    assert torch.equal(tkey, prng.key(1337))
    # the reference's draws injected: the same branches
    us = []
    for _ in range(20):
        jb, jaux = ref.route(jkey, jnp.zeros((1, 2)))
        us.append(float(jax.random.uniform(jax.random.split(jkey)[1])))
        jkey = jaux.state
        it = iter([us[-1]])
        port._draw = lambda key: (key, torch.tensor(next(it), dtype=torch.float32))
        tb, _, _ = normalize_output(port.route(tkey, torch.zeros(1, 2)), tkey)
        assert int(tb) == int(jb)
    # its own draws split at ratioA
    del port._draw
    branches = []
    for _ in range(2000):
        b, tkey, _ = normalize_output(port.route(tkey, torch.zeros(1, 2)), tkey)
        branches.append(int(b))
    assert abs(1 - np.mean(branches) - 0.3) < 0.04


def test_uniform_draws_are_in_range_and_independent_of_the_batch():
    keys = prng.fold_in(prng.key(3), torch.arange(64))
    u = prng.uniform(keys, 50)
    assert u.dtype == torch.float32 and bool((u >= 0).all()) and bool((u < 1).all())
    assert torch.equal(prng.uniform(keys[5:6], 50)[0], u[5])
    assert abs(float(u.mean()) - 0.5) < 0.02
