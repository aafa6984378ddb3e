"""The sharded train steps against the JAX package on 8 CPU devices: the
LM's ``lm_train_step`` over ``dp x tp x sp`` (``transformer.py:412-462``
with a mesh) and MNIST's ``train_step`` (``mnist.py:83-92``) on one
device and over ``dp``, with the same weights (``convert.params_from_jax``)
and the same batches (numpy, from a seed), in f32.

The port runs the forward over the mesh and takes the backward once, over
the run's one autograd graph (``optim.grad_update``); a replicated leaf's
gradient is the sum over its copies, so every copy stays bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from seldon_core_tpu.models import mnist as jmnist
from seldon_core_tpu.models import transformer as jtr
from seldon_core_tpu.parallel import mesh as jmesh
from seldon_core_tpu_torch.convert import params_from_jax
from seldon_core_tpu_torch.models import mnist as tmnist
from seldon_core_tpu_torch.models import transformer as ttr
from seldon_core_tpu_torch.optim import adam
from seldon_core_tpu_torch.parallel import mesh as pmesh
from seldon_core_tpu_torch.tree import leaves_with_paths


@pytest.fixture(autouse=True)
def _eight_cpu_devices(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(pmesh, "_CPU_DEVICES", pmesh._CPU_DEVICES)
    pmesh.set_cpu_device_count(8)
    yield
    torch.set_num_threads(prev)


DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
AXES = {"dp": 2, "tp": 2, "sp": 2}


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _setup(seed, dims=DIMS):
    jcfg = jtr.LMConfig(**dims, dtype=jnp.float32)
    tcfg = ttr.LMConfig(**dims, dtype=torch.float32)
    jp = jtr.lm_init(jax.random.key(seed), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _gather(sharded: pmesh.ShardedTree):
    """The whole tree from its blocks: each split leaf concatenated along
    its split dims in coordinate order, a replicated leaf from shard 0."""
    mesh = sharded.mesh

    def whole(path_specs, leaves):
        spec = path_specs
        t = leaves[0]
        for dim, axis in enumerate(spec):
            if axis is None or mesh.shape.get(axis, 1) == 1:
                continue
            parts = {}
            for i, leaf in enumerate(leaves):
                parts.setdefault(mesh.coords(i)[axis], leaf)
            t = torch.cat([parts[c] for c in sorted(parts)], dim=dim)
        return t

    def walk(spec, trees):
        if isinstance(trees[0], dict):
            return {k: walk(spec[k], [t[k] for t in trees]) for k in trees[0]}
        return whole(spec, trees)

    return walk(sharded.specs, sharded.shards)


def _copies_identical(sharded: pmesh.ShardedTree):
    """Every shard that holds a block of a leaf holds the same bits as the
    other shards holding that block."""
    mesh = sharded.mesh
    specs = dict(leaves_with_paths(sharded.specs))
    leaves = [dict(leaves_with_paths(s)) for s in sharded.shards]
    for path, spec in specs.items():
        seen = {}
        for i, shard in enumerate(leaves):
            key = tuple(mesh.coords(i)[a] for a in spec if a is not None)
            if key in seen:
                assert torch.equal(seen[key], shard[path]), (path, i)
            else:
                seen[key] = shard[path]


def test_sharded_loss_and_grads_equal_one_device(devices8):
    """The loss over {"dp": 2, "tp": 2, "sp": 2} and every leaf's gradient
    (the copies summed) equal the one-device loss and gradients of the
    port within f32 rounding (1e-5 relative, 1e-6 absolute): the backward
    reaches every shard through the collectives' copy edges."""
    from seldon_core_tpu_torch.optim import grad_update

    _, tcfg, _, tp = _setup(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, size=(4, 17)))
    mesh = pmesh.build_mesh(AXES, platform="cpu")
    seen = {}

    class Capture:
        def update(self, grads, state, params=None):
            seen["g"] = grads
            return grads, state

    batch = {"tokens": tokens}
    _, _, loss1 = grad_update(lambda p, b: ttr.lm_loss(p, b, tcfg), tp, None, batch, Capture())
    g1 = seen["g"]
    sp = ttr.shard_params(tp, mesh)
    _, _, loss8 = grad_update(lambda p, b: ttr.lm_loss(p, b, tcfg), sp,
                              pmesh.ShardedTree(mesh, [None] * 8), batch, Capture())
    np.testing.assert_allclose(float(loss8), float(loss1), rtol=1e-6)
    g8 = seen["g"]
    _copies_identical(g8)
    whole = dict(leaves_with_paths(_gather(g8)))
    for key, g in leaves_with_paths(g1):
        np.testing.assert_allclose(whole[key].numpy(), g.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "ring_kernel_path"])
def test_sharded_train_steps_match_reference(use_flash, devices8):
    """Three ``lm_train_step``s over {"dp": 2, "tp": 2, "sp": 2} against the
    reference's sharded step (``tests/test_parallel.py:137``, jitted over
    the same mesh): the loss at rtol 1e-5, every leaf after the steps by
    the rule of ``tests/test_torch_train.py`` (Adam turns a gradient near
    zero into a step of about lr whose sign f32 rounding can flip: within
    2 lr a step anywhere, and within lr/100 but for one element in a
    thousand), the replicated copies bit-identical on every shard.  With
    ``use_flash`` the ring takes ``RingFlash`` (128-position blocks, the
    plain flash versions on the CPU) against the same reference."""
    lr = 1e-2
    jcfg, tcfg, jp, tp = _setup(1)
    S = 257 if use_flash else 33
    jm = jmesh.build_mesh(AXES)
    jp = jax.device_put(jp, jtr.param_shardings(jm, jp))
    jopt, opt = optax.adam(lr), adam(lr)
    jstate = jopt.init(jp)
    jstep = jax.jit(lambda p, o, b: jtr.lm_train_step(p, o, b, jopt, jcfg, jm, use_flash=False))
    pm = pmesh.build_mesh(AXES, platform="cpu")
    params = ttr.shard_params(tp, pm)
    state = opt.init(params)
    for step in range(3):
        tokens = np.random.default_rng(10 + step).integers(0, 64, size=(4, S)).astype(np.int32)
        jbatch = {"tokens": jax.device_put(jnp.asarray(tokens), NamedSharding(jm, P("dp", None)))}
        jp, jstate, jloss = jstep(jp, jstate, jbatch)
        params, state, loss = ttr.lm_train_step(params, state, {"tokens": torch.from_numpy(tokens)},
                                                opt, tcfg, use_flash=use_flash)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        _copies_identical(params)
    want = _jax_leaves(jax.device_get(jp))
    for key, p in leaves_with_paths(_gather(params)):
        diff = np.abs(p.numpy() - want[key])
        assert diff.max() <= 3 * 2 * lr, key
        assert (diff > 1e-2 * lr).mean() <= 1e-3, key


#: 8 heads over 2 kv heads: a tp of 4 is a multiple of the kv heads
GQA = dict(vocab=64, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2, d_ff=64)


def _capture_grads(tcfg, params, mesh, batch):
    """(loss, gradients) of one ``lm_loss`` through ``grad_update``."""
    from seldon_core_tpu_torch.optim import grad_update

    seen = {}

    class Capture:
        def update(self, grads, state, params=None):
            seen["g"] = grads
            return grads, state

    state = None if mesh is None else pmesh.ShardedTree(mesh, [None] * mesh.size)
    _, _, loss = grad_update(lambda p, b: ttr.lm_loss(p, b, tcfg), params, state, batch,
                             Capture())
    return loss, seen["g"]


def test_shared_kv_columns_sum_their_readers_gradients_as_one_device(devices8):
    """Over {"tp": 4} at 8 heads and 2 kv heads two shards read each kv
    head's ``wqkv`` columns (``kv_head_range``): the loss and every leaf's
    gradient, those shared columns' summed over both readers by the run's
    one autograd graph, equal the one-device port's within this file's
    bounds (loss 1e-6 relative, gradients 1e-5 relative and 1e-6
    absolute), the copies bit-identical."""
    _, tcfg, _, tp = _setup(2, GQA)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(0, 64, size=(4, 17)))}
    loss1, g1 = _capture_grads(tcfg, tp, None, batch)
    mesh = pmesh.build_mesh({"tp": 4}, platform="cpu")
    loss4, g4 = _capture_grads(tcfg, ttr.shard_params(tp, mesh), mesh, batch)
    np.testing.assert_allclose(float(loss4), float(loss1), rtol=1e-6)
    _copies_identical(g4)
    whole = dict(leaves_with_paths(_gather(g4)))
    for key, g in leaves_with_paths(g1):
        np.testing.assert_allclose(whole[key].numpy(), g.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_a_tp_multiple_of_the_kv_heads_trains_as_the_reference(devices8):
    """Two ``lm_train_step``s over {"tp": 4} at 8 heads and 2 kv heads
    against the reference's step jitted over the same mesh: the loss at
    rtol 1e-5 and every leaf by ``test_sharded_train_steps_match_reference``'s
    rule."""
    lr = 1e-2
    jcfg, tcfg, jp, tp = _setup(3, GQA)
    jm = jmesh.build_mesh({"tp": 4})
    jp = jax.device_put(jp, jtr.param_shardings(jm, jp))
    jopt, opt = optax.adam(lr), adam(lr)
    jstate = jopt.init(jp)
    jstep = jax.jit(lambda p, o, b: jtr.lm_train_step(p, o, b, jopt, jcfg, jm, use_flash=False))
    params = ttr.shard_params(tp, pmesh.build_mesh({"tp": 4}, platform="cpu"))
    state = opt.init(params)
    for step in range(2):
        tokens = np.random.default_rng(20 + step).integers(0, 64, size=(4, 17)).astype(np.int32)
        jp, jstate, jloss = jstep(jp, jstate, {"tokens": jnp.asarray(tokens)})
        params, state, loss = ttr.lm_train_step(params, state, {"tokens": torch.from_numpy(tokens)},
                                                opt, tcfg)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        _copies_identical(params)
    want = _jax_leaves(jax.device_get(jp))
    for key, p in leaves_with_paths(_gather(params)):
        diff = np.abs(p.numpy() - want[key])
        assert diff.max() <= 3 * 2 * lr, key
        assert (diff > 1e-2 * lr).mean() <= 1e-3, key


UNEVEN = dict(vocab=64, d_model=320, n_heads=40, n_kv_heads=10, n_layers=2, d_ff=64)


def test_an_uneven_tp_trains_as_one_device_and_the_reference(devices8):
    """Over {"tp": 4} at 40 heads and 10 kv heads (a tp that neither
    divides nor is a multiple of the kv heads: kv heads 2 and 7 are read
    by two shards each, every shard attends two runs of groups 4 and 2):
    step 0's loss and every leaf's gradient, the shared K/V columns'
    summed over both readers, equal the one-device port's within
    ``test_shared_kv_columns_sum_their_readers_gradients_as_one_device``'s
    bounds; then two ``lm_train_step``s against the reference's step
    jitted over the same mesh by ``test_sharded_train_steps_match_reference``'s
    rule."""
    lr = 1e-2
    jcfg, tcfg, jp, tp = _setup(5, UNEVEN)
    tokens = np.random.default_rng(5).integers(0, 64, size=(4, 17))
    batch = {"tokens": torch.from_numpy(tokens)}
    mesh = pmesh.build_mesh({"tp": 4}, platform="cpu")
    loss1, g1 = _capture_grads(tcfg, tp, None, batch)
    loss4, g4 = _capture_grads(tcfg, ttr.shard_params(tp, mesh), mesh, batch)
    np.testing.assert_allclose(float(loss4), float(loss1), rtol=1e-6)
    _copies_identical(g4)
    whole = dict(leaves_with_paths(_gather(g4)))
    for key, g in leaves_with_paths(g1):
        np.testing.assert_allclose(whole[key].numpy(), g.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    jm = jmesh.build_mesh({"tp": 4})
    jp = jax.device_put(jp, jtr.param_shardings(jm, jp))
    jopt, opt = optax.adam(lr), adam(lr)
    jstate = jopt.init(jp)
    jstep = jax.jit(lambda p, o, b: jtr.lm_train_step(p, o, b, jopt, jcfg, jm, use_flash=False))
    params = ttr.shard_params(tp, mesh)
    state = opt.init(params)
    for step in range(2):
        tokens = np.random.default_rng(30 + step).integers(0, 64, size=(4, 17)).astype(np.int32)
        jp, jstate, jloss = jstep(jp, jstate, {"tokens": jnp.asarray(tokens)})
        params, state, loss = ttr.lm_train_step(params, state, {"tokens": torch.from_numpy(tokens)},
                                                opt, tcfg)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        _copies_identical(params)
    want = _jax_leaves(jax.device_get(jp))
    for key, p in leaves_with_paths(_gather(params)):
        diff = np.abs(p.numpy() - want[key])
        assert diff.max() <= 3 * 2 * lr, key
        assert (diff > 1e-2 * lr).mean() <= 1e-3, key


def _mnist(seed, hidden=32):
    jp = jmnist.mlp_init(jax.random.key(seed), hidden=hidden, dtype=jnp.float32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _mnist_batch(seed, rows=256):
    rng = np.random.default_rng(seed)
    return rng.random((rows, 784)).astype(np.float32), rng.integers(0, 10, rows).astype(np.int32)


@pytest.mark.parametrize("axes", [None, {"dp": 4}], ids=["one_device", "dp4"])
def test_mnist_train_step_matches_reference(axes, devices8):
    """MNIST's ``train_step`` (784-32-32-10, f32, adam 1e-3, 256 rows) for
    three steps against the reference's jitted ``train_step`` (over
    {"dp": 4} with its batch sharded over ``dp``): losses at rtol 1e-5,
    parameters within 2 lr a step and lr/100 but for one element in a
    thousand (the Adam rule above); over ``dp`` the copies bit-identical."""
    lr = 1e-3
    jp, tp = _mnist(3)
    jopt, opt = optax.adam(lr), adam(lr)
    jstate = jopt.init(jp)
    jstep = jax.jit(lambda p, o, b: jmnist.train_step(p, o, b, jopt))
    params = tp if axes is None else pmesh.place_tree(tp, pmesh.build_mesh(axes, platform="cpu"))
    state = opt.init(params)
    jm = None if axes is None else jmesh.build_mesh(axes)
    for step in range(3):
        x, y = _mnist_batch(20 + step)
        jb = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
        if jm is not None:
            jb = jax.device_put(jb, NamedSharding(jm, P("dp")))
        jp, jstate, jloss = jstep(jp, jstate, jb)
        params, state, loss = tmnist.train_step(
            params, state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}, opt)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    if axes is not None:
        _copies_identical(params)
        params = params.shards[0]
    want = _jax_leaves(jp)
    for key, p in leaves_with_paths(params):
        diff = np.abs(p.numpy() - want[key])
        assert diff.max() <= 3 * 2 * lr, key
        assert (diff > 1e-2 * lr).mean() <= 1e-3, key


def test_mnist_loss_fn_matches_reference(devices8):
    jp, tp = _mnist(4)
    x, y = _mnist_batch(5, rows=64)
    want = float(jmnist.loss_fn(jp, {"image": jnp.asarray(x), "label": jnp.asarray(y)}))
    got = tmnist.loss_fn(tp, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    mesh = pmesh.build_mesh({"dp": 4}, platform="cpu")
    sharded = tmnist.loss_fn(pmesh.place_tree(tp, mesh),
                             {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    np.testing.assert_allclose(float(sharded), want, rtol=1e-6)
