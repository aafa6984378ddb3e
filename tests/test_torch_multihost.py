"""``parallel/multihost.py`` and meshes that span processes, on the CPU.

Two parts.  The reference's single-process cases of
``tests/test_multihost.py`` run against both packages in this process (the
no-op ``initialize``, ``process_info``'s keys, the plain and hybrid meshes,
the overlap and too-big errors, the host-local round trip, ``barrier``).
Then two real processes join over loopback TCP under gloo through the
``SELDON_*`` env contract, two CPU devices each, as the JAX worker
(``tests/resources/multihost_worker.py``) runs: this file run as a script
is the worker, which imports torch and the port only.  The parent carries
the JAX package's ``lm_init`` weights across (``convert.params_from_jax``,
``save_lm_weights``); each worker runs every case over a global mesh and
writes its shards' results to an ``.npz``.  The parent holds them against
the port's one-process mesh of the same shape (the collectives, the
logits, the ring's forward and backward, the pipeline over ``pp`` and MoE
experts over ``ep``, the step-0 loss: bit for bit; step-0 gradients within
1e-6 relative) and against the JAX package.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
TOKENS = (4, 16)
TRAIN_TOKENS = (4, 17)
RING = (1, 2, 128, 16)        # (B, H, S_local, D): RingFlash's 128-position blocks
MNIST_B, MNIST_LR, MNIST_STEPS = 64, 1e-3, 3
WORKER_TIMEOUT_S = 120


# -- what a worker runs, on a global mesh; the parent runs it on one process's

def _tensors(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(n)]


def collectives(mesh):
    """{name/shard: array}: every collective over every axis on per-shard
    inputs drawn from the shard's index."""
    from seldon_core_tpu_torch.parallel import mesh as pm

    def body(shard):
        x = _tensors(100 + shard.index, (3, 8), 1)[0]
        out = {}
        for axis in mesh.axis_names:
            n = mesh.shape[axis]
            out[f"all_reduce_{axis}"] = pm.all_reduce(x, axis)
            out[f"all_gather_{axis}"] = pm.all_gather(x, axis, dim=1)
            out[f"gather_slices_{axis}"] = pm.gather_slices(x, axis, 1, [(1, 3), (5, 7 * n)])
            k, v = pm.ring_shift((x, x * 2), axis)
            out[f"ring_shift_{axis}"] = torch.cat([k, v])
        return out

    outs = mesh.run(body)
    return {f"{k}/{i}": v.numpy() for i in mesh.owned for k, v in outs[i].items()}


def lm_logits(mesh, params, tokens, cfg):
    from seldon_core_tpu_torch.models import transformer as ttr

    return ttr.lm_apply(ttr.shard_params(params, mesh), torch.from_numpy(tokens), cfg).numpy()


def ring(mesh, axis):
    """o and (dq, dk, dv) of ``ring_attention_sharded`` (the kernel path's
    plain versions on the CPU) on global q/k/v; across processes each
    process's gradients cover its own blocks (the parent adds them)."""
    from seldon_core_tpu_torch.parallel.ring_attention import ring_attention_sharded

    B, H, Sl, D = RING
    n = mesh.shape[axis]
    q, k, v, do = (t.requires_grad_(i < 3) for i, t in
                   enumerate(_tensors(7 + n, (B, H, n * Sl, D), 4)))
    fn = ring_attention_sharded(mesh, axis, True, use_flash=True)
    o, grads = mesh.value_and_grad(lambda: fn(q, k, v), [q, k, v], do)
    return {"o": o.numpy(), **{f"d{name}": g.numpy() for name, g in zip("qkv", grads)}}


class Capture:
    """An optimizer that keeps the gradients it is given."""

    def update(self, grads, state, params=None):
        self.grads = grads
        return grads, state


def owned_leaves(tree, prefix):
    from seldon_core_tpu_torch.tree import leaves_with_paths

    return {f"{prefix}/{i}/{p}": t.detach().numpy() for i in tree.mesh.owned
            for p, t in leaves_with_paths(tree.shards[i])}


def train_step0(mesh, params, tokens, cfg):
    from seldon_core_tpu_torch.models import transformer as ttr
    from seldon_core_tpu_torch.optim import grad_update
    from seldon_core_tpu_torch.parallel.mesh import ShardedTree

    cap = Capture()
    _, _, loss = grad_update(lambda p, b: ttr.lm_loss(p, b, cfg), ttr.shard_params(params, mesh),
                             ShardedTree(mesh, [None] * mesh.size),
                             {"tokens": torch.from_numpy(tokens)}, cap)
    return {"loss": loss.numpy(), **owned_leaves(cap.grads, "g")}


def pipeline_cases(mesh, params, cfg):
    """The GPipe pipeline over ``pp``: the logits of 2 microbatches and
    step 0's loss and gradients (every stage's leaves, the replicated
    embedding's and final norm's copies summed)."""
    from seldon_core_tpu_torch.models import transformer as ttr
    from seldon_core_tpu_torch.optim import grad_update
    from seldon_core_tpu_torch.parallel.mesh import ShardedTree

    pp = ttr.lm_pipeline_params(params, cfg, mesh.shape["pp"], mesh)
    out = {"logits": ttr.lm_pipeline_apply(pp, torch.from_numpy(_tokens(1, TOKENS)), cfg,
                                           n_micro=2).numpy()}
    cap = Capture()
    _, _, loss = grad_update(
        lambda p, b: ttr.lm_pipeline_loss(p, b, cfg, n_micro=2), pp,
        ShardedTree(mesh, [None] * mesh.size),
        {"tokens": torch.from_numpy(_tokens(2, TRAIN_TOKENS))}, cap)
    return {**out, "loss": loss.numpy(), "crossed": np.array(mesh.crossed_bytes.get("pp", 0)),
            **owned_leaves(cap.grads, "g")}


def moe_cases(mesh, params, cfg):
    """MoE layers with their experts over ``ep``: the logits, a static
    generator's greedy tokens, and step 0's loss and gradients."""
    from seldon_core_tpu_torch.models import generate as gm
    from seldon_core_tpu_torch.models import transformer as ttr

    placed = ttr.shard_params(params, mesh)
    toks = gm.generate(placed, torch.from_numpy(_tokens(3, (2, 5))), cfg, max_new_tokens=4)
    return {"logits": lm_logits(mesh, params, _tokens(1, TOKENS), cfg), "tokens": toks.numpy(),
            **train_step0(mesh, params, _tokens(2, TRAIN_TOKENS), cfg)}


def seeded_everywhere(mesh, params, tokens, cfg):
    """The gradients of ``lm_loss`` when every process seeds its copy of
    the loss with 1 (what ``DeviceMesh.value_and_grad`` does not do),
    replicas summed."""
    from seldon_core_tpu_torch.models import transformer as ttr
    from seldon_core_tpu_torch.parallel.mesh import ShardedTree, sum_replicas
    from seldon_core_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

    sp = ttr.shard_params(params, mesh)
    live = ShardedTree(mesh, [None if s is None else
                              tree_map(lambda t: t.detach().requires_grad_(True), s)
                              for s in sp.shards], sp.specs)
    mesh.open_tape()
    loss = ttr.lm_loss(live, {"tokens": torch.from_numpy(tokens)}, cfg)
    token = mesh.close_tape()  # None on a one-process mesh
    roots = [loss] if token is None else [loss, token]
    flat = {i: tree_leaves(live.shards[i]) for i in mesh.owned}
    got = iter(torch.autograd.grad(roots, [t for f in flat.values() for t in f],
                                   [torch.ones_like(r) if r is loss else torch.zeros_like(r)
                                    for r in roots]))
    grads = [tree_unflatten(live.shards[i], [next(got) for _ in flat[i]]) if i in flat else None
             for i in range(mesh.size)]
    return owned_leaves(sum_replicas(ShardedTree(mesh, grads, sp.specs)), "g_all")


def mnist_steps(mesh):
    from seldon_core_tpu_torch.models import mnist as tmnist
    from seldon_core_tpu_torch.optim import adam
    from seldon_core_tpu_torch.parallel.mesh import place_tree

    params = place_tree(tmnist.mlp_init(torch.Generator().manual_seed(3), hidden=32,
                                        dtype=torch.float32, device="cpu"), mesh)
    opt = adam(MNIST_LR)
    state = opt.init(params)
    losses = []
    for step in range(MNIST_STEPS):
        rng = np.random.default_rng(20 + step)
        batch = {"image": torch.from_numpy(rng.random((MNIST_B, 784)).astype(np.float32)),
                 "label": torch.from_numpy(rng.integers(0, 10, MNIST_B).astype(np.int32))}
        params, state, loss = tmnist.train_step(params, state, batch, opt)
        losses.append(float(loss))
    return {"mnist_losses": np.array(losses), **owned_leaves(params, "mnist")}


def ensemble(mesh):
    """``SharedEnsembleUnit``'s answer: 8 MNIST members, 2 a shard, their
    mean through one ``all_reduce`` over ``ens``."""
    from seldon_core_tpu_torch.parallel.ensemble import SharedEnsembleUnit

    unit = SharedEnsembleUnit(member="MnistClassifier", n_members=8, member_hidden=32,
                              member_use_pallas="never", mesh=mesh, device="cpu")
    x = _tensors(11, (5, 784), 1)[0]
    return unit.predict(unit.init_state(None), x).numpy()


def _lm_cfg(**over):
    from seldon_core_tpu_torch.models import transformer as ttr

    return ttr.LMConfig(**{**DIMS, **over}, dtype=torch.float32)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, DIMS["vocab"], size=shape).astype(np.int32)


# the cases: (name, the global mesh's arguments, what runs on it)
MESHES = {
    "tp4": ({"tp": 4}, None),            # one group, two shards on each process
    "tp2": ({"tp": 2}, None),            # one shard a process
    "sp2": ({"sp": 2}, None),
    "sp4": ({"sp": 4}, None),
    "dp2": ({"dp": 2}, None),
    "dp2_tp2": ({"tp": 2}, {"dp": 2}),   # hybrid: dp over processes, tp inside
    "dp4": ({"dp": 4}, None),
    "ens4": ({"ens": 4}, None),
    "pp4": ({"pp": 4}, None),            # two stages on each process
    "ep4": ({"ep": 4}, None),            # one expert of four on each shard
}


def run_cases(make_mesh, weights_path):
    """Every case on the meshes ``make_mesh(name)`` gives: {key: array}."""
    from seldon_core_tpu_torch.models import transformer as ttr

    cfg = _lm_cfg()
    params = ttr.load_lm_weights(ttr.lm_init(torch.Generator().manual_seed(0), cfg, "cpu"),
                                 weights_path)
    out = {}
    for name in ("tp4", "dp2_tp2", "sp4"):
        out.update({f"coll/{name}/{k}": v for k, v in collectives(make_mesh(name)).items()})
    for name in ("tp2", "sp2", "tp4"):
        out[f"logits/{name}"] = lm_logits(make_mesh(name), params, _tokens(1, TOKENS), cfg)
    for name, axis in (("sp2", "sp"), ("sp4", "sp")):
        out.update({f"ring/{name}/{k}": v for k, v in ring(make_mesh(name), axis).items()})
    for name in ("dp2_tp2", "dp2"):
        out.update({f"train/{name}/{k}": v for k, v in
                    train_step0(make_mesh(name), params, _tokens(2, TRAIN_TOKENS), cfg).items()})
    out.update({f"train/dp2/{k}": v for k, v in
                seeded_everywhere(make_mesh("dp2"), params, _tokens(2, TRAIN_TOKENS),
                                  cfg).items()})
    # DIMS's widths over 2 kv heads: tp=4 is a multiple of them, so the two
    # shards of a group (one on each process) read the same kv head
    gqa = _lm_cfg(n_kv_heads=2)
    gp = ttr.lm_init(torch.Generator().manual_seed(1), gqa, "cpu")
    out["logits/tp4_kv2"] = lm_logits(make_mesh("tp4"), gp, _tokens(1, TOKENS), gqa)
    out.update({f"train/tp4_kv2/{k}": v for k, v in
                train_step0(make_mesh("tp4"), gp, _tokens(2, TRAIN_TOKENS), gqa).items()})
    # four layers, one a stage over pp=4 (stages 0-1 on process 0, 2-3 on 1)
    deep = _lm_cfg(n_layers=4)
    dp_ = ttr.lm_init(torch.Generator().manual_seed(2), deep, "cpu")
    out.update({f"pipeline/pp4/{k}": v for k, v in
                pipeline_cases(make_mesh("pp4"), dp_, deep).items()})
    # every layer MoE, 4 experts top 2, one expert a shard over ep=4
    moe = _lm_cfg(moe_every=1, n_experts=4)
    mp = ttr.lm_init(torch.Generator().manual_seed(4), moe, "cpu")
    out.update({f"moe/ep4/{k}": v for k, v in moe_cases(make_mesh("ep4"), mp, moe).items()})
    out.update({f"mnist/dp4/{k}": v for k, v in mnist_steps(make_mesh("dp4")).items()})
    out["ensemble/ens4"] = ensemble(make_mesh("ens4"))
    return out


def _worker(out_dir: str) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from seldon_core_tpu_torch.parallel import mesh as pm
    from seldon_core_tpu_torch.parallel import multihost as mh

    assert mh.initialize() and mh.initialize()  # the env contract; a repeat call joins once
    pm.set_cpu_device_count(2)
    info = mh.process_info("cpu")
    assert info == {"process_index": info["process_index"], "process_count": 2,
                    "local_device_count": 2, "global_device_count": 4}, info
    meshes = {}

    def make_mesh(name):
        if name not in meshes:
            axes, dcn = MESHES[name]
            meshes[name] = mh.global_mesh(axes, dcn, platform="cpu")
        return meshes[name]

    out = run_cases(make_mesh, os.path.join(out_dir, "weights.npz"))
    # the JAX worker's round trip: host-local rows -> global, a reduction
    # across processes, back to host-local
    pid = info["process_index"]
    mesh = make_mesh("dp4")
    local = np.full((2, 4), float(pid + 1), np.float32)
    g = mh.host_local_to_global(mesh, ("dp", None), local)
    total = mesh.run(lambda s: pm.all_reduce(g.shards[s.index].sum(), "dp"))
    mh.barrier("test_sync")
    back = mh.global_to_host_local(mesh, ("dp", None), g)
    out["host_local/total"] = np.array([float(total[i]) for i in mesh.owned])
    out["host_local/back"] = back.numpy()
    out["backend"] = np.array(mh.backend())
    out["owned"] = np.array(mesh.owned)
    np.savez(os.path.join(out_dir, f"rank{pid}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(json.dumps({"process": pid, "owned": mesh.owned}), flush=True)


if __name__ == "__main__":
    _worker(sys.argv[1])
    sys.exit(0)


# -- the reference's cases, both packages in this process -------------------

from seldon_core_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from seldon_core_tpu_torch.parallel import multihost as pmh  # noqa: E402


@pytest.fixture
def eight(monkeypatch):
    monkeypatch.setattr(pmesh, "_CPU_DEVICES", pmesh._CPU_DEVICES)
    pmesh.set_cpu_device_count(8)


@pytest.fixture
def jmh():
    from seldon_core_tpu.parallel import multihost

    return multihost


def test_initialize_noop_without_coordinator(monkeypatch, jmh):
    monkeypatch.delenv(pmh.ENV_COORDINATOR, raising=False)
    assert (pmh.ENV_COORDINATOR, pmh.ENV_NUM_PROCESSES, pmh.ENV_PROCESS_ID) == \
        (jmh.ENV_COORDINATOR, jmh.ENV_NUM_PROCESSES, jmh.ENV_PROCESS_ID)
    assert jmh.initialize() is False and pmh.initialize() is False
    assert jmh.is_distributed() is False and pmh.is_distributed() is False
    assert pmh.backend() is None


def test_process_info_keys(devices8, eight, jmh):
    want, got = jmh.process_info(), pmh.process_info("cpu")
    assert set(got) == set(want)
    assert got["process_count"] == want["process_count"] == 1
    assert got["process_index"] == want["process_index"] == 0
    assert got["global_device_count"] == got["local_device_count"] == 8


@pytest.mark.parametrize("axes,dcn", [({"dp": 2, "tp": 4}, None), ({"tp": 4}, {"dp": 2})],
                         ids=["plain", "hybrid"])
def test_global_mesh_names_and_shape(axes, dcn, devices8, eight, jmh):
    want = jmh.global_mesh(axes, dcn_axes=dcn)
    got = pmh.global_mesh(axes, dcn_axes=dcn, platform="cpu")
    assert got.axis_names == tuple(want.axis_names) == ("dp", "tp")
    assert got.shape == dict(want.shape) == {"dp": 2, "tp": 4}
    assert not got.spans_processes and got.owned == list(range(8))


@pytest.mark.parametrize("axes,dcn,match", [
    ({"dp": 2, "tp": 2}, {"dp": 2}, "exactly one link layer"),
    ({"dp": 1024}, None, "needs 1024 devices, have 8")], ids=["overlap", "too_big"])
def test_global_mesh_refusals(axes, dcn, match, devices8, eight, jmh):
    with pytest.raises(ValueError, match=match):
        jmh.global_mesh(axes, dcn_axes=dcn)
    with pytest.raises(ValueError, match=match):
        pmh.global_mesh(axes, dcn_axes=dcn, platform="cpu")


def test_host_local_roundtrip_and_barrier(devices8, eight, jmh):
    from jax.sharding import PartitionSpec as P

    x = np.arange(16.0).reshape(16, 1)
    jm = jmh.global_mesh({"dp": 8})
    want = np.asarray(jmh.global_to_host_local(jm, P("dp", None),
                                               jmh.host_local_to_global(jm, P("dp", None), x)))
    mesh = pmh.global_mesh({"dp": 8}, platform="cpu")
    g = pmh.host_local_to_global(mesh, ("dp", None), x)
    assert [tuple(t.shape) for t in g.shards] == [(2, 1)] * 8
    assert torch.equal(g.shards[3], torch.from_numpy(x[6:8]))
    back = pmh.global_to_host_local(mesh, ("dp", None), g)
    np.testing.assert_array_equal(back.numpy(), want)
    jmh.barrier("test")
    pmh.barrier("test")  # no-op single process


def test_backend_rule():
    assert pmh.choose_backend(["", ""]) == "gloo"                  # the CPU
    assert pmh.choose_backend(["GPU-a", "GPU-b"]) == "nccl"        # a card each
    assert pmh.choose_backend(["GPU-a", "GPU-a"]) == "gloo"        # one card shared
    assert pmh.choose_backend(["GPU-a,GPU-b", "GPU-b"]) == "gloo"  # one card seen twice
    assert pmh.choose_backend(["GPU-a", ""]) == "gloo"             # a process without


# -- two processes ---------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def jax_lm():
    import jax
    import jax.numpy as jnp

    from seldon_core_tpu.models import transformer as jtr

    jcfg = jtr.LMConfig(**DIMS, dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jtr.lm_init(jax.random.key(0), jcfg))
    return jcfg, jp


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, jax_lm):
    """The weights file, and every case on the port's one-process meshes
    of the same shapes (eight CPU devices)."""
    from seldon_core_tpu_torch.convert import params_from_jax
    from seldon_core_tpu_torch.models import transformer as ttr

    d = tmp_path_factory.mktemp("multihost")
    ttr.save_lm_weights(params_from_jax(jax_lm[1], "cpu"), str(d / "weights.npz"))
    prev, threads = pmesh._CPU_DEVICES, torch.get_num_threads()
    pmesh.set_cpu_device_count(8)
    torch.set_num_threads(1)
    try:
        cases = run_cases(lambda name: pmesh.build_mesh(
            {**(MESHES[name][1] or {}), **MESHES[name][0]}, platform="cpu"),
            str(d / "weights.npz"))
    finally:
        pmesh.set_cpu_device_count(prev)
        torch.set_num_threads(threads)
    return d, cases


class Results:
    """Both workers' results: ``at(key, pid)`` one process's, ``[key]`` a
    shard's from the process that owns it."""

    def __init__(self, parts):
        self.parts = parts

    def at(self, key, pid):
        return self.parts[pid][key]

    def __getitem__(self, key):
        got = [p[key] for p in self.parts if key in p]
        assert len(got) == 1, key
        return got[0]


@pytest.fixture(scope="module")
def two_processes(one_process):
    """Both workers' results (``Results``)."""
    d, _ = one_process
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               SELDON_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", SELDON_NUM_PROCESSES="2")
    procs = [subprocess.Popen([sys.executable, __file__, str(d)],
                              env={**env, "SELDON_PROCESS_ID": str(pid)}, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [o["process"] for o in outs] == [0, 1]
    parts = []
    for pid in range(2):
        with np.load(d / f"rank{pid}.npz") as z:
            parts.append({k: z[k] for k in z.files})
    return Results(parts)


def test_workers_join_over_gloo_with_the_reference_layout(two_processes):
    r = two_processes
    assert str(r.at("backend", 0)) == str(r.at("backend", 1)) == "gloo"
    # process-major: process p holds shards [2p, 2p + 2) of the 4-device meshes
    assert r.at("owned", 0).tolist() == [0, 1] and r.at("owned", 1).tolist() == [2, 3]
    # the JAX worker's sums: 2 local rows of 4 of (pid + 1) on each process
    for pid in range(2):
        assert r.at("host_local/total", pid).tolist() == [24.0] * 2
        np.testing.assert_array_equal(r.at("host_local/back", pid),
                                      np.full((2, 4), pid + 1.0, np.float32))


def _keys(cases, prefix):
    ks = sorted(k for k in cases if k.startswith(prefix))
    assert ks, prefix
    return ks


@pytest.mark.parametrize("mesh", ["tp4", "dp2_tp2", "sp4"])
def test_collectives_across_processes_are_the_one_process_bits(mesh, one_process,
                                                               two_processes):
    """all_reduce, all_gather, gather_slices and ring_shift over every axis
    (one group spanning both processes with two shards on each, an axis
    inside a process, an axis over processes): bit for bit."""
    _, want = one_process
    keys = _keys(want, f"coll/{mesh}/")
    n_axes = len(MESHES[mesh][0]) + len(MESHES[mesh][1] or {})
    assert len(keys) == 4 * 4 * n_axes  # 4 collectives an axis on each of 4 shards
    for k in keys:
        np.testing.assert_array_equal(two_processes[k], want[k], err_msg=k)


@pytest.mark.parametrize("mesh", ["tp2", "sp2", "tp4"])
def test_lm_apply_across_processes(mesh, one_process, two_processes, jax_lm, devices8):
    """The logits on every process are the one-process mesh's bits; over
    tp they stand within ``test_torch_tensor_parallel.py``'s 3e-4 of the
    JAX package's tp mesh."""
    import jax

    from seldon_core_tpu.models import transformer as jtr
    from seldon_core_tpu.parallel import mesh as jmesh

    _, want = one_process
    for pid in range(2):
        np.testing.assert_array_equal(two_processes.at(f"logits/{mesh}", pid),
                                      want[f"logits/{mesh}"])
    if mesh.startswith("tp"):
        jcfg, jp = jax_lm
        jm = jmesh.build_mesh(MESHES[mesh][0])
        ref = np.asarray(jax.jit(lambda p, t: jtr.lm_apply(p, t, jcfg, mesh=jm))(
            jax.device_put(jp, jtr.param_shardings(jm, jp)), _tokens(1, TOKENS)))
        np.testing.assert_allclose(two_processes.at(f"logits/{mesh}", 0), ref, atol=3e-4)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("mesh", ["sp2", "sp4"])
def test_ring_forward_and_backward_across_processes(mesh, one_process, two_processes):
    """RingFlash over an sp that spans processes: o on every process bit
    for bit the one-process mesh's, and dq/dk/dv (each process's blocks,
    added): the blocks arrive through ring_shift and their dK/dV go back
    through its adjoint.  Over sp=2 (one shard a process) a block's dK/dV
    sums two readers' shares, so the gradients are the same bits too; over
    sp=4 (two shards a process) a block reaches up to four readers, and
    the one-process graph adds their shares in one running sum where the
    processes add two and two: within 1e-6 relative."""
    _, want = one_process
    for pid in range(2):
        np.testing.assert_array_equal(two_processes.at(f"ring/{mesh}/o", pid),
                                      want[f"ring/{mesh}/o"])
    for g in ("dq", "dk", "dv"):
        got = two_processes.at(f"ring/{mesh}/{g}", 0) + two_processes.at(f"ring/{mesh}/{g}", 1)
        if mesh == "sp2":
            np.testing.assert_array_equal(got, want[f"ring/{mesh}/{g}"], err_msg=g)
        else:
            assert _rel(got, want[f"ring/{mesh}/{g}"]) <= 1e-6, g


def test_train_step0_over_dp_tp_across_processes(one_process, two_processes, jax_lm):
    """Step 0 of lm_train_step over dp=2 (over the processes) x tp=2
    (inside each): the loss on both processes bit for bit the one-process
    mesh's; every shard's gradients (replicas summed) within 1e-6 relative
    of it, and the whole gradients within ``test_torch_train_sharded.py``'s
    bound of one device's."""
    from seldon_core_tpu_torch.convert import params_from_jax
    from seldon_core_tpu_torch.models import transformer as ttr
    from seldon_core_tpu_torch.optim import grad_update
    from seldon_core_tpu_torch.tree import leaves_with_paths

    _, want = one_process
    for pid in range(2):
        assert two_processes.at("train/dp2_tp2/loss", pid) == want["train/dp2_tp2/loss"]
    keys = _keys(want, "train/dp2_tp2/g/")
    assert len(keys) == 4 * (2 * 6 + 2)
    for k in keys:
        assert _rel(two_processes[k], want[k]) <= 1e-6, k
    cap = Capture()
    cfg = _lm_cfg()
    grad_update(lambda p, b: ttr.lm_loss(p, b, cfg), params_from_jax(jax_lm[1], "cpu"), None,
                {"tokens": torch.from_numpy(_tokens(2, TRAIN_TOKENS))}, cap)
    for path, g in leaves_with_paths(cap.grads):
        parts = [two_processes[f"train/dp2_tp2/g/{i}/{path}"] for i in (0, 1)]
        split = parts[0].shape != tuple(g.shape)
        whole = np.concatenate(parts, axis=0 if path.endswith(("['wo']", "['w2']")) else 1) \
            if split else parts[0]
        np.testing.assert_allclose(whole, g.numpy(), rtol=1e-5, atol=1e-6, err_msg=path)


def test_a_tp_multiple_of_the_kv_heads_across_processes(one_process, two_processes):
    """Over a tp=4 that spans the processes at 4 heads and 2 kv heads (the
    two shards of each kv head's group on two processes): the logits and
    the step-0 loss on both processes are the one-process mesh's bits, and
    every shard's step-0 gradients, the shared K/V columns' summed onto
    their owner across the processes, within 1e-6 relative of it."""
    _, want = one_process
    for pid in range(2):
        np.testing.assert_array_equal(two_processes.at("logits/tp4_kv2", pid),
                                      want["logits/tp4_kv2"])
        assert two_processes.at("train/tp4_kv2/loss", pid) == want["train/tp4_kv2/loss"]
    keys = _keys(want, "train/tp4_kv2/g/")
    assert len(keys) == 4 * (2 * 6 + 2)
    for k in keys:
        assert _rel(two_processes[k], want[k]) <= 1e-6, k


def test_seeding_the_loss_on_every_process_counts_it_twice(one_process, two_processes):
    """Over dp=2, one shard a process: the gradients equal the one-process
    mesh's (1e-6 relative); seeding every process's copy of the loss with
    1, as a plain backward would, doubles them, and that is caught."""
    _, want = one_process
    keys = _keys(want, "train/dp2/g/")
    for k in keys:
        assert _rel(two_processes[k], want[k]) <= 1e-6, k
        doubled = two_processes[k.replace("/g/", "/g_all/")]
        assert _rel(doubled, 2 * want[k]) <= 1e-6, k
        if np.abs(want[k]).max() > 0:
            assert _rel(doubled, want[k]) > 0.5, k


def test_shared_ensemble_across_processes(one_process, two_processes):
    """``SharedEnsembleUnit`` over an ``ens`` axis that spans processes:
    every process answers the one-process mesh's mean, bit for bit."""
    _, want = one_process
    for pid in range(2):
        np.testing.assert_array_equal(two_processes.at("ensemble/ens4", pid),
                                      want["ensemble/ens4"])


def test_mnist_dp_steps_across_processes(one_process, two_processes):
    """MNIST's train_step over dp=4 (two shards a process), three steps:
    the losses bit for bit the one-process mesh's on both processes, and
    every copy of the parameters within the Adam rule of
    ``test_torch_train_sharded.py`` of it (2 lr a step; within lr/100 but
    for one element in a thousand)."""
    _, want = one_process
    for pid in range(2):
        np.testing.assert_array_equal(two_processes.at("mnist/dp4/mnist_losses", pid),
                                      want["mnist/dp4/mnist_losses"])
    for k in _keys(want, "mnist/dp4/mnist/"):
        diff = np.abs(two_processes[k] - want[k])
        assert diff.max() <= MNIST_STEPS * 2 * MNIST_LR, k
        assert (diff > 1e-2 * MNIST_LR).mean() <= 1e-3, k


def test_pipeline_across_processes(one_process, two_processes):
    """The GPipe pipeline over a pp=4 that spans the processes (two stages
    on each, the hand-off of stage 1 to stage 2 crossing): its bubble
    ticks send nothing, and a tick's round names its senders
    (``RoundPlan``).  The logits and the step-0 loss on both processes are
    the one-process mesh's bits; every stage's step-0 gradients (the
    activations' gradients back through the crossing's adjoint) within
    1e-6 relative of it.  Each process's hand-offs over ``pp`` received
    bytes (``DeviceMesh.crossed_bytes``), the one-process mesh's none."""
    _, want = one_process
    for pid in range(2):
        np.testing.assert_array_equal(two_processes.at("pipeline/pp4/logits", pid),
                                      want["pipeline/pp4/logits"])
        assert two_processes.at("pipeline/pp4/loss", pid) == want["pipeline/pp4/loss"]
        assert int(two_processes.at("pipeline/pp4/crossed", pid)) > 0
    assert int(want["pipeline/pp4/crossed"]) == 0
    keys = _keys(want, "pipeline/pp4/g/")
    assert len(keys) == 4 * (2 + 6)  # embed, ln_f and a stage's six leaves on each shard
    for k in keys:
        assert _rel(two_processes[k], want[k]) <= 1e-6, k


def test_moe_experts_over_ep_across_processes(one_process, two_processes):
    """MoE layers whose four experts lie one a shard over an ep=4 that
    spans the processes: the routing, capacity and load-balance loss are
    computed on every shard, the experts' products joined by an
    ``all_gather`` that crosses.  The logits, a static generator's greedy
    tokens and the step-0 loss on both processes are the one-process
    mesh's bits; every shard's step-0 gradients (its experts' through the
    gather's adjoint, ``_SharePlan.reduce``) within 1e-6 relative."""
    _, want = one_process
    for pid in range(2):
        for name in ("logits", "tokens", "loss"):
            np.testing.assert_array_equal(two_processes.at(f"moe/ep4/{name}", pid),
                                          want[f"moe/ep4/{name}"], err_msg=name)
    keys = _keys(want, "moe/ep4/g/")
    assert len(keys) == 4 * (2 * 7 + 2)  # a layer: ln1, wqkv, wo, ln2 and moe wg, w1, w2
    assert any(np.abs(want[k]).max() > 0 for k in keys if k.endswith("['w1']"))
    for k in keys:
        assert _rel(two_processes[k], want[k]) <= 1e-6, k


def test_spanning_paths_refused_at_construction(monkeypatch):
    """The continuous lane raises at construction on a mesh that spans
    processes, in the port's words; the pipeline's params and an MoE unit
    over such a mesh (its ``pp`` or ``ep`` axis spanning) are built."""
    from seldon_core_tpu_torch.models import generate as gm
    from seldon_core_tpu_torch.models import transformer as ttr
    from seldon_core_tpu_torch.runtime.genserver import GenServer

    monkeypatch.setattr(pmesh.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda: 2)
    made = []
    monkeypatch.setattr(pmesh.dist, "new_group", lambda ranks: made.append(ranks))
    devs = np.array([torch.device("cpu"), torch.device("cpu"), None, None], dtype=object)
    mesh = pmesh.DeviceMesh(devs.reshape(2, 2), ("pp", "ep"),
                            process_of=np.array([[0, 0], [1, 1]]))
    assert mesh.spans("pp") and not mesh.spans("ep") and mesh.owned == [0, 1]
    assert made == []  # every group of two processes is the default group
    cfg = ttr.LMConfig(**DIMS, dtype=torch.float32)
    placed = ttr.shard_pipeline_params({"embed": torch.zeros(1), "ln_f": torch.zeros(1),
                                        "stages": {"w": torch.zeros(2, 3)}}, mesh)
    assert placed.shards[2:] == [None, None] and placed.shards[0]["stages"]["w"].shape == (1, 3)
    ep = pmesh.DeviceMesh(devs.reshape(1, 4), ("tp", "ep"),
                          process_of=np.array([[0, 0, 1, 1]]))
    unit = ttr.TransformerLM(**DIMS, dtype="float32", moe_every=1, n_experts=4, mesh=ep,
                             device="cpu")
    assert unit.mesh is ep and ep.spans("ep")
    with pytest.raises(ValueError, match="continuous lane over a mesh that spans processes"):
        GenServer({}, cfg, mesh=ep)
    gen = gm.TransformerGenerator(**DIMS, dtype="float32", mesh=ep, device="cpu")
    assert gen.device == torch.device("cpu") and gen.mesh is ep
