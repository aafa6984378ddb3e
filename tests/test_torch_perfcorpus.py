"""The port's durable perf corpus (``seldon_core_tpu_torch/utils/perfcorpus.py``)
against the JAX package's: the same record sequence (made with numpy from a
seed, under one injected clock) gives the same ``document()`` and the same
``sketch.json`` bytes; a directory that either package wrote warm-starts the
other's autopilot to the same keys and estimates; an unwritable directory
disables the corpus and counts the error; with the directory unset nothing
is written.  Then the engine: the spine's dispatch fold appends to the
corpus, and a second engine on the same directory prices the keys before
its first request."""

import asyncio
import json
import threading
import time

import numpy as np
import pytest
import torch

from seldon_core_tpu.runtime import autopilot as jap
from seldon_core_tpu.utils import perfcorpus as jpc
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
from seldon_core_tpu_torch.runtime import autopilot as pap
from seldon_core_tpu_torch.runtime.engine import EngineService
from seldon_core_tpu_torch.utils import perfcorpus as ppc


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_learned_singletons():
    pap.reset_learned_singletons()
    jap.AUTOPILOT.reset()
    yield
    pap.reset_learned_singletons()
    jap.AUTOPILOT.reset()


class _CorpusClock:
    """A ``time`` module stand-in that only the two corpora read: each
    ``time()`` call advances the shared counter by 0.125 s."""

    def __init__(self, now):
        self.now = now

    def time(self):
        self.now[0] += 0.125
        return self.now[0]


@pytest.fixture()
def clock(monkeypatch):
    """One wall clock for both packages' row and sketch timestamps.  It
    replaces each corpus module's ``time`` attribute, not the process-wide
    ``time.time``: another thread of the process (a scheduler, a drainer)
    that reads the wall clock must not move the counter between the two
    corpora's records."""
    now = [1_700_000_000.0]
    fake = _CorpusClock(now)
    monkeypatch.setattr(jpc, "time", fake)
    monkeypatch.setattr(ppc, "time", fake)
    return now


def _rows(seed, n=120):
    rng = np.random.default_rng(seed)
    keys = [f"predict[{b}x784/float32]" for b in (1, 2, 4, 8, 64)]
    out = []
    for _ in range(n):
        i = int(rng.integers(len(keys)))
        b = (1, 2, 4, 8, 64)[i]
        out.append((keys[i], {"pad_bucket": b, "tier": str(rng.choice(["interactive", "batch"])),
                              "wall_s": float(rng.gamma(2.0, 1e-3)), "rows": int(b - rng.integers(0, b)),
                              "features": {"flops": 2.0 * b * 784 * 512,
                                           "bytes_accessed": 1.5e6 + 3136.0 * b}}))
    return out


def _corpora(tmp_path, monkeypatch, segment_bytes=None, max_segments=None):
    monkeypatch.setenv("SELDON_TPU_CORPUS", "1")
    monkeypatch.setenv("SELDON_TPU_CORPUS_DIR", str(tmp_path / "jax"))
    if segment_bytes is not None:
        monkeypatch.setenv("SELDON_TPU_CORPUS_SEGMENT_BYTES", str(segment_bytes))
    if max_segments is not None:
        monkeypatch.setenv("SELDON_TPU_CORPUS_MAX_SEGMENTS", str(max_segments))
    j = jpc.PerfCorpus()
    monkeypatch.setenv("SELDON_TPU_CORPUS_DIR", str(tmp_path / "port"))
    p = ppc.PerfCorpus()
    return j, p


def _doc(corpus):
    doc = corpus.document()
    doc.pop("dir")
    return doc


@pytest.mark.parametrize("seed,segment_bytes", [(0, None), (1, 4096), (2, 5000)])
def test_same_records_same_document_and_sketch(seed, segment_bytes, tmp_path, monkeypatch,
                                               clock):
    j, p = _corpora(tmp_path, monkeypatch, segment_bytes, max_segments=2)
    t0 = clock[0]
    for corpus in (j, p):  # each from the same clock reading
        clock[0] = t0
        for key, kw in _rows(seed):
            assert corpus.record(key, **kw) is True
    assert _doc(p) == _doc(j)
    if segment_bytes is not None:
        assert p.rotations == j.rotations > 0
        # retention: at most max_segments raw segments beyond the active one
        assert len(p._segment_seqs()) <= 3
    j.flush()
    p.flush()
    assert (tmp_path / "port" / "sketch.json").read_bytes() == \
        (tmp_path / "jax" / "sketch.json").read_bytes()
    assert _doc(p) == _doc(j)
    assert p.snapshot() == j.snapshot()


def test_a_thread_reading_the_wall_clock_moves_neither_corpus(tmp_path, monkeypatch, clock):
    """Another thread of the process reads ``time.time()`` in a loop while
    both corpora record, and each record waits until it has read again:
    the documents and sketches still agree, because the fixture's clock is
    read by the two corpora alone."""
    j, p = _corpora(tmp_path, monkeypatch, 4096, max_segments=2)
    reads = [0]
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            time.time()
            reads[0] += 1

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        t0 = clock[0]
        for corpus in (j, p):
            clock[0] = t0
            for key, kw in _rows(3):
                assert corpus.record(key, **kw) is True
                seen = reads[0]
                while reads[0] == seen:  # the reader reads between records
                    threading.Event().wait(1e-4)
    finally:
        stop.set()
        t.join(timeout=5)
    assert _doc(p) == _doc(j)
    j.flush()
    p.flush()
    assert (tmp_path / "port" / "sketch.json").read_bytes() == \
        (tmp_path / "jax" / "sketch.json").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_corpus_warms_the_other_package(writer, tmp_path, monkeypatch, clock):
    """Rows written by one package (some compacted into sketch.json, some
    only in the segment after the watermark) warm-start the other's
    AUTOPILOT to the keys and estimates its own warm start gives."""
    d = tmp_path / "corpus"
    monkeypatch.setenv("SELDON_TPU_CORPUS", "1")
    monkeypatch.setenv("SELDON_TPU_CORPUS_DIR", str(d))
    monkeypatch.setenv("SELDON_TPU_CORPUS_SEGMENT_BYTES", "4096")
    w = (jpc if writer == "jax" else ppc).PerfCorpus()
    for key, kw in _rows(5, 80):
        assert w.record(key, **kw)
    assert w.rotations > 0  # some history lives only in the sketch
    w._fh.close()  # the writing process ends without a clean shutdown
    readers = {"jax": jpc.PerfCorpus(), "port": ppc.PerfCorpus()}
    assert readers["port"].warm_start_autopilot() == readers["jax"].warm_start_autopilot() > 0
    pm, jm = pap.AUTOPILOT._models, jap.AUTOPILOT._models
    assert set(pm) == set(jm) and len(pm) == 5
    for k in pm:
        assert (pm[k].n, pm[k].est_s, pm[k].scale_s, pm[k].last_s) == \
            (jm[k].n, jm[k].est_s, jm[k].scale_s, jm[k].last_s)
        assert pap.AUTOPILOT.predict_s(k) == jap.AUTOPILOT.predict_s(k)
    assert pap.AUTOPILOT.warm_keys == jap.AUTOPILOT.warm_keys == 5
    assert _doc(readers["port"])["keys"] == _doc(readers["jax"])["keys"]


def test_unwritable_dir_disables_and_counts(tmp_path, monkeypatch):
    blocker = tmp_path / "a-file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("SELDON_TPU_CORPUS", "1")
    monkeypatch.setenv("SELDON_TPU_CORPUS_DIR", str(blocker / "corpus"))
    j, p = jpc.PerfCorpus(), ppc.PerfCorpus()
    for c in (j, p):
        assert c.enabled
        assert not c.record("predict[1x784/float32]", pad_bucket=1, tier="", wall_s=0.001,
                            rows=1)
        assert not c.enabled and c.io_errors == 1
        assert c.warm_start_autopilot() == 0
    assert _doc(p) == _doc(j)
    assert p.document()["io_errors"] == 1 and p.document()["enabled"] is False


def test_kill_switch_and_unset_dir_write_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("SELDON_TPU_CORPUS_DIR", raising=False)
    assert not ppc.corpus_enabled() and not jpc.corpus_enabled()
    p = ppc.PerfCorpus()
    assert not p.record("k", pad_bucket=1, tier="", wall_s=0.001, rows=1)
    assert p.warm_start_autopilot() == 0 and p.snapshot()["rows_total"] == 0
    monkeypatch.setenv("SELDON_TPU_CORPUS_DIR", str(tmp_path / "c"))
    monkeypatch.setenv("SELDON_TPU_CORPUS", "0")
    p = ppc.PerfCorpus()
    assert not p.enabled and not p.record("k", pad_bucket=1, tier="", wall_s=0.001, rows=1)
    assert not (tmp_path / "c").exists()


def _mnist_engine():
    doc = {"spec": {"name": "mnist-deployment", "predictors": [{
        "name": "main",
        "components": [{"name": "mnist", "runtime": "inprocess",
                        "class_path": "MnistClassifier",
                        "parameters": [{"name": "hidden", "value": "32", "type": "INT"}]}],
        "graph": {"name": "mnist", "type": "MODEL", "children": []}}]}}
    return EngineService(SeldonDeploymentSpec.from_json_dict(doc), device="cpu")


def test_engine_restart_is_warm(tmp_path, monkeypatch):
    """The spine's dispatch fold appends every dispatch; a second engine on
    the same directory lists the keys in /autopilot before its first
    request, and /corpus lists the rows and sketches."""
    monkeypatch.setenv("SELDON_TPU_CORPUS", "1")
    monkeypatch.setenv("SELDON_TPU_CORPUS_DIR", str(tmp_path / "c"))
    monkeypatch.setattr(ppc, "CORPUS", ppc.PerfCorpus())
    import seldon_core_tpu_torch.runtime.engine as eng_mod
    import seldon_core_tpu_torch.utils.hotrecord as hr
    monkeypatch.setattr(eng_mod, "CORPUS", ppc.CORPUS)
    monkeypatch.setattr(hr, "CORPUS", ppc.CORPUS)
    engine = _mnist_engine()
    x = np.random.default_rng(0).random((3, 784))
    body = json.dumps({"data": {"ndarray": x.tolist()}})
    try:
        for _ in range(6):
            assert asyncio.run(engine.predict_json(body))[1] == 200
        corpus = engine.corpus_document()
    finally:
        engine.close()
    assert corpus["enabled"] and corpus["rows_total"] == 6
    assert [k["key"] for k in corpus["keys"]] == ["predict[4x784/float32]"]
    assert corpus["keys"][0]["tiers"] == {"interactive": 6}
    # a restart: a fresh corpus and a fresh model in the same process
    pap.AUTOPILOT.reset()
    fresh = ppc.PerfCorpus()
    monkeypatch.setattr(eng_mod, "CORPUS", fresh)
    monkeypatch.setattr(hr, "CORPUS", fresh)
    engine = _mnist_engine()
    try:
        doc = engine.autopilot_document()
        assert [r["key"] for r in doc["keys"]] == ["predict[4x784/float32]"]
        assert doc["keys"][0]["samples"] == 6 and doc["keys"][0]["trusted"]
        assert engine.stats()["autopilot"]["warm_keys"] == 1
        assert engine.corpus_document()["warm_keys"] == 1
    finally:
        engine.close()
