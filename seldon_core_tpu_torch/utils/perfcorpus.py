"""Durable perf corpus — the port's counterpart of
``seldon_core_tpu/utils/perfcorpus.py``: the on-disk ledger behind a warm
autopilot.

The spine's rings, the perf observatory's reservoirs and the autopilot's
table live in process memory; this corpus keeps what they learned across a
restart:

  * **One compact row per dispatch**, appended by the spine's drainer fold
    (``utils/hotrecord.py``): the executable key, the pad bucket, the QoS
    tier, the observatory's static cost features (FLOPs, bytes) and the
    measured wall.  The write rides the fold, never the dispatch path.
  * **Size-bounded segments and compacted sketches.**  Rows append to
    ``corpus-<seq>.jsonl``; past ``SELDON_TPU_CORPUS_SEGMENT_BYTES`` the
    segment rotates: the per-key sketches (a bounded ring of recent walls)
    persist atomically to ``sketch.json`` with a ``compacted_through``
    watermark, and raw segments beyond ``SELDON_TPU_CORPUS_MAX_SEGMENTS``
    are unlinked.
  * **Restart warm-start.**  At boot the corpus loads ``sketch.json``,
    replays only the segments newer than the watermark, and seeds the
    autopilot (``Autopilot.warm_start``), so a restarted engine prices the
    keys it has seen before its first dispatch.
  * ``GET /corpus`` is the per-key sketch table.

The file format is the JAX package's, field for field, so a directory that
either package wrote warms the other.  The corpus is per process: point
each engine at its own ``SELDON_TPU_CORPUS_DIR`` (unset disables it;
``SELDON_TPU_CORPUS=0`` is the kill switch with the directory still set).
Every file write happens on the drainer thread under the corpus lock; an
I/O error disables the corpus for the process (counted in ``io_errors``,
logged once) rather than wedging the drain behind a sick disk."""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["CORPUS", "PerfCorpus", "corpus_enabled"]

logger = logging.getLogger(__name__)

_SKETCH_FILE = "sketch.json"
_SEGMENT_PREFIX = "corpus-"
_SEGMENT_SUFFIX = ".jsonl"
#: per-key recent-wall sample ring — enough for stable p50/p90 reads
#: while keeping sketch.json O(keys), not O(dispatches)
_SAMPLE_CAP = 64


def corpus_enabled() -> bool:
    """On only when a directory is configured AND the kill switch is not
    thrown — the same off-unless-configured posture as the audit log."""
    if os.environ.get("SELDON_TPU_CORPUS", "1") == "0":
        return False
    return bool(os.environ.get("SELDON_TPU_CORPUS_DIR", "").strip())


def _env_int(name: str, default: int) -> int:
    try:
        return int(float(os.environ.get(name, "") or default))
    except ValueError:
        return default


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


class _KeySketch:
    """Compacted history of one (executable, pad-bucket) key: lifetime
    count, a bounded ring of recent measured walls (the quantile
    sketch), last static cost features and a tier census."""

    __slots__ = ("key", "n", "samples", "ring_pos", "pad_bucket",
                 "flops", "bytes_accessed", "tiers", "last_s", "last_ts")

    def __init__(self, key: str):
        self.key = key
        self.n = 0
        self.samples: List[float] = []
        self.ring_pos = 0
        self.pad_bucket = 0
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.tiers: Dict[str, int] = {}
        self.last_s = 0.0
        self.last_ts = 0.0

    def fold(self, pad_bucket: int, tier: str, flops: float,
             bytes_accessed: float, wall_s: float, ts: float) -> None:
        self.n += 1
        if len(self.samples) < _SAMPLE_CAP:
            self.samples.append(wall_s)
        else:
            self.samples[self.ring_pos] = wall_s
            self.ring_pos = (self.ring_pos + 1) % _SAMPLE_CAP
        if pad_bucket:
            self.pad_bucket = pad_bucket
        if flops:
            self.flops = flops
        if bytes_accessed:
            self.bytes_accessed = bytes_accessed
        if tier and len(self.tiers) < 8:
            self.tiers[tier] = self.tiers.get(tier, 0) + 1
        elif tier in self.tiers:
            self.tiers[tier] += 1
        self.last_s = wall_s
        self.last_ts = ts

    def quantiles(self) -> Dict[str, float]:
        vals = sorted(self.samples)
        return {
            "p50": _quantile(vals, 0.50),
            "p90": _quantile(vals, 0.90),
            "p99": _quantile(vals, 0.99),
        }

    def spread_s(self) -> float:
        """Median absolute deviation around p50 — the warm-start seed
        for the autopilot's EWMA scale estimate."""
        vals = sorted(self.samples)
        if not vals:
            return 0.0
        p50 = _quantile(vals, 0.50)
        dev = sorted(abs(v - p50) for v in vals)
        return _quantile(dev, 0.50)

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "n": self.n,
            "samples": [round(s, 9) for s in self.samples],
            "pad_bucket": self.pad_bucket,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "tiers": dict(self.tiers),
            "last_s": self.last_s,
            "last_ts": self.last_ts,
        }

    @classmethod
    def from_json_dict(cls, key: str, doc: Dict[str, Any]) -> "_KeySketch":
        sk = cls(key)
        sk.n = int(doc.get("n", 0))
        sk.samples = [float(s) for s in doc.get("samples", [])][:_SAMPLE_CAP]
        sk.pad_bucket = int(doc.get("pad_bucket", 0))
        sk.flops = float(doc.get("flops", 0.0))
        sk.bytes_accessed = float(doc.get("bytes_accessed", 0.0))
        sk.tiers = {
            str(k): int(v) for k, v in (doc.get("tiers") or {}).items()
        }
        sk.last_s = float(doc.get("last_s", 0.0))
        sk.last_ts = float(doc.get("last_ts", 0.0))
        return sk


class PerfCorpus:
    """Process-global durable dispatch ledger.  ``record`` is called
    ONLY from the spine's drainer fold (already serialized under the
    drain lock); loads, documents and gauge publishes take the corpus
    lock so any thread can read."""

    #: bounded key census — an exploding shape set must not grow the
    #: sketch file without limit; keys beyond the cap are dropped
    #: (counted) exactly like the autopilot's MAX_KEYS rule
    MAX_KEYS = 512

    def __init__(self):
        self._lock = threading.RLock()
        self.reconfigure()

    # -- configuration -----------------------------------------------------

    def reconfigure(self) -> None:
        """Re-read the environment and drop all in-memory state (tests
        and the corpus demo flip env between 'processes'; production
        calls this once via import)."""
        with self._lock:
            fh = getattr(self, "_fh", None)
            if fh is not None:
                try:
                    fh.close()
                except Exception:  # noqa: BLE001
                    pass
            self.dir = os.environ.get(
                "SELDON_TPU_CORPUS_DIR", "").strip()
            self.segment_bytes = max(
                _env_int("SELDON_TPU_CORPUS_SEGMENT_BYTES", 262144), 4096)
            self.max_segments = max(
                _env_int("SELDON_TPU_CORPUS_MAX_SEGMENTS", 4), 1)
            self._sketches: Dict[str, _KeySketch] = {}
            self._fh = None
            self._seq = 0
            self._active_bytes = 0
            self._compacted_through = 0
            self._loaded = False
            self._warmed = False
            self._broken = False
            self.rows_total = 0
            self.rotations = 0
            self.keys_capped = 0
            self.io_errors = 0
            self.skipped_rows = 0
            self.warm_keys = 0

    @property
    def enabled(self) -> bool:
        return corpus_enabled() and not self._broken

    # -- disk layout -------------------------------------------------------

    def _segment_path(self, seq: int) -> str:
        return os.path.join(
            self.dir, f"{_SEGMENT_PREFIX}{seq:06d}{_SEGMENT_SUFFIX}")

    def _segment_seqs(self) -> List[int]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        seqs = []
        for name in names:
            if (name.startswith(_SEGMENT_PREFIX)
                    and name.endswith(_SEGMENT_SUFFIX)):
                try:
                    seqs.append(int(
                        name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(seqs)

    def disk_bytes(self) -> int:
        total = 0
        for seq in self._segment_seqs():
            try:
                total += os.path.getsize(self._segment_path(seq))
            except OSError:
                pass
        try:
            total += os.path.getsize(os.path.join(self.dir, _SKETCH_FILE))
        except OSError:
            pass
        return total

    def _fail(self, what: str, exc: Exception) -> None:
        """One sick disk must not wedge the drain: disable and count."""
        self.io_errors += 1
        if not self._broken:
            logger.warning("perf corpus disabled (%s): %s", what, exc)
        self._broken = True

    # -- load / replay -----------------------------------------------------

    def _ensure_loaded(self) -> bool:
        """Load sketch.json + replay post-watermark segments once per
        (re)configuration.  Malformed lines and a corrupt sketch file
        are skipped (counted) — the corrupt-corpus runbook in
        docs/operations.md is 'delete the file, lose only history'."""
        if self._loaded:
            return True
        if not self.enabled:
            return False
        try:
            os.makedirs(self.dir, exist_ok=True)
        except OSError as exc:
            self._fail("mkdir", exc)
            return False
        sketch_path = os.path.join(self.dir, _SKETCH_FILE)
        if os.path.exists(sketch_path):
            try:
                with open(sketch_path) as f:
                    doc = json.load(f)
                self._compacted_through = int(
                    doc.get("compacted_through", 0))
                for key, ent in (doc.get("keys") or {}).items():
                    if len(self._sketches) >= self.MAX_KEYS:
                        break
                    self._sketches[key] = _KeySketch.from_json_dict(
                        key, ent)
            except Exception:  # noqa: BLE001 - corrupt sketch = no history
                self.skipped_rows += 1
                self._compacted_through = 0
                self._sketches = {}
        seqs = self._segment_seqs()
        for seq in seqs:
            if seq <= self._compacted_through:
                continue
            try:
                with open(self._segment_path(seq)) as f:
                    for line in f:
                        self._replay_line(line)
            except OSError:
                continue
        self._seq = (seqs[-1] + 1) if seqs else 1
        try:
            self._fh = open(self._segment_path(self._seq), "a")
            self._active_bytes = self._fh.tell()
        except OSError as exc:
            self._fail("open segment", exc)
            return False
        self._loaded = True
        return True

    def _replay_line(self, line: str) -> None:
        line = line.strip()
        if not line:
            return
        try:
            row = json.loads(line)
            key = row["k"]
        except Exception:  # noqa: BLE001 - torn tail line after a crash
            self.skipped_rows += 1
            return
        sk = self._sketch_for(key)
        if sk is None:
            return
        sk.fold(int(row.get("pb", 0)), str(row.get("tier", "")),
                float(row.get("fl", 0.0)), float(row.get("by", 0.0)),
                float(row.get("w", 0.0)), float(row.get("ts", 0.0)))

    def _sketch_for(self, key: str) -> Optional[_KeySketch]:
        sk = self._sketches.get(key)
        if sk is None:
            if len(self._sketches) >= self.MAX_KEYS:
                self.keys_capped += 1
                return None
            sk = self._sketches[key] = _KeySketch(key)
        return sk

    # -- the write path (drainer fold only) --------------------------------

    def record(self, key: str, *, pad_bucket: int, tier: str,
               wall_s: float, rows: int,
               features: Optional[Dict[str, float]] = None) -> bool:
        """Append one dispatch row and fold it into the key's sketch.
        Called from the spine drainer's HOP_DISPATCH fold — never from a
        serving thread — so the file write is off-path by construction."""
        if not key or wall_s <= 0:
            return False
        with self._lock:
            if not self._ensure_loaded():
                return False
            ts = time.time()
            flops = float((features or {}).get("flops", 0.0) or 0.0)
            nbytes = float(
                (features or {}).get("bytes_accessed", 0.0) or 0.0)
            row = {
                "k": key, "pb": int(pad_bucket), "tier": tier or "",
                "fl": flops, "by": nbytes, "r": int(rows),
                "w": round(float(wall_s), 9), "ts": round(ts, 3),
            }
            try:
                line = json.dumps(row, separators=(",", ":")) + "\n"
                self._fh.write(line)
                # flush the userspace buffer (no fsync): a crash loses at
                # most the OS page cache, and a sibling reader (restart
                # replay, tests) sees every appended row.  Off-path — the
                # drainer is the only writer
                self._fh.flush()
                self._active_bytes += len(line)
            except Exception as exc:  # noqa: BLE001
                self._fail("append", exc)
                return False
            self.rows_total += 1
            sk = self._sketch_for(key)
            if sk is not None:
                sk.fold(int(pad_bucket), tier or "", flops, nbytes,
                        float(wall_s), ts)
            if self._active_bytes >= self.segment_bytes:
                self._rotate()
            return True

    def _rotate(self) -> None:
        """Close the active segment, persist the sketches with the
        watermark advanced past it, and drop raw segments beyond the
        retention window — this is the ONLY place disk shrinks, and it
        always persists before it prunes (no row is ever only in a file
        that just got unlinked)."""
        try:
            self._fh.flush()
            self._fh.close()
        except Exception:  # noqa: BLE001
            pass
        self._compacted_through = self._seq
        self._persist_sketches()
        seqs = self._segment_seqs()
        for seq in seqs[:-self.max_segments] if (
                len(seqs) > self.max_segments) else []:
            try:
                os.unlink(self._segment_path(seq))
            except OSError:
                pass
        self._seq += 1
        try:
            self._fh = open(self._segment_path(self._seq), "a")
            self._active_bytes = 0
            self.rotations += 1
        except OSError as exc:
            self._fail("rotate", exc)

    def _persist_sketches(self) -> None:
        """Atomic tmp+rename write of sketch.json."""
        path = os.path.join(self.dir, _SKETCH_FILE)
        tmp = path + ".tmp"
        doc = {
            "version": 1,
            "compacted_through": self._compacted_through,
            "keys": {
                k: sk.to_json_dict() for k, sk in self._sketches.items()
            },
        }
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, separators=(",", ":"))
            os.replace(tmp, path)
        except OSError as exc:
            self._fail("persist sketches", exc)

    def flush(self) -> None:
        """Force a rotation (tests + the corpus demo's 'clean shutdown'):
        everything in memory reaches sketch.json."""
        with self._lock:
            if self._loaded and self._fh is not None:
                self._rotate()

    # -- restart warm-start ------------------------------------------------

    def warm_start_autopilot(self) -> int:
        """Seed the process-global autopilot from the corpus — called
        once per process at engine boot (idempotent; re-armed by
        ``reconfigure``).  Returns the number of keys seeded."""
        with self._lock:
            if self._warmed:
                return self.warm_keys
            self._warmed = True
            if not self._ensure_loaded():
                return 0
            entries = []
            for sk in self._sketches.values():
                if sk.n <= 0 or not sk.samples:
                    continue
                q = sk.quantiles()
                entries.append({
                    "key": sk.key,
                    "n": sk.n,
                    "est_s": q["p50"],
                    "scale_s": sk.spread_s(),
                    "last_s": sk.last_s,
                })
            if not entries:
                return 0
        from seldon_core_tpu_torch.runtime.autopilot import AUTOPILOT

        seeded = AUTOPILOT.warm_start(entries)
        with self._lock:
            self.warm_keys = seeded
        return seeded

    # -- surfaces ----------------------------------------------------------

    def publish_gauges(self) -> None:
        """seldon_tpu_corpus_{rows,bytes,warm_keys} — called from the
        spine's throttled gauge refresh, never per-row."""
        from seldon_core_tpu_torch.utils.telemetry import RECORDER

        with self._lock:
            if not self.enabled or not self._loaded:
                return
            RECORDER.set_corpus(
                rows=self.rows_total,
                disk_bytes=self.disk_bytes(),
                warm_keys=self.warm_keys,
            )

    def document(self) -> Dict[str, Any]:
        """The ``GET /corpus`` body: knobs, disk layout, and the per-key
        sketch table (the training substrate for ROADMAP item 4)."""
        with self._lock:
            loaded = self._ensure_loaded()
            keys: List[Dict[str, Any]] = []
            for sk in self._sketches.values():
                q = sk.quantiles()
                keys.append({
                    "key": sk.key,
                    "n": sk.n,
                    "pad_bucket": sk.pad_bucket,
                    "p50_ms": round(q["p50"] * 1e3, 4),
                    "p90_ms": round(q["p90"] * 1e3, 4),
                    "p99_ms": round(q["p99"] * 1e3, 4),
                    "spread_ms": round(sk.spread_s() * 1e3, 4),
                    "flops": sk.flops,
                    "bytes_accessed": sk.bytes_accessed,
                    "tiers": dict(sk.tiers),
                    "last_ms": round(sk.last_s * 1e3, 4),
                    "last_ts": round(sk.last_ts, 3),
                })
            keys.sort(key=lambda r: r["n"], reverse=True)
            segments = []
            if loaded:
                for seq in self._segment_seqs():
                    try:
                        size = os.path.getsize(self._segment_path(seq))
                    except OSError:
                        size = 0
                    segments.append({"seq": seq, "bytes": size})
            return {
                "enabled": self.enabled,
                "dir": self.dir or None,
                "knobs": {
                    "kill_switch": "SELDON_TPU_CORPUS",
                    "dir": "SELDON_TPU_CORPUS_DIR",
                    "segment_bytes": self.segment_bytes,
                    "max_segments": self.max_segments,
                    "max_keys": self.MAX_KEYS,
                },
                "rows_total": self.rows_total,
                "disk_bytes": self.disk_bytes() if loaded else 0,
                "segments": segments,
                "compacted_through": self._compacted_through,
                "rotations": self.rotations,
                "warm_keys": self.warm_keys,
                "keys_capped": self.keys_capped,
                "skipped_rows": self.skipped_rows,
                "io_errors": self.io_errors,
                "keys": keys,
            }

    def snapshot(self) -> Dict[str, Any]:
        """Compact health block — the full table lives on /corpus."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "rows_total": self.rows_total,
                "keys": len(self._sketches),
                "warm_keys": self.warm_keys,
            }


CORPUS = PerfCorpus()
