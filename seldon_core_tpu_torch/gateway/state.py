"""Shared gateway state — tokens and registrations that survive replicas;
the port's copy of ``seldon_core_tpu/gateway/state.py`` with the same
schema and row encoding, so a JAX gateway and a port gateway can share one
``GATEWAY_STATE_PATH`` file (tokens, registrations, leases, peers and burn
rows written by either are read by the other).

The reference gateway keeps OAuth tokens in Redis so any apife replica can
validate a token issued by another (api-frontend
config/RedisConfig.java, TokenStore wiring); deployment registrations
arrive via the cluster-manager and live in each replica's memory.

This module is that role without an external broker: a single sqlite file
(on a shared volume) in WAL mode holds both tables, and
:class:`SqliteDeploymentStore` is a drop-in for
:class:`~seldon_core_tpu_torch.gateway.apife.DeploymentStore` — same methods,
same AuthError semantics, same TTL — so ``ApiGateway`` works unchanged
with N replicas pointed at one ``GATEWAY_STATE_PATH``.

Registrations persisted here reference engines by URL (remote dispatch);
in-process EngineService objects are inherently per-replica and stay with
the in-memory store.
"""

from __future__ import annotations

import contextlib
import json
import secrets
import sqlite3
import threading
import time
from typing import Dict, List, Optional, Tuple

from seldon_core_tpu_torch.gateway.apife import (
    TOKEN_TTL_S,
    AuthError,
    _Registration,
)
from seldon_core_tpu_torch.gateway.shadow import (
    ShadowConfig,
    shadow_config_from_spec,
)
from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec

__all__ = ["SqliteDeploymentStore", "StaleFenceError"]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS registrations (
    oauth_key TEXT PRIMARY KEY,
    deployment_id TEXT NOT NULL,
    oauth_secret TEXT NOT NULL,
    engines_json TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS tokens (
    token TEXT PRIMARY KEY,
    oauth_key TEXT NOT NULL,
    expiry REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS tokens_by_key ON tokens(oauth_key);
CREATE TABLE IF NOT EXISTS meta (
    k TEXT PRIMARY KEY,
    v INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS leases (
    name TEXT PRIMARY KEY,
    holder TEXT NOT NULL,
    token INTEGER NOT NULL,
    expires REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS engine_leases (
    url TEXT PRIMARY KEY,
    boot_id TEXT NOT NULL,
    expires REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS gateway_peers (
    replica_id TEXT PRIMARY KEY,
    base_url TEXT NOT NULL,
    expires REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS burn_deltas (
    replica_id TEXT NOT NULL,
    scope TEXT NOT NULL,
    window TEXT NOT NULL,
    total INTEGER NOT NULL,
    slow INTEGER NOT NULL,
    errors INTEGER NOT NULL,
    throttled INTEGER NOT NULL,
    shed INTEGER NOT NULL,
    updated REAL NOT NULL,
    PRIMARY KEY (replica_id, scope, window)
);
"""

#: how many times a write transaction retries when another gateway
#: replica holds the sqlite write lock, and the base of the backoff
#: (full jitter on top; total worst-case wait ~= 2s, far beyond any
#: real contention window for a WAL-mode file on a shared volume)
_BUSY_RETRIES = 6
_BUSY_BACKOFF_S = 0.03


class StaleFenceError(RuntimeError):
    """A fenced write carried a fencing token that is no longer the
    lease's current token — the caller lost the lease (paused past its
    TTL, another replica took over) and MUST NOT mutate shared state."""

# bumped inside the same transaction as the registration write, so every
# gateway replica sharing the file observes other replicas' changes too
_BUMP_REVISION = (
    "INSERT INTO meta VALUES ('revision', 1) "
    "ON CONFLICT(k) DO UPDATE SET v = v + 1"
)


class SqliteDeploymentStore:
    """DeploymentStore drop-in over a shared sqlite file."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        # isolation_level=None -> autocommit: transactions are explicit
        # (BEGIN IMMEDIATE in _write) so a multi-statement writer holds
        # the write lock for exactly its own span and nothing implicit
        # lingers between calls
        self._conn = sqlite3.connect(
            path, check_same_thread=False, isolation_level=None)
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            # first line of defense against a sibling replica's write
            # lock; the _write retry loop is the second
            self._conn.execute("PRAGMA busy_timeout=200")
            self._conn.executescript(_SCHEMA)

    @contextlib.contextmanager
    def _write(self):
        """One IMMEDIATE write transaction with SQLITE_BUSY retry.

        BEGIN IMMEDIATE takes the write lock up front, so two gateway
        replicas racing ``set_weights``/``register`` serialize at BEGIN
        instead of failing mid-transaction on the first write.  A busy
        BEGIN (the other replica holds the lock past busy_timeout) is
        retried with linear backoff + full jitter rather than surfacing
        a raw OperationalError to the caller."""
        with self._lock:
            last: Optional[Exception] = None
            for attempt in range(_BUSY_RETRIES):
                try:
                    self._conn.execute("BEGIN IMMEDIATE")
                except sqlite3.OperationalError as e:
                    msg = str(e).lower()
                    if "locked" not in msg and "busy" not in msg:
                        raise
                    last = e
                    time.sleep(_BUSY_BACKOFF_S * (attempt + 1)
                               * (0.5 + secrets.randbelow(512) / 1024))
                    continue
                try:
                    yield self._conn
                except BaseException:
                    self._conn.execute("ROLLBACK")
                    raise
                self._conn.execute("COMMIT")
                return
            raise last  # type: ignore[misc]

    # -- registrations -----------------------------------------------------

    def register(self, spec: SeldonDeploymentSpec,
                 engines: Dict[str, object]) -> None:
        """``engines``: predictor name -> engine base URL, or a LIST of
        endpoint specs (a replica set the gateway balances over with
        power-of-two-choices — gateway/balancer.py).  Shared state can
        only carry references another replica can dial, so in-process
        engines are rejected in either form."""
        shadow = shadow_config_from_spec(spec)
        weighted = []
        for p in spec.predictors:
            if p.name in engines:
                engine = engines[p.name]
                if isinstance(engine, (list, tuple)):
                    if not engine or not all(
                        isinstance(u, str) for u in engine
                    ):
                        raise TypeError(
                            "a replica set must be a non-empty list of "
                            "endpoint spec strings"
                        )
                    engine = [str(u) for u in engine]
                elif not isinstance(engine, str):
                    raise TypeError(
                        "SqliteDeploymentStore carries engine URLs; "
                        "in-process engines are per-replica "
                        "(use the in-memory DeploymentStore)"
                    )
                # same shadow contract as the in-memory store: an
                # annotated shadow predictor serves weight-0 live traffic
                weight = (
                    0 if shadow is not None and p.name == shadow.predictor
                    else max(int(p.replicas), 0)
                )
                weighted.append((p.name, weight, engine))
        if not weighted:
            raise ValueError(
                f"no engines supplied for deployment {spec.name!r}"
            )
        if shadow is not None and shadow.predictor not in (
            w[0] for w in weighted
        ):
            shadow = None
        key = spec.oauth_key or spec.name
        # wrapped form carries the shadow policy alongside the engines;
        # the reader accepts the bare-list form older rows persisted
        doc = {
            "engines": weighted,
            "shadow": None if shadow is None else shadow.to_json_dict(),
        }
        with self._write() as conn:
            conn.execute(
                "INSERT OR REPLACE INTO registrations VALUES (?, ?, ?, ?)",
                (key, spec.name, spec.oauth_secret, json.dumps(doc)),
            )
            conn.execute(_BUMP_REVISION)

    @staticmethod
    def _set_weights_in(conn, deployment_id: str, weights) -> None:
        """The set_weights body, run inside an already-open write
        transaction (shared by the plain and fenced entry points)."""
        row = conn.execute(
            "SELECT oauth_key, engines_json FROM registrations "
            "WHERE deployment_id = ?",
            (deployment_id,),
        ).fetchone()
        if row is None:
            raise KeyError(
                f"deployment not registered: {deployment_id!r}"
            )
        key, engines_json = row
        doc = json.loads(engines_json)
        engines = doc["engines"] if isinstance(doc, dict) else doc
        known = {e[0] for e in engines}
        unknown = set(weights) - known
        if unknown:
            raise KeyError(
                f"unknown predictors for {deployment_id!r}: "
                f"{sorted(unknown)}"
            )
        engines = [
            [name, max(int(weights.get(name, w)), 0), engine]
            for name, w, engine in engines
        ]
        if isinstance(doc, dict):
            doc["engines"] = engines
        else:
            doc = engines
        conn.execute(
            "UPDATE registrations SET engines_json = ? "
            "WHERE oauth_key = ?",
            (json.dumps(doc), key),
        )
        conn.execute(_BUMP_REVISION)

    def set_weights(self, deployment_id: str, weights) -> None:
        """Reassign one deployment's live traffic split in place — the
        rollout controller's lever, same semantics as the in-memory
        store's ``set_weights`` (unknown predictors are a typed error);
        the revision bump propagates the change to every gateway replica
        sharing the file."""
        with self._write() as conn:
            self._set_weights_in(conn, deployment_id, weights)

    def fenced_set_weights(self, deployment_id: str, weights, *,
                           lease: str, holder: str, token: int) -> None:
        """``set_weights`` guarded by a fencing check INSIDE the same
        write transaction: the caller must still be the named lease's
        current holder at its current token.  An ex-coordinator that was
        paused past its TTL (GC stall, SIGSTOP) and resumed with a stale
        token gets :class:`StaleFenceError` instead of clobbering the
        new coordinator's traffic split."""
        with self._write() as conn:
            row = conn.execute(
                "SELECT holder, token, expires FROM leases WHERE name = ?",
                (lease,),
            ).fetchone()
            if (row is None or row[0] != holder
                    or int(row[1]) != int(token)
                    or float(row[2]) <= time.time()):
                raise StaleFenceError(
                    f"lease {lease!r}: fencing token {token} for "
                    f"{holder!r} is stale (current: {row!r})"
                )
            self._set_weights_in(conn, deployment_id, weights)

    def weights(self, deployment_id: str) -> Dict[str, int]:
        """The live traffic split by predictor name (read side of
        ``set_weights`` — same contract as the in-memory store's)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT engines_json FROM registrations "
                "WHERE deployment_id = ?",
                (deployment_id,),
            ).fetchone()
        if row is None:
            raise KeyError(f"deployment not registered: {deployment_id!r}")
        doc = json.loads(row[0])
        engines = doc["engines"] if isinstance(doc, dict) else doc
        return {e[0]: int(e[1]) for e in engines}

    def unregister(self, oauth_key: str) -> None:
        with self._write() as conn:
            conn.execute(
                "DELETE FROM registrations WHERE oauth_key = ?", (oauth_key,)
            )
            conn.execute(
                "DELETE FROM tokens WHERE oauth_key = ?", (oauth_key,)
            )
            conn.execute(_BUMP_REVISION)

    def revision(self) -> int:
        """Monotone registration-change counter shared through the sqlite
        file — bumps on every register/unregister by ANY gateway replica,
        including same-deployment re-registrations (the gateway's prune
        gate reads this instead of diffing deployment IDs)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM meta WHERE k = 'revision'"
            ).fetchone()
        return int(row[0]) if row else 0

    def _registration(self, oauth_key: str):
        with self._lock:
            row = self._conn.execute(
                "SELECT deployment_id, oauth_secret, engines_json "
                "FROM registrations WHERE oauth_key = ?",
                (oauth_key,),
            ).fetchone()
        if row is None:
            return None
        doc = json.loads(row[2])
        if isinstance(doc, dict):
            engines, shadow = doc["engines"], doc.get("shadow")
        else:  # bare-list rows persisted before the shadow field existed
            engines, shadow = doc, None
        return _Registration(
            deployment_id=row[0],
            oauth_key=oauth_key,
            oauth_secret=row[1],
            engines=[tuple(e) for e in engines],
            shadow=(
                None if shadow is None
                else ShadowConfig.from_json_dict(shadow)
            ),
        )

    # -- auth --------------------------------------------------------------

    def issue_token(self, oauth_key: str, oauth_secret: str) -> str:
        reg = self._registration(oauth_key)
        if reg is None or (reg.oauth_secret
                           and reg.oauth_secret != oauth_secret):
            raise AuthError("invalid client credentials")
        token = secrets.token_urlsafe(24)
        now = time.time()
        with self._write() as conn:
            # expired rows are evicted on the write path (the same lazy
            # policy the in-memory store uses)
            conn.execute("DELETE FROM tokens WHERE expiry <= ?", (now,))
            conn.execute(
                "INSERT INTO tokens VALUES (?, ?, ?)",
                (token, oauth_key, now + TOKEN_TTL_S),
            )
        return token

    def principal_for_token(self, token: str) -> _Registration:
        with self._lock:
            row = self._conn.execute(
                "SELECT oauth_key, expiry FROM tokens WHERE token = ?",
                (token,),
            ).fetchone()
        if row is None:
            raise AuthError("invalid token")
        key, expiry = row
        if time.time() > expiry:
            with self._write() as conn:
                conn.execute(
                    "DELETE FROM tokens WHERE token = ?", (token,)
                )
            raise AuthError("token expired")
        reg = self._registration(key)
        if reg is None:
            raise AuthError("client no longer registered")
        return reg

    def deployments(self) -> List[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT deployment_id FROM registrations ORDER BY oauth_key"
            ).fetchall()
        return [r[0] for r in rows]

    def active_token_count(self) -> int:
        """Unexpired issued tokens — the /stats ``active_tokens`` gauge
        (ApiGateway.stats reads this off whichever store it was built
        with; the sqlite store counts live rows, mirroring the in-memory
        store's lazy-eviction semantics)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT COUNT(*) FROM tokens WHERE expiry > ?",
                (time.time(),),
            ).fetchone()
        return int(row[0])

    # ApiGateway._resolve peeks at _by_key when auth is disabled; present
    # the same mapping view lazily
    @property
    def _by_key(self) -> Dict[str, _Registration]:
        with self._lock:
            keys = [r[0] for r in self._conn.execute(
                "SELECT oauth_key FROM registrations"
            ).fetchall()]
        return {k: self._registration(k) for k in keys}

    # -- coordinator leases (gateway/federation.py) ------------------------

    def acquire_lease(self, name: str, holder: str,
                      ttl_s: float) -> Optional[int]:
        """Claim or renew the named lease; returns the fencing token if
        ``holder`` now holds it, None if another live holder does.

        The token is a monotone integer that bumps on every CHANGE of
        tenure (fresh claim, takeover of an expired lease) and stays
        fixed across renewals by the same holder — so any write fenced
        on an old token is rejectable forever, while a healthy
        coordinator's heartbeat doesn't invalidate its own writes."""
        now = time.time()
        with self._write() as conn:
            row = conn.execute(
                "SELECT holder, token, expires FROM leases WHERE name = ?",
                (name,),
            ).fetchone()
            if row is None:
                conn.execute(
                    "INSERT INTO leases VALUES (?, ?, 1, ?)",
                    (name, holder, now + ttl_s),
                )
                return 1
            cur_holder, cur_token, expires = row
            if cur_holder == holder and float(expires) > now:
                conn.execute(
                    "UPDATE leases SET expires = ? WHERE name = ?",
                    (now + ttl_s, name),
                )
                return int(cur_token)
            if float(expires) <= now:
                # expired — ANY caller may take over; tenure changes, so
                # the token bumps even if the holder name is the same
                # (a restarted process must not inherit its dead
                # predecessor's fence)
                conn.execute(
                    "UPDATE leases SET holder = ?, token = token + 1, "
                    "expires = ? WHERE name = ?",
                    (holder, now + ttl_s, name),
                )
                return int(cur_token) + 1
            return None

    def release_lease(self, name: str, holder: str, token: int) -> None:
        """Voluntary release (graceful shutdown) — a no-op unless the
        caller still holds the lease at its current token."""
        with self._write() as conn:
            conn.execute(
                "DELETE FROM leases WHERE name = ? AND holder = ? "
                "AND token = ?",
                (name, holder, int(token)),
            )

    def lease(self, name: str) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT holder, token, expires FROM leases WHERE name = ?",
                (name,),
            ).fetchone()
        if row is None:
            return None
        return {"holder": row[0], "token": int(row[1]),
                "expires": float(row[2])}

    # -- engine liveness leases (runtime/engine_main.py heartbeats,
    #    gateway/balancer.py reads) ----------------------------------------

    def heartbeat_engine(self, url: str, boot_id: str,
                         ttl_s: float) -> None:
        with self._write() as conn:
            conn.execute(
                "INSERT INTO engine_leases VALUES (?, ?, ?) "
                "ON CONFLICT(url) DO UPDATE SET boot_id = excluded.boot_id, "
                "expires = excluded.expires",
                (url, boot_id, time.time() + ttl_s),
            )

    def drop_engine(self, url: str) -> None:
        """Graceful deregistration: the engine's lease disappears
        immediately instead of lapsing a TTL later."""
        with self._write() as conn:
            conn.execute(
                "DELETE FROM engine_leases WHERE url = ?", (url,)
            )

    def live_engines(self) -> Dict[str, Tuple[str, float]]:
        """url -> (boot_id, expires) for every UNEXPIRED engine lease.
        An engine that ever heartbeated and is absent here is dead (or
        drained) as far as the balancer is concerned."""
        now = time.time()
        with self._lock:
            rows = self._conn.execute(
                "SELECT url, boot_id, expires FROM engine_leases "
                "WHERE expires > ?",
                (now,),
            ).fetchall()
        return {r[0]: (r[1], float(r[2])) for r in rows}

    def engine_leases(self) -> Dict[str, Tuple[str, float]]:
        """ALL engine leases, lapsed included — url -> (boot_id,
        expires); the balancer distinguishes "lease lapsed" (dead) from
        "never leased" (liveness unknown, fall back to scrape health)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT url, boot_id, expires FROM engine_leases"
            ).fetchall()
        return {r[0]: (r[1], float(r[2])) for r in rows}

    # -- gateway peer directory (the /fleet federation surface) ------------

    def heartbeat_peer(self, replica_id: str, base_url: str,
                       ttl_s: float) -> None:
        with self._write() as conn:
            conn.execute(
                "INSERT INTO gateway_peers VALUES (?, ?, ?) "
                "ON CONFLICT(replica_id) DO UPDATE SET "
                "base_url = excluded.base_url, expires = excluded.expires",
                (replica_id, base_url, time.time() + ttl_s),
            )

    def drop_peer(self, replica_id: str) -> None:
        with self._write() as conn:
            conn.execute(
                "DELETE FROM gateway_peers WHERE replica_id = ?",
                (replica_id,),
            )

    def peers(self, exclude: Optional[str] = None) -> List[Tuple[str, str]]:
        """Unexpired gateway replicas as (replica_id, base_url)."""
        now = time.time()
        with self._lock:
            rows = self._conn.execute(
                "SELECT replica_id, base_url FROM gateway_peers "
                "WHERE expires > ? ORDER BY replica_id",
                (now,),
            ).fetchall()
        return [(r[0], r[1]) for r in rows if r[0] != exclude]

    # -- federated SLO/QoS burn deltas (fleet-truth accounting) ------------

    def publish_burn(self, replica_id: str, rows) -> None:
        """Upsert one replica's burn deltas in ONE write transaction
        (same BEGIN IMMEDIATE + busy-retry discipline as every other
        shared-state write).  Each row is ``(scope, window, total, slow,
        errors, throttled, shed)`` — absolute current-window counts, so
        a replica's LAST publish stays meaningful after it dies (the
        fold keeps reading it until the window ages it out: no burn
        amnesia on failover)."""
        now = time.time()
        with self._write() as conn:
            for scope, window, total, slow, errors, throttled, shed in rows:
                conn.execute(
                    "INSERT INTO burn_deltas VALUES "
                    "(?, ?, ?, ?, ?, ?, ?, ?, ?) "
                    "ON CONFLICT(replica_id, scope, window) DO UPDATE SET "
                    "total = excluded.total, slow = excluded.slow, "
                    "errors = excluded.errors, "
                    "throttled = excluded.throttled, "
                    "shed = excluded.shed, updated = excluded.updated",
                    (replica_id, str(scope), str(window), int(total),
                     int(slow), int(errors), int(throttled), int(shed),
                     now),
                )

    def burn_rows(self, max_age_s: Optional[float] = None) -> List[Dict]:
        """Every replica's last published deltas (optionally bounded by
        age) — the fold side of fleet-truth burn.  Dead replicas' rows
        are INCLUDED by design; the per-window age mask in the fold is
        what retires them."""
        now = time.time()
        with self._lock:
            rows = self._conn.execute(
                "SELECT replica_id, scope, window, total, slow, errors, "
                "throttled, shed, updated FROM burn_deltas "
                "ORDER BY replica_id, scope, window",
            ).fetchall()
        out: List[Dict] = []
        for r in rows:
            if max_age_s is not None and now - r[8] > max_age_s:
                continue
            out.append({
                "replica_id": r[0], "scope": r[1], "window": r[2],
                "total": r[3], "slow": r[4], "errors": r[5],
                "throttled": r[6], "shed": r[7], "updated": r[8],
            })
        return out

    def close(self) -> None:
        with self._lock:
            self._conn.close()
