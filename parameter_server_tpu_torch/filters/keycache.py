"""Client-side versioned key-VALUE cache for the serving plane.

A copy of the JAX package's ``filters/keycache.py`` (it imports no JAX),
its generation registered with the port's lockset race witness
(``race_track``). The cache holds host numpy rows, never device tensors.

Reference analog: src/filter/key_caching.h cached the key LISTS of a
message so repeats send a signature instead of the keys. This module
generalizes that idea to the values themselves for read-mostly (serving)
traffic, the way the TeraByte-scale ads framework (arXiv 2201.05500)
splits one parameter plane into a training path and a cached serving
path: every pull reply carries the shard's RCU publish *version*, the
client caches the decoded rows under the key-set signature, and a later
pull of the same keys is served

- **locally** while the entry is younger than the TTL (zero wire bytes),
- **by revalidation** once the TTL lapses: an ``if_newer=<version>``
  pull that comes back ``not_modified`` re-arms the TTL without moving
  a single row byte,
- **from the wire** only when the server's version actually moved.

Invalidation is EXACT: a push through the owning handle invalidates
every cached entry whose key set intersects the pushed keys (an
inverted key -> signatures index makes that one dict probe per pushed
key), so a client can never read its own write stale. Staleness against
OTHER writers is bounded by ``ttl_ms`` — and by ``max_stale_ms`` as a
hard ceiling when the server sheds revalidations under load.

One cache serves a MULTI-SHARD frontend:
entries are namespaced by shard ``rank``. Keys on this wire are
range-RELATIVE, so two shards produce identical signatures (and
identical key ints) for different rows — a rank-blind shared cache
would serve shard A's rows for shard B's pull and cross-invalidate on
push. Handles pass ``(rank, sig)`` composite signatures and their rank
to ``put``/``invalidate_keys``; the inverted index keys by
``(rank, key)``.

Thread safety: one lock around the map + inverted index. Nothing
blocking ever runs under it (lookups, puts and invalidations are dict
and small-array operations); the wire round trip always happens with
the lock released, so a slow revalidation never parks concurrent local
hits.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np

from parameter_server_tpu_torch.utils.metrics import race_track, wire_counters


class CacheEntry:
    """One cached key set: the decoded float32 rows, the server version
    they were read at, and the two clocks bounding how long they may be
    served (``expires_at``: the soft TTL, re-armed by revalidation;
    ``filled_at``: when the server last CONFIRMED this version, the
    anchor of the hard ``max_stale`` ceiling).

    Freshness plane: ``age0_us`` is the server-measured data
    age (µs since the RCU publish) at the moment the entry was filled
    or last revalidated — the reply's ``_age_us`` echo. A cached serve
    at monotonic time ``now`` hands out rows whose realized age is
    ``age0_us + (now - filled_at)``: the cross-machine term is measured
    on the SERVER's clock (skew-free) and only the local dwell time is
    measured here."""

    __slots__ = (
        "keys", "values", "version", "filled_at", "expires_at", "rank",
        "age0_us",
    )

    def __init__(
        self, keys: np.ndarray, values: np.ndarray, version: int,
        filled_at: float, expires_at: float, rank: int = 0,
        age0_us: float = 0.0,
    ):
        self.keys = keys
        self.values = values
        self.version = version
        self.filled_at = filled_at
        self.expires_at = expires_at
        self.rank = rank  # shard namespace of the inverted-index rows
        self.age0_us = float(age0_us)

    def age_us(self, now: float | None = None) -> float:
        """Realized age (µs) of these rows if served at ``now``."""
        now = time.monotonic() if now is None else now
        return self.age0_us + max(now - self.filled_at, 0.0) * 1e6


class ClientKeyCache:
    """LRU of key-set signature -> :class:`CacheEntry` with an exact
    inverted index ((rank, key) -> signatures) driving push
    invalidation. ``sig`` is any hashable — a multi-shard frontend's
    handles pass ``(rank, digest)`` composites so one shared cache never
    collides range-relative keys across shards."""

    def __init__(
        self, cap: int = 1024, ttl_s: float = 0.05, max_stale_s: float = 0.5
    ):
        self.cap = max(1, int(cap))
        self.ttl_s = float(ttl_s)
        self.max_stale_s = float(max_stale_s)
        self._lock = threading.Lock()
        self._d: OrderedDict = OrderedDict()  # sig -> CacheEntry
        self._by_key: dict[tuple[int, int], set] = {}  # (rank, key) -> sigs
        # refresh coalescing: signatures with a revalidation in flight.
        # While one caller refreshes a stale entry, concurrent pulls of
        # the same keys serve the (within-max_stale) cached rows instead
        # of issuing duplicate wire refreshes — ONE refresh per stale
        # entry per expiry, however many threads share the cache.
        self._refreshing: set = set()
        # invalidation generation: bumped by EVERY invalidate_keys call
        # (even one that dropped nothing — the racing pull's entry may
        # not be indexed yet). A put whose pull was issued before a
        # later invalidation must lose, or a reply in flight across a
        # concurrent push would re-install pre-push rows and this
        # frontend would read its own write stale.
        self._gen = 0
        # lockset race witness (PS_RACE_WITNESS=1): the generation is
        # read by every pull path and bumped by every push invalidation
        # across a frontend's threads — all under _lock, or the
        # read-your-writes reasoning above is fiction
        race_track(self, ("_gen",), "ClientKeyCache")

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    @property
    def gen(self) -> int:
        """Current invalidation generation — capture BEFORE issuing a
        wire pull and hand to :meth:`put` so an install can never race
        past an invalidation (read-your-writes across threads)."""
        with self._lock:
            return self._gen

    # -- reads -------------------------------------------------------------

    def lookup(self, sig) -> CacheEntry | None:
        """The entry for ``sig`` (LRU-touched), or None. The caller
        decides freshness via :meth:`fresh` / :meth:`can_shed` — lookup
        never drops a stale entry, because a stale entry still carries
        the version that makes an if_newer revalidation cheap."""
        with self._lock:
            ent = self._d.get(sig)
            if ent is not None:
                self._d.move_to_end(sig)
            return ent

    def fresh(self, ent: CacheEntry, now: float | None = None) -> bool:
        """Young enough to serve locally without any wire traffic."""
        return (time.monotonic() if now is None else now) < ent.expires_at

    def can_shed(self, ent: CacheEntry, now: float | None = None) -> bool:
        """Young enough to keep serving if the server sheds the
        revalidation (the hard staleness ceiling): the client advertises
        ``shed_ok`` on the wire only while this holds, so an overloaded
        server can never stretch a client past ``max_stale_s``."""
        now = time.monotonic() if now is None else now
        return now - ent.filled_at <= self.max_stale_s

    def begin_refresh(self, sig) -> bool:
        """Claim the (single-flight) refresh of a stale entry: True when
        this caller owns it and must go to the wire — and MUST call
        :meth:`end_refresh` on every settle path; False when a refresh
        is already in flight (serve the bounded-stale entry instead)."""
        with self._lock:
            if sig in self._refreshing:
                return False
            self._refreshing.add(sig)
            return True

    def end_refresh(self, sig) -> None:
        with self._lock:
            self._refreshing.discard(sig)

    # -- writes ------------------------------------------------------------

    @staticmethod
    def _sig_rank(sig) -> int | None:
        """The rank a ``(rank, digest)`` composite signature carries
        (None for a plain signature)."""
        if isinstance(sig, tuple) and sig and isinstance(sig[0], int):
            return sig[0]
        return None

    def put(
        self, sig, keys: np.ndarray, values: np.ndarray, version: int,
        now: float | None = None, as_of: int | None = None,
        rank: int | None = None, age_us: float | None = None,
    ) -> CacheEntry | None:
        """Install freshly pulled rows (replacing any older entry).
        ``as_of`` is the :attr:`gen` captured when the pull was ISSUED:
        if any invalidation ran since, the install is skipped (returns
        None) — the rows may predate a push that already invalidated
        this key set, and installing them would serve a stale
        read-your-write. Conservative by design (any invalidation
        cancels any in-flight install): pushes are rare on the
        read-mostly tier this cache serves, so a lost install costs one
        refresh, while a falsely kept one would cost correctness."""
        # index namespace: derived from a composite sig, or given
        # explicitly — and the two must AGREE, or a push's rank-scoped
        # invalidation would silently miss this entry and serve stale
        # pre-push rows for up to the ttl/max_stale bound
        srank = self._sig_rank(sig)
        if rank is None:
            rank = srank if srank is not None else 0
        elif srank is not None and srank != rank:
            raise ValueError(
                f"put(sig={sig!r}, rank={rank}): the composite sig "
                f"carries rank {srank} — entry and inverted index would "
                "disagree and exact invalidation would break"
            )
        now = time.monotonic() if now is None else now
        keys = np.array(keys, copy=True)
        values = np.array(values, copy=True)  # own both: callers may reuse
        ent = CacheEntry(
            keys, values, int(version), now, now + self.ttl_s, int(rank),
            age0_us=float(age_us or 0.0),
        )
        with self._lock:
            if as_of is not None and as_of != self._gen:
                wire_counters.inc("serve_cache_put_races")
                return None
            old = self._d.pop(sig, None)
            if old is not None:
                self._unindex(sig, old)
            self._d[sig] = ent
            for k in keys.tolist():
                self._by_key.setdefault((ent.rank, k), set()).add(sig)
            while len(self._d) > self.cap:
                esig, evicted = self._d.popitem(last=False)
                self._unindex(esig, evicted)
        return ent

    def revalidated(
        self, sig, version: int, now: float | None = None,
        age_us: float | None = None,
    ) -> None:
        """A ``not_modified`` reply confirmed the entry's version is
        still current: re-arm BOTH clocks — the data is as fresh as the
        round trip that just verified it. ``age_us`` re-anchors the
        realized-age clock off the reply's server-measured ``_age_us``
        echo; absent (pre-freshness server), the age keeps accumulating
        from the previous anchor — an unknown age must grow, never
        reset to zero on a reply that moved no rows."""
        now = time.monotonic() if now is None else now
        with self._lock:
            ent = self._d.get(sig)
            if ent is None:
                return
            ent.version = int(version)
            ent.age0_us = (
                float(age_us) if age_us is not None else ent.age_us(now)
            )
            ent.filled_at = now
            ent.expires_at = now + self.ttl_s
        wire_counters.inc("serve_cache_validates")

    def shed_backoff(self, sig, retry_after_s: float) -> None:
        """The server shed this entry's revalidation: keep serving the
        (still within-max_stale) entry for ``retry_after_s`` before
        asking again — but never past the hard ceiling, so a stream of
        shed replies cannot stretch staleness beyond ``max_stale_s``."""
        with self._lock:
            ent = self._d.get(sig)
            if ent is None:
                return
            ent.expires_at = min(
                time.monotonic() + retry_after_s,
                ent.filled_at + self.max_stale_s,
            )

    def invalidate_keys(self, keys: np.ndarray, rank: int = 0) -> int:
        """Drop every entry of shard ``rank`` whose key set intersects
        ``keys`` (exact push invalidation: one inverted-index probe per
        pushed key); returns how many entries died. Rank-scoped: keys
        are range-relative, so shard A's push must never evict shard
        B's rows that happen to share local key ints."""
        klist = np.asarray(keys).tolist()  # outside the lock: asarray may
        # sync a device buffer, and the lock must stay nanosecond-scale
        rank = int(rank)
        with self._lock:
            self._gen += 1  # even when nothing cached matches: an
            # in-flight pull of exactly these keys has no entry to drop,
            # and its put must still lose to this invalidation
            doomed: set = set()
            for k in klist:
                sigs = self._by_key.get((rank, k))
                if sigs:
                    doomed.update(sigs)
            for sig in doomed:
                ent = self._d.pop(sig, None)
                if ent is not None:
                    self._unindex(sig, ent)
        if doomed:
            wire_counters.inc("serve_cache_invalidations", len(doomed))
        return len(doomed)

    def _unindex(self, sig, ent: CacheEntry) -> None:
        """Caller holds ``self._lock``."""
        for k in ent.keys.tolist():
            sigs = self._by_key.get((ent.rank, k))
            if sigs is not None:
                sigs.discard(sig)
                if not sigs:
                    del self._by_key[(ent.rank, k)]
