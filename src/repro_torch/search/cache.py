"""Persistent, content-addressed result cache for mapspace searches.

The dominant DSE cost is enumerating + scoring a workload's mapspace.  The
same (workload, hardware, mapper config, goal) query recurs constantly:
repeated layers inside one network, identical conv/matmul shapes across
networks, and revisited architectures across search iterations.  The cache
keys queries by a sha256 over a canonical JSON encoding of all four
components and stores the winning mapping plus its estimate, in two tiers:

  * memory — LRU dict, per-process, zero-cost hits;
  * disk   — one JSON file per key under a cache directory, surviving
    process restarts (a fresh `ResultCache` pointed at the same directory
    serves hits without a single mapspace enumeration).

Values are stored *deconstructed* (factor/order/bypass tables + estimate
fields) rather than pickled, so cache files are portable, inspectable and
independent of code layout; mappings are rebuilt against the live
`Workload`/`HardwareDesc` objects at lookup time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import queue
import tempfile
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from ..core.designer import HardwareDesc
from ..core.evaluator import Estimate
from ..core.mapper import MapperConfig
from ..core.mapping import Mapping
from ..core.scheduler import SCHEDULER_FORMAT, MixDesc
from ..core.workload import Workload

CACHE_FORMAT = 5        # v5: heterogeneous-mix digest joined the key
#                         scheme (v4: constraints digest; v3:
#                         packed-mapspace digest)
GC_LOCK = ".gc.lock"    # cross-process guard for the disk-tier GC
GC_LOCK_STALE_S = 600.0  # a lock older than this is a dead process's


# ---------------------------------------------------------------------------
# key scheme
# ---------------------------------------------------------------------------
def _workload_sig(wl: Workload) -> Dict[str, Any]:
    return {"dims": list(wl.dims), "stride": list(wl.stride),
            "dilation": list(wl.dilation), "kind": wl.kind,
            "depthwise": wl.depthwise,
            "in_zf": round(wl.input_zero_frac, 9),
            "w_zf": round(wl.weight_zero_frac, 9)}


def _hw_sig(hw: HardwareDesc) -> Dict[str, Any]:
    # The top-level `name` is cosmetic and excluded (identically-parameterized
    # designs share entries); level names stay — mappings/configs refer to
    # them (cache_level, zero_skip_level).
    return {"levels": [dataclasses.asdict(lv) for lv in hw.levels],
            "precision_bits": hw.precision_bits,
            "frequency_hz": hw.frequency_hz,
            "zero_skip_level": hw.zero_skip_level}


def _cfg_sig(cfg: MapperConfig) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d["act_reserve"] = sorted(d["act_reserve"].items())
    return d


def _mix_sig(mix: MixDesc) -> Dict[str, Any]:
    # The mix `name` is cosmetic and excluded (like `HardwareDesc.name`);
    # member *order* stays — it is the scheduler's member index space.
    # SCHEDULER_FORMAT rides along so a change to assignment/combination
    # semantics invalidates every member sub-result at once.
    return {"members": [_hw_sig(m) for m in mix.members],
            "scheduler": SCHEDULER_FORMAT}


def mix_digest(mix: MixDesc) -> str:
    """Content digest of a mix's composition — passed as `cache_key`'s
    `mix=` component for every member sub-job, so mix-context entries
    can never alias single-arch entries (or entries from a different
    mix): the per-workload winner is the same either way today, but the
    namespace partition keeps future mix-aware mapping selection (e.g.
    scoring against a member's *contended* shared bandwidth) correct
    for free."""
    blob = json.dumps(_mix_sig(mix), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def cache_key(wl: Workload, hw: HardwareDesc, cfg: MapperConfig,
              goal: str, scorer: str = "per-arch",
              backend: str = "torch",
              mapspace: Optional[str] = None,
              constraints: Optional[str] = None,
              mix: Optional[str] = None) -> str:
    """`scorer` is the selection path ("per-arch" per-job selection vs
    "fused" cross-arch batching) and `backend` the scoring engine
    ("torch" oracle vs "cuda" mapspace kernel — pass the *resolved*
    engine, not "auto"): near-tied mapspaces can elect different winners
    under different float32 evaluation orders, so entries are not
    interchangeable across paths — keying on both means torch- and
    cuda-scored results never alias each other (nor the JAX package's
    "jnp"/"pallas" entries, whose engine names differ).

    `mapspace` is the content digest of the packed candidate arrays
    (`PackedMapspace.digest()`): the array-native pipeline keys entries
    on the mapspace that was actually scored instead of trusting the
    mapper config to describe it, so any change to the candidate
    generator invalidates stale winners automatically.

    `constraints` is the `ConstraintSet.digest()` of the search's budget
    set (None = unconstrained).  Per-workload winners don't depend on
    network-level budgets today, but the digest still partitions the
    namespace so constrained and unconstrained runs (or runs under
    different budgets) can never alias — future constraint-aware mapping
    selection gets correctness for free.

    `mix` is the `mix_digest` of the enclosing heterogeneous mix when
    this (workload, hw) sub-job belongs to one (None for single-arch
    runs): mix-context entries and single-arch entries never alias."""
    payload = {"v": CACHE_FORMAT, "workload": _workload_sig(wl),
               "hw": _hw_sig(hw), "cfg": _cfg_sig(cfg), "goal": goal,
               "scorer": scorer, "backend": backend,
               "constraints": constraints}
    if mapspace is not None:
        payload["mapspace"] = mapspace
    if mix is not None:
        payload["mix"] = mix
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# value codec (WorkloadResult <-> plain JSON dict)
# ---------------------------------------------------------------------------
def encode_result(result) -> Dict[str, Any]:
    """WorkloadResult -> JSON-safe dict (mapping deconstructed)."""
    m: Mapping = result.mapping
    return {
        "v": CACHE_FORMAT,
        "factors": [list(f) for f in m.factors],
        "orders": [list(o) if o is not None else None for o in m.orders],
        "bypass": [sorted(b) for b in m.bypass],
        "mapspace_size": result.mapspace_size,
        "n_valid": result.n_valid,
        "estimate": dataclasses.asdict(result.estimate),
    }


def decode_result(entry: Dict[str, Any], wl: Workload, hw: HardwareDesc):
    """JSON dict -> WorkloadResult, rebuilt against live wl/hw objects."""
    from ..core.explorer import WorkloadResult
    mapping = Mapping(
        wl, hw,
        tuple(tuple(f) for f in entry["factors"]),
        tuple(tuple(o) if o is not None else None for o in entry["orders"]),
        tuple(frozenset(b) for b in entry["bypass"]))
    est = Estimate(**entry["estimate"])
    return WorkloadResult(workload=wl, mapping=mapping, estimate=est,
                          mapspace_size=entry["mapspace_size"],
                          n_valid=entry["n_valid"])


# ---------------------------------------------------------------------------
# async disk writeback
# ---------------------------------------------------------------------------
class AsyncCacheWriter:
    """Bounded background writer for a `ResultCache`'s disk tier.

    The streaming driver keeps cache `put`s off the round critical path:
    the memory tier and `CacheStats` update synchronously on the calling
    thread (counters stay deterministic), while the JSON-file write —
    mkstemp + `os.replace`, plus the GC cadence check — runs on this
    single background thread.  The queue is bounded, so a slow disk
    applies backpressure instead of growing unboundedly.

    `close()` drains every queued put before returning (flush-on-exit):
    a run that raises mid-round still lands all completed puts, which the
    driver guarantees by closing the writer in a ``finally`` under the
    "cache-flush" phase span.  Disk errors never kill the run — they are
    recorded per item and surfaced via `errors`.  GC stays cross-process
    safe: the sweep runs on this thread under the same O_EXCL lockfile.
    """

    def __init__(self, cache: "ResultCache", max_queue: int = 256):
        self._cache = cache
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue(
            maxsize=max(1, max_queue))
        self.errors: List[BaseException] = []
        self.n_written = 0
        self._thread = threading.Thread(
            target=self._loop, name="repro-cache-writer", daemon=True)
        self._thread.start()

    def submit(self, key: str, blob: str) -> None:
        """Enqueue one disk write; blocks (backpressure) when full."""
        self._q.put((key, blob))

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            key, blob = item
            try:
                self._cache._disk_put(key, blob)
                self.n_written += 1
            except BaseException as exc:      # disk full / perms: record,
                self.errors.append(exc)       # never kill the search


    def close(self) -> int:
        """Drain every queued put, stop the thread; -> writes landed."""
        self._q.put(None)
        self._thread.join()
        return self.n_written


# ---------------------------------------------------------------------------
# the two-tier store
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CacheStats:
    """Per-cache traffic counters.  This is the one source of truth for
    cache accounting: `run_search` derives its `n_cache_hits/misses` and
    the memory/disk hit split in `SearchReport.summary()["cache"]` from
    deltas of these counters (asserted equal in tests/test_obs.py)."""
    hits_memory: int = 0
    hits_disk: int = 0
    misses: int = 0
    puts: int = 0
    disk_evictions: int = 0

    @property
    def hits(self) -> int:
        return self.hits_memory + self.hits_disk

    def as_dict(self) -> Dict[str, int]:
        return {"hits_memory": self.hits_memory,
                "hits_disk": self.hits_disk, "hits": self.hits,
                "misses": self.misses, "puts": self.puts,
                "disk_evictions": self.disk_evictions}


class ResultCache:
    """In-memory LRU over an optional on-disk JSON tier.

    path=None gives a process-local cache; with a path, entries persist and
    a fresh ResultCache on the same path serves them as disk hits.

    The disk tier is bounded: every `gc_every` puts (and on explicit
    `gc()`) entries beyond `max_disk_entries` / `max_disk_bytes` are
    evicted oldest-mtime-first (reads never touch mtime, so this is
    oldest-written-first — content-addressed entries are immutable, and
    DSE hit patterns make insertion age a good staleness proxy).  Either
    bound can be None for unlimited; both default to generous caps so a
    long-running sweep cannot fill the disk.  Running entry/byte
    estimates (seeded by the first scan, advanced per put, corrected on
    every real scan) let the put-cadence check skip the O(entries)
    directory scan while the tier is under its bounds.
    """

    def __init__(self, path: Optional[str] = None, max_memory: int = 4096,
                 max_disk_entries: Optional[int] = 100_000,
                 max_disk_bytes: Optional[int] = 512 << 20,
                 gc_every: int = 256):
        self.path = path
        self.max_memory = max_memory
        self.max_disk_entries = max_disk_entries
        self.max_disk_bytes = max_disk_bytes
        self.gc_every = max(1, gc_every)
        self._puts_since_gc = 0
        self._est_entries: Optional[int] = None     # None = not yet seeded
        self._est_bytes = 0
        self._mem: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.stats = CacheStats()
        # one reentrant lock guards the memory tier, the stats counters
        # and the disk-size estimates: the streaming driver reads the
        # cache from its worker thread while an AsyncCacheWriter lands
        # disk puts on a third
        self._lock = threading.RLock()
        self._writer: Optional[AsyncCacheWriter] = None
        if path:
            os.makedirs(path, exist_ok=True)

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.json")

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._mem.get(key)
            if entry is not None:
                self._mem.move_to_end(key)
                self.stats.hits_memory += 1
                return entry
        if self.path:
            try:
                with open(self._file(key)) as f:
                    entry = json.load(f)
            except (FileNotFoundError, json.JSONDecodeError):
                entry = None
            if entry is not None and entry.get("v") == CACHE_FORMAT:
                with self._lock:
                    self.stats.hits_disk += 1
                    self._remember(key, entry)
                return entry
        with self._lock:
            self.stats.misses += 1
        return None

    def put(self, key: str, entry: Dict[str, Any]) -> None:
        # memory tier + counters update synchronously on the calling
        # thread (deterministic stats); the disk write goes through the
        # background writer when one is active
        with self._lock:
            self.stats.puts += 1
            self._remember(key, entry)
        if self.path:
            blob = json.dumps(entry)
            if self._writer is not None:
                self._writer.submit(key, blob)
            else:
                self._disk_put(key, blob)

    def _disk_put(self, key: str, blob: str) -> None:
        # atomic-ish: write sidecar then rename, so concurrent readers
        # never observe a torn file
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(blob)
            os.replace(tmp, self._file(key))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        with self._lock:
            if self._est_entries is not None:
                # overwrites over-count by one entry; corrected at the
                # next real scan
                self._est_entries += 1
                self._est_bytes += len(blob)
            self._puts_since_gc += 1
            run_gc = self._puts_since_gc >= self.gc_every
            if run_gc:
                self._puts_since_gc = 0
                run_gc = self._est_entries is None or self._over_bounds()
        if run_gc:
            self.gc()

    # -- async writeback -------------------------------------------------
    def start_async_writes(self, max_queue: int = 256) \
            -> Optional[AsyncCacheWriter]:
        """Route subsequent disk puts through a bounded background
        writer (no-op without a disk tier).  Memory-tier behaviour and
        stats are unchanged; pair with `stop_async_writes()`."""
        if not self.path or self._writer is not None:
            return self._writer
        self._writer = AsyncCacheWriter(self, max_queue=max_queue)
        return self._writer

    def stop_async_writes(self) -> int:
        """Drain every queued put and return to synchronous writes;
        -> number of disk writes the background writer landed."""
        writer, self._writer = self._writer, None
        if writer is None:
            return 0
        self._last_writer = writer
        return writer.close()

    @contextlib.contextmanager
    def async_writes(self, max_queue: int = 256):
        """`with cache.async_writes():` — async writeback scoped to the
        block, drained on exit even when the body raises."""
        writer = self.start_async_writes(max_queue=max_queue)
        try:
            yield writer
        finally:
            self.stop_async_writes()

    @property
    def writer_errors(self) -> List[BaseException]:
        """Disk errors recorded by the current or most recent writer."""
        writer = self._writer or getattr(self, "_last_writer", None)
        return list(writer.errors) if writer is not None else []

    def _over_bounds(self) -> bool:
        return ((self.max_disk_entries is not None
                 and (self._est_entries or 0) > self.max_disk_entries)
                or (self.max_disk_bytes is not None
                    and self._est_bytes > self.max_disk_bytes))

    # -- cross-process GC guard -----------------------------------------
    # Entry writes are already safe across processes (os.replace only —
    # readers never see a torn file, concurrent writers of one key are
    # last-wins over identical content-addressed values).  GC is the one
    # mutating sweep: two processes GC'ing concurrently could both scan,
    # both evict, and double-count — so it runs under an O_EXCL lockfile.
    # A holder that dies leaves the lock behind; locks older than
    # GC_LOCK_STALE_S are broken and retaken.
    def _lock_file(self) -> str:
        return os.path.join(self.path, GC_LOCK)

    def _try_lock(self) -> bool:
        import time
        lock = self._lock_file()
        for _ in range(2):              # second try after breaking a stale
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                try:
                    age = time.time() - os.path.getmtime(lock)
                except FileNotFoundError:
                    continue            # holder just released; retry
                if age <= GC_LOCK_STALE_S:
                    return False        # live holder: skip this GC
                # break the dead process's lock via rename: of the
                # processes that observed it stale, one wins the rename
                # and the losers see ENOENT and back off.  The stat and
                # the rename are not atomic, so the renamed file might be
                # a *fresh* lock some other breaker re-created in the
                # window — re-check the claimed file's age and, if we
                # stole a live lock, put it back with os.link (atomic,
                # never clobbers a newer lock) and back off.
                claim = f"{lock}.stale.{os.getpid()}"
                try:
                    os.rename(lock, claim)
                except (FileNotFoundError, OSError):
                    return False        # another process is breaking it
                try:
                    stolen = time.time() - os.path.getmtime(claim)
                except FileNotFoundError:
                    continue
                if stolen <= GC_LOCK_STALE_S:
                    try:
                        os.link(claim, lock)
                    except OSError:
                        pass            # a newer lock exists: leave it
                    try:
                        os.unlink(claim)
                    except FileNotFoundError:
                        pass
                    return False
                try:
                    os.unlink(claim)
                except FileNotFoundError:
                    pass
                continue
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            return True
        return False

    def _unlock(self) -> None:
        try:
            os.unlink(self._lock_file())
        except FileNotFoundError:
            pass

    def gc(self) -> int:
        """Enforce the disk-tier bounds (full directory scan); -> number
        of files evicted.  Also sweeps *.tmp sidecars orphaned by a
        killed writer.  Cross-process safe: the sweep runs under an
        O_EXCL lockfile and is skipped (returns 0) while another process
        holds it, so two concurrent searches on one cache directory can
        never double-evict."""
        from ..obs import current_tracer
        self._puts_since_gc = 0
        if not self.path or (self.max_disk_entries is None
                             and self.max_disk_bytes is None):
            return 0
        if not self._try_lock():
            return 0
        try:
            with current_tracer().span("cache.gc") as sp:
                evicted = self._gc_locked()
                sp.set(evicted=evicted)
            return evicted
        finally:
            self._unlock()

    def _gc_locked(self) -> int:
        import time
        files = []
        total = 0
        stale = time.time() - 600
        with os.scandir(self.path) as it:
            for de in it:
                try:
                    st = de.stat()
                except FileNotFoundError:
                    continue            # concurrent eviction
                if de.name.endswith(".tmp") or \
                        de.name.startswith(GC_LOCK + ".stale."):
                    # orphans of killed writers / lock-breakers
                    if st.st_mtime < stale:
                        try:
                            os.unlink(de.path)
                        except FileNotFoundError:
                            pass
                    continue
                if not de.name.endswith(".json"):
                    continue
                files.append((st.st_mtime, st.st_size, de.path))
                total += st.st_size
        files.sort()                    # oldest first
        evicted = 0
        over_n = (len(files) - self.max_disk_entries
                  if self.max_disk_entries is not None else 0)
        for mtime, size, fp in files:
            if over_n <= 0 and (self.max_disk_bytes is None
                                or total <= self.max_disk_bytes):
                break
            try:
                os.unlink(fp)
            except FileNotFoundError:
                pass
            evicted += 1
            over_n -= 1
            total -= size
        with self._lock:
            self._est_entries = len(files) - evicted
            self._est_bytes = total
            self.stats.disk_evictions += evicted
        return evicted

    def _remember(self, key: str, entry: Dict[str, Any]) -> None:
        self._mem[key] = entry
        self._mem.move_to_end(key)
        while len(self._mem) > self.max_memory:
            self._mem.popitem(last=False)

    def clear_memory(self) -> None:
        with self._lock:
            self._mem.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)
