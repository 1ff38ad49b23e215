"""LockSan: a deterministic lock-order / shared-write sanitizer (test-only).

A copy of the JAX package's ``serving/locksan.py`` (the port imports nothing
of that package). It is the dynamic check that writes to cross-thread
attributes sit under ``self._lock``. Installed (``install()``; the port's
tests install it from a fixture of their own) it

* wraps every ``threading.Lock``/``threading.RLock`` **constructed from
  serving/ code** — stdlib callers (queue, threading.Event, http.server)
  keep real primitives, so only our locks pay the bookkeeping tax;
* keeps a per-thread stack of held wrapped locks and grows a global
  acquisition-order graph keyed by construction *site* (``file:line#seq``);
* flags a **lock-order inversion** the moment an acquire closes a cycle in
  that graph — the classic A→B vs B→A deadlock is caught on the first
  interleaving that exhibits both orders, no timing luck required;
* optionally guards attributes (``watch_attrs``): every write to a watched
  attribute is checked — held class lock ⇒ fine; otherwise two *distinct*
  threads writing the same attribute unguarded is flagged.

Violations are **recorded, not raised** (the code under test keeps its
real semantics; nothing deadlocks or aborts mid-request) and reports are
deterministic: sorted by site, independent of thread scheduling; the test
that installed it fails if any were recorded.

Overhead is a few hundred nanoseconds per acquire/release — fine for
tests, which is why this module is test-only and the install is explicit.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

# directory fragments whose call sites get wrapped locks; everything else
# (stdlib, third-party, non-serving repo code) gets the real primitive
_WRAP_DIRS = (os.sep + "serving" + os.sep,)


def _relsite(filename: str, lineno: int) -> str:
    parts = filename.replace("\\", "/").split("/")
    tail = "/".join(parts[-2:]) if len(parts) >= 2 else parts[-1]
    return f"{tail}:{lineno}"


class _State:
    """Global sanitizer state. All mutation under a REAL (unwrapped) lock —
    the sanitizer must never observe itself."""

    def __init__(self) -> None:
        self._mu = _REAL_LOCK()
        self._tl = threading.local()
        # site -> set of sites acquired while holding it (direct edges)
        self.edges: Dict[str, Set[str]] = {}
        self.violations: List[dict] = []
        self._seen_keys: Set[str] = set()
        self._site_seq: Dict[str, int] = {}
        # (obj id, attr) -> set of thread idents that wrote unguarded
        self._writers: Dict[Tuple[int, str], Set[int]] = {}
        self.n_acquires = 0
        self.n_attr_checks = 0

    # -- held-lock stack (per thread) ---------------------------------------

    def _stack(self) -> List["_SanLock"]:
        st = getattr(self._tl, "stack", None)
        if st is None:
            st = self._tl.stack = []
        return st

    # -- graph --------------------------------------------------------------

    def _reachable(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src ->* dst over direct edges (None if unreachable)."""
        seen = {src}
        path = [src]

        def walk(node: str) -> bool:
            if node == dst:
                return True
            for nxt in sorted(self.edges.get(node, ())):
                if nxt in seen:
                    continue
                seen.add(nxt)
                path.append(nxt)
                if walk(nxt):
                    return True
                path.pop()
            return False

        return path if walk(src) else None

    def _record(self, kind: str, key: str, detail: str, sites: List[str]):
        if key in self._seen_keys:      # one report per distinct shape
            return
        self._seen_keys.add(key)
        self.violations.append(
            {"kind": kind, "detail": detail, "sites": sorted(sites)})

    def on_acquire(self, lk: "_SanLock") -> None:
        st = self._stack()
        with self._mu:
            self.n_acquires += 1
            for held in st:
                if held is lk:          # RLock re-entry: no new ordering
                    continue
                a, b = held.site, lk.site
                if a == b:
                    continue
                if b in self.edges.setdefault(a, set()):
                    continue
                # would a -> b close a cycle?  i.e. does b already reach a?
                cyc = self._reachable(b, a)
                self.edges[a].add(b)
                if cyc is not None:
                    cycle = cyc + [b]
                    key = "cycle:" + "->".join(sorted(set(cycle)))
                    self._record(
                        "lock-order-inversion", key,
                        "acquired %s while holding %s, but the acquisition-"
                        "order graph already orders %s before %s (cycle: %s)"
                        % (b, a, b, a, " -> ".join(cycle)),
                        cycle)
        st.append(lk)

    def on_release(self, lk: "_SanLock") -> None:
        st = self._stack()
        # release order need not be LIFO; drop the newest matching entry
        for i in range(len(st) - 1, -1, -1):
            if st[i] is lk:
                del st[i]
                break

    def holds(self, lk: "_SanLock") -> bool:
        return any(h is lk for h in self._stack())

    # -- watched attributes -------------------------------------------------

    def on_attr_write(self, obj, name: str, lock_name: str) -> None:
        self.n_attr_checks += 1
        lk = getattr(obj, lock_name, None)
        if isinstance(lk, _SanLock) and self.holds(lk):
            return                      # guarded write: fine
        ident = threading.get_ident()
        key = (id(obj), name)
        with self._mu:
            writers = self._writers.setdefault(key, set())
            writers.add(ident)
            if len(writers) >= 2:
                self._record(
                    "unguarded-shared-write",
                    f"attr:{type(obj).__name__}.{name}",
                    f"attribute '{name}' of {type(obj).__name__} written "
                    f"without holding '{lock_name}' from "
                    f"{len(writers)} distinct threads",
                    [f"{type(obj).__name__}.{name}"])

    def site_for(self, filename: str, lineno: int) -> str:
        base = _relsite(filename, lineno)
        with self._mu:
            n = self._site_seq.get(base, 0)
            self._site_seq[base] = n + 1
        return base if n == 0 else f"{base}#{n}"


class _SanLock:
    """Wrapper around a real Lock/RLock feeding the order graph.

    Supports the full context-manager + acquire/release/locked surface;
    ``threading.Condition`` built on one works through its documented
    acquire/release fallbacks."""

    __slots__ = ("_inner", "site", "_reentrant")

    def __init__(self, inner, site: str, reentrant: bool):
        self._inner = inner
        self.site = site
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got and _state is not None:
            _state.on_acquire(self)
        return got

    def release(self):
        if _state is not None:
            _state.on_release(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):          # pragma: no cover - debugging nicety
        kind = "RLock" if self._reentrant else "Lock"
        return f"<locksan.{kind} site={self.site}>"


class _Guarded:
    """Data descriptor installed by watch_attrs: checks every ``sample``-th
    write, stores the value in the instance __dict__ as usual."""

    __slots__ = ("name", "lock_name", "sample", "_n")

    def __init__(self, name: str, lock_name: str, sample: int):
        self.name = name
        self.lock_name = lock_name
        self.sample = max(1, int(sample))
        self._n = 0

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            return obj.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None

    def __set__(self, obj, value):
        self._n += 1
        if _state is not None and self._n % self.sample == 0:
            _state.on_attr_write(obj, self.name, self.lock_name)
        obj.__dict__[self.name] = value

    def __delete__(self, obj):
        obj.__dict__.pop(self.name, None)


_state: Optional[_State] = None


def _make_factory(real, reentrant: bool):
    def factory():
        if _state is None:
            return real()
        frame = sys._getframe(1)
        fn = frame.f_code.co_filename
        if not any(d in fn for d in _WRAP_DIRS):
            return real()
        site = _state.site_for(fn, frame.f_lineno)
        return _SanLock(real(), site, reentrant)

    factory.__name__ = real.__name__ if hasattr(real, "__name__") else "Lock"
    return factory


# -- public API -------------------------------------------------------------


def install() -> None:
    """Patch threading.Lock/RLock so serving/ call sites get tracked locks.

    Idempotent. Must run BEFORE the serving modules construct the locks it
    should track (an Engine, ServerState or BackendPool built afterwards)."""
    global _state
    if _state is not None:
        return
    _state = _State()
    threading.Lock = _make_factory(_REAL_LOCK, reentrant=False)
    threading.RLock = _make_factory(_REAL_RLOCK, reentrant=True)


def uninstall() -> None:
    """Restore the real primitives (existing wrapped locks keep working —
    with _state gone their bookkeeping becomes a no-op)."""
    global _state
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    _state = None


def installed() -> bool:
    return _state is not None


def tracked_lock(reentrant: bool = False, site: Optional[str] = None):
    """A wrapped lock regardless of caller location — for tests that build
    synthetic acquisition orders."""
    if _state is None:
        raise RuntimeError("locksan is not installed")
    if site is None:
        frame = sys._getframe(1)
        site = _state.site_for(frame.f_code.co_filename, frame.f_lineno)
    real = _REAL_RLOCK if reentrant else _REAL_LOCK
    return _SanLock(real(), site, reentrant)


def watch_attrs(cls, attrs=None, lock_name: str = "_lock", sample: int = 1):
    """Install write-checking descriptors on ``cls`` for ``attrs`` (default:
    the class's ``_R5_THREAD_OWNED`` declaration). Returns an undo
    callable. A write is fine when the instance's ``lock_name`` lock is held
    by the writing thread; otherwise unguarded writes from two distinct
    threads to the same attribute are flagged."""
    if attrs is None:
        attrs = getattr(cls, "_R5_THREAD_OWNED", ())
    installed_descs = []
    for name in attrs:
        if isinstance(cls.__dict__.get(name), _Guarded):
            continue
        desc = _Guarded(name, lock_name, sample)
        setattr(cls, name, desc)
        installed_descs.append(name)

    def undo():
        for name in installed_descs:
            if isinstance(cls.__dict__.get(name), _Guarded):
                delattr(cls, name)

    return undo


def violations() -> List[dict]:
    """Deterministic snapshot: sorted by (kind, sites)."""
    if _state is None:
        return []
    with _state._mu:
        return sorted((dict(v) for v in _state.violations),
                      key=lambda v: (v["kind"], v["sites"]))


def stats() -> dict:
    if _state is None:
        return {"installed": False}
    return {"installed": True, "acquires": _state.n_acquires,
            "attr_checks": _state.n_attr_checks,
            "sites": len(_state._site_seq),
            "violations": len(_state.violations)}


def reset() -> None:
    """Drop recorded violations and the order graph (keeps the install)."""
    if _state is None:
        return
    with _state._mu:
        _state.edges.clear()
        _state.violations.clear()
        _state._seen_keys.clear()
        _state._writers.clear()


def report() -> str:
    """Human-readable, deterministically ordered violation report."""
    vs = violations()
    if not vs:
        return "locksan: clean"
    lines = [f"locksan: {len(vs)} violation(s)"]
    for v in vs:
        lines.append(f"  [{v['kind']}] {v['detail']}")
    return "\n".join(lines)
