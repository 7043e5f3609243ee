"""Versioned on-disk store for SpGEMM plan artifacts (warm restarts).

FSpGEMM's premise is that pre-processing is host work done *once per
pattern* — but a process-level cache amortizes it only within one process
lifetime. This module is the disk tier behind
:class:`repro_torch.spgemm.cache.PlanCache`: the value-independent
symbolic artifacts (triple schedule, scatter indices, assembly map, shard
bounds — serialized through the flat-array codecs in
``repro_torch.core.schedule``, whose arrays equal the JAX package's
bitwise) are written once per cache key, and a restarted worker
rehydrates the plan instead of re-running the symbolic phase.

The port's files have names of their own: entries end in
``.plan-torch.npz``, the alias index is ``torch-tokens.index.json``,
temporary files end in ``.tmp-torch``, and the format version is the
port's. So a port store and a JAX-package store pointed at one directory
never list, load, evict, collect or overwrite each other's files.

Design constraints, in order:

* **Never poison a computation.** Every load is integrity-checked — a
  format-version header, the full cache key echoed back, and a BLAKE2b
  digest over every payload array — and *any* failure (truncated file,
  bit flip, version bump, a foreign file renamed onto this key) returns
  ``None`` so the caller falls back to a fresh symbolic build. Unreadable
  files are best-effort deleted so they cannot fail every restart.
* **Crash-safe writes.** Payloads are written to a same-directory temp
  file, fsynced, and ``os.replace``-d into place (with a directory fsync
  on POSIX so the rename itself is durable); a crash — or a power cut —
  leaves either the old file or a stray ``*.tmp`` (ignored and
  garbage-collected), never a truncated-but-renamed readable entry.
* **Bounded footprint.** ``max_bytes`` evicts oldest-used entries after
  each save (successful loads refresh mtime, so eviction is LRU-ish across
  processes; equal-mtime files tie-break deterministically by name); the
  just-written file is always kept.

Besides plan artifacts the store keeps one tiny versioned index file
(``torch-tokens.index.json``) mapping ``pattern_token`` alias keys to full plan
keys, written with the same atomic tmp+rename+fsync discipline — see
:meth:`PlanStore.alias_put` and the ``token_disk_hits`` counter in
:class:`repro_torch.spgemm.cache.CacheStats`.

The store holds only numpy arrays plus a JSON header (``allow_pickle`` is
never enabled), so a corrupt or malicious cache directory can cause at
worst a rebuild, not code execution.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["FORMAT_VERSION", "PLAN_DIR_ENV", "PlanStore", "plan_file_name"]

# Bump on any incompatible change to the artifact layout; older files are
# ignored (and evicted), not migrated. The port's own number: the JAX
# package's store is at 1, and neither package reads the other's entries.
FORMAT_VERSION = 1001

# Setting this enables the disk tier on the process-default PlanCache.
PLAN_DIR_ENV = "REPRO_TORCH_SPGEMM_PLAN_DIR"

_SUFFIX = ".plan-torch.npz"
_TMP = ".tmp-torch"
_META_KEY = "__meta__"
_ALIAS_FILE = "torch-tokens.index.json"


def _key_repr(key: Tuple) -> str:
    """Canonical string form of a cache key. Keys are tuples of str / int /
    nested tuples (pattern digest, tile, group, backend, device, mesh
    key), so ``repr`` is stable across processes and Python builds."""
    return repr(key)


def plan_file_name(key: Tuple) -> str:
    """Filename for a cache key: a digest of the canonical key string.

    The full key is also stored *inside* the file and verified on load, so
    a digest collision (or a file renamed across keys) degrades to a
    rebuild, never to serving the wrong plan."""
    return _file_name_for_repr(_key_repr(key))


def _file_name_for_repr(key_repr: str) -> str:
    """Same as :func:`plan_file_name` but from an already-repr'd key —
    the alias index stores key reprs, so audit/alias lookups can locate
    the target file without ``literal_eval``-ing the repr back."""
    h = hashlib.blake2b(key_repr.encode(), digest_size=16)
    return h.hexdigest() + _SUFFIX


def _payload_digest(arrays: Dict[str, np.ndarray], meta: dict) -> str:
    """BLAKE2b over the meta dict and every array's name, dtype, shape,
    and bytes (both canonically ordered, so dict order never changes the
    digest). Meta is inside the digest so a parseable-but-tampered JSON
    header (a flipped shape digit, say) cannot pass verification and feed
    ``from_artifacts`` wrong geometry."""
    h = hashlib.blake2b(digest_size=16)
    h.update(json.dumps(meta, sort_keys=True).encode())
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class PlanStore:
    """A directory of integrity-checked plan-artifact files.

    ``save``/``load`` speak ``(arrays, meta)``: a flat ``{name: ndarray}``
    payload (the codecs in ``repro_torch.core.schedule`` produce/consume these)
    plus a small JSON-able dict of plan metadata. The store itself is
    plan-agnostic — rehydration lives in ``SpGEMMPlan.from_artifacts``.

    All methods are safe to call concurrently from multiple processes
    pointed at one directory: writes are atomic renames, loads re-verify
    content, and a lost eviction race is at worst a double unlink (ignored).
    """

    def __init__(self, root: str, max_bytes: Optional[int] = None):
        if max_bytes is not None and max_bytes < 1:
            raise ValueError("max_bytes must be >= 1 (or None)")
        self.root = os.path.abspath(root)
        self.max_bytes = max_bytes
        self.evictions = 0  # files this store instance deleted for budget
        self._lock = threading.Lock()
        os.makedirs(self.root, exist_ok=True)
        self._gc_stale_tmps()

    # -- paths / accounting ------------------------------------------------

    def _gc_stale_tmps(self, max_age_s: float = 3600.0) -> None:
        """Delete orphaned temporary files (a writer crashed mid-save): this
    store's own, named ``*.tmp-torch``; a JAX-package store's ``*.tmp``
    files are left to it.

        Run at store construction — i.e. at every restart, exactly when
        orphans accumulate. The age threshold spares another live
        process's in-flight write; a just-crashed writer's tmp is
        collected by the restart after next (or any store opened an hour
        later)."""
        cutoff = time.time() - max_age_s
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for n in names:
            if not n.endswith(_TMP):
                continue
            p = os.path.join(self.root, n)
            try:
                if os.path.getmtime(p) < cutoff:
                    os.unlink(p)
            except OSError:
                continue

    def path_for(self, key: Tuple) -> str:
        return os.path.join(self.root, plan_file_name(key))

    def files(self) -> List[str]:
        """Store entries, oldest-used first (mtime ascending; equal
        mtimes tie-break by name so the eviction order is deterministic
        across processes and filesystems with coarse timestamps)."""
        try:
            names = [
                n for n in os.listdir(self.root) if n.endswith(_SUFFIX)
            ]
        except OSError:
            return []
        paths = []
        for n in names:
            p = os.path.join(self.root, n)
            try:
                paths.append((os.path.getmtime(p), n, p))
            except OSError:  # raced with another process's eviction
                continue
        return [p for _, _, p in sorted(paths)]

    def total_bytes(self) -> int:
        total = 0
        for p in self.files():
            try:
                total += os.path.getsize(p)
            except OSError:
                continue
        return total

    def __len__(self) -> int:
        return len(self.files())

    def __contains__(self, key: Tuple) -> bool:
        return os.path.exists(self.path_for(key))

    # -- save / load -------------------------------------------------------

    def save(
        self, key: Tuple, arrays: Dict[str, np.ndarray], meta: dict
    ) -> Optional[str]:
        """Write one entry atomically. Returns the path, or ``None`` if the
        write failed (persistence is an optimization — a full disk or
        read-only directory must not break plan building)."""
        header = {
            "format_version": FORMAT_VERSION,
            "key": _key_repr(key),
            "digest": _payload_digest(arrays, meta),
            "meta": meta,
        }
        path = self.path_for(key)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}{_TMP}"
        try:
            payload = dict(arrays)
            payload[_META_KEY] = np.frombuffer(
                json.dumps(header).encode(), np.uint8
            )
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
                # fsync BEFORE the rename: os.replace is atomic for
                # concurrent readers but not against power loss — without
                # the flush a crash can surface a truncated file under the
                # final name, which would then fail (and delete) on every
                # restart's load.
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._fsync_dir()
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        if self.max_bytes is not None:
            self._evict(keep=path)
        return path

    def _fsync_dir(self) -> None:
        """Fsync the store directory (POSIX) so a just-renamed entry's
        directory record is durable too. Best effort — platforms that
        cannot open a directory read-only simply skip it."""
        if os.name != "posix":  # pragma: no cover - platform dependent
            return
        try:
            fd = os.open(self.root, os.O_RDONLY)
        except OSError:  # pragma: no cover - unreadable store dir
            return
        try:
            os.fsync(fd)
        except OSError:  # pragma: no cover - fs without dir fsync
            pass
        finally:
            os.close(fd)

    def load(
        self, key: Tuple
    ) -> Optional[Tuple[Dict[str, np.ndarray], dict]]:
        """Read and verify one entry. Returns ``(arrays, meta)``, or
        ``None`` on a miss or *any* verification failure — version
        mismatch, key mismatch, payload-digest mismatch, or an unreadable
        file (which is deleted so it cannot fail every restart)."""
        path = self.path_for(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as npz:
                raw = npz.get(_META_KEY)
                if raw is None:
                    raise ValueError("missing header")
                header = json.loads(bytes(np.asarray(raw)).decode())
                arrays = {
                    n: npz[n] for n in npz.files if n != _META_KEY
                }
            if header.get("format_version") != FORMAT_VERSION:
                raise ValueError(
                    f"format version {header.get('format_version')!r}"
                )
            if header.get("key") != _key_repr(key):
                raise ValueError("key mismatch")
            meta = header.get("meta")
            if not isinstance(meta, dict):
                raise ValueError("bad meta")
            if header.get("digest") != _payload_digest(arrays, meta):
                raise ValueError("payload digest mismatch")
        except Exception:
            # Stale/corrupt/foreign: drop it (best effort) and rebuild.
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        # Refresh recency so cross-process eviction is LRU-ish.
        try:
            os.utime(path)
        except OSError:
            pass
        return arrays, meta

    # -- pattern-token alias index -----------------------------------------
    #
    # One tiny JSON file mapping pattern-token alias keys (their canonical
    # repr) to full plan keys, so a restarted worker resolves
    # ``spgemm_plan(..., pattern_token=)`` straight to a disk load without
    # ever paying the first COO digest. The index is an optimization with
    # last-writer-wins semantics across processes: a lost concurrent
    # update costs one digest on the next restart, never a wrong plan
    # (the aliased entry is still integrity-checked on load).

    def alias_path(self) -> str:
        return os.path.join(self.root, _ALIAS_FILE)

    def _read_aliases(self) -> Dict[str, str]:
        try:
            with open(self.alias_path(), "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {}
        if (
            not isinstance(doc, dict)
            or doc.get("format_version") != FORMAT_VERSION
            or not isinstance(doc.get("aliases"), dict)
        ):
            return {}  # version bump / corruption degrades to a miss
        return {
            str(t): str(k) for t, k in doc["aliases"].items()
        }

    def alias_get(self, token_repr: str) -> Optional[str]:
        """The full-key repr bound to one token-key repr, or ``None``.

        An alias whose target artifact file no longer exists (evicted or
        deleted out-of-band) is a **miss**, not a dangling pointer: the
        caller would pay a doomed ``store.load`` and then the digest path
        anyway, so resolve straight to the digest path instead. Orphans
        are reported and pruned by :meth:`audit`."""
        key_repr = self._read_aliases().get(token_repr)
        if key_repr is None:
            return None
        target = os.path.join(self.root, _file_name_for_repr(key_repr))
        if not os.path.exists(target):
            return None
        return key_repr

    def _write_aliases_locked(self, aliases: Dict[str, str]) -> bool:
        """Atomically replace the alias index (caller holds ``_lock``)."""
        doc = {"format_version": FORMAT_VERSION, "aliases": aliases}
        path = self.alias_path()
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}{_TMP}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._fsync_dir()
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        return True

    def alias_put(self, token_repr: str, key_repr: str) -> bool:
        """Bind (or re-confirm) one token alias; returns False if the
        write failed (persistence is an optimization, never fatal)."""
        with self._lock:
            aliases = self._read_aliases()
            if aliases.get(token_repr) == key_repr:
                return True
            aliases[token_repr] = key_repr
            return self._write_aliases_locked(aliases)

    def audit(self, prune: bool = True) -> dict:
        """Consistency report over the store directory.

        Cross-checks the token-alias index against the artifact files:
        an alias whose target file is gone (``_evict`` unlinks files but
        not their aliases; so does an out-of-band ``rm``) is *orphaned*.
        With ``prune=True`` (the default) orphaned aliases are removed
        from ``torch-tokens.index.json`` in one atomic rewrite.

        Returns ``{"files": int, "bytes": int, "aliases": int,
        "orphaned": [token_repr, ...], "pruned": bool}``; ``pruned`` is
        True only when an orphan was actually removed from disk."""
        with self._lock:
            aliases = self._read_aliases()
            orphaned = [
                tok for tok, key_repr in aliases.items()
                if not os.path.exists(
                    os.path.join(self.root, _file_name_for_repr(key_repr))
                )
            ]
            pruned = False
            if prune and orphaned:
                for tok in orphaned:
                    aliases.pop(tok, None)
                pruned = self._write_aliases_locked(aliases)
        return {
            "files": len(self.files()),
            "bytes": self.total_bytes(),
            "aliases": len(aliases),
            "orphaned": sorted(orphaned),
            "pruned": pruned,
        }

    # -- eviction ----------------------------------------------------------

    def _evict(self, keep: Optional[str] = None) -> None:
        """Delete oldest-used entries until under ``max_bytes``; ``keep``
        (the just-written file) is never deleted."""
        if self.max_bytes is None:
            return
        with self._lock:
            entries = []
            for p in self.files():
                try:
                    entries.append((p, os.path.getsize(p)))
                except OSError:
                    continue
            total = sum(s for _, s in entries)
            for p, size in entries:
                if total <= self.max_bytes:
                    break
                if p == keep:
                    continue
                try:
                    os.unlink(p)
                except OSError:
                    continue
                total -= size
                self.evictions += 1

    def clear(self) -> None:
        """Delete every entry (plans and the token-alias index),
        including orphaned temp files."""
        for p in self.files():
            try:
                os.unlink(p)
            except OSError:
                pass
        try:
            os.unlink(self.alias_path())
        except OSError:
            pass
        self._gc_stale_tmps(max_age_s=-1.0)  # all tmps, even fresh ones
