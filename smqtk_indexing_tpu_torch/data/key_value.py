"""
Key-value store abstraction (the port's own copy of
``smqtk_indexing_tpu/data/key_value.py``): minimal equivalent of
``smqtk_dataprovider.KeyValueStore`` (reference usage for hash->UID-set and
UID<->row mappings, SMQTK-Indexing smqtk_indexing/impls/nn_index/faiss.py:260-274,
lsh.py hash2uuids store).
"""
from __future__ import annotations

import abc
import io
import os
import pickle
import warnings
from typing import Any, Dict, Hashable, Iterable, Iterator, Mapping

from smqtk_indexing_tpu_torch.core.configuration import Configurable
from smqtk_indexing_tpu_torch.core.plugin import Pluggable
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError

_SENTINEL = object()

#: The JAX package's data layer. A store it wrote pickles descriptor and data
#: elements under these module names; they load as the port's classes.
_JAX_DATA = "smqtk_indexing_tpu.data"


class _Unpickler (pickle.Unpickler):
    """Reads a record log written by either package: classes of the JAX
    package's data layer resolve to the port's copies of them, so loading
    never imports ``smqtk_indexing_tpu`` (whose other modules import
    jax)."""

    def find_class(self, module: str, name: str) -> Any:
        if module == _JAX_DATA or module.startswith(_JAX_DATA + "."):
            module = "smqtk_indexing_tpu_torch.data" + module[len(_JAX_DATA):]
        return super().find_class(module, name)


class KeyValueStore (Configurable, Pluggable, metaclass=abc.ABCMeta):
    """Abstract key-value storage with batch operations."""

    def __len__(self) -> int:
        return self.count()

    def __contains__(self, key: Hashable) -> bool:
        return self.has(key)

    @abc.abstractmethod
    def is_read_only(self) -> bool: ...

    @abc.abstractmethod
    def count(self) -> int: ...

    @abc.abstractmethod
    def keys(self) -> Iterator[Hashable]: ...

    @abc.abstractmethod
    def values(self) -> Iterator[Any]: ...

    @abc.abstractmethod
    def has(self, key: Hashable) -> bool: ...

    @abc.abstractmethod
    def add(self, key: Hashable, value: Any) -> "KeyValueStore":
        """:raises ReadOnlyError: store is read-only."""

    @abc.abstractmethod
    def add_many(self, d: Mapping[Hashable, Any]) -> "KeyValueStore":
        """:raises ReadOnlyError: store is read-only."""

    @abc.abstractmethod
    def remove(self, key: Hashable) -> "KeyValueStore":
        """
        :raises ReadOnlyError: store is read-only.
        :raises KeyError: key not present.
        """

    @abc.abstractmethod
    def remove_many(self, keys: Iterable[Hashable]) -> "KeyValueStore":
        """
        :raises ReadOnlyError: store is read-only.
        :raises KeyError: any key not present; store not modified.
        """

    @abc.abstractmethod
    def get(self, key: Hashable, default: Any = _SENTINEL) -> Any:
        """:raises KeyError: key not present and no default given."""

    def get_many(self, keys: Iterable[Hashable],
                 default: Any = _SENTINEL) -> Iterator[Any]:
        for k in keys:
            yield self.get(k, default)

    @abc.abstractmethod
    def clear(self) -> "KeyValueStore":
        """:raises ReadOnlyError: store is read-only."""


class MemoryKeyValueStore (KeyValueStore):
    """In-memory dict-backed key-value store."""

    def __init__(self) -> None:
        super().__init__()
        self._table: Dict[Hashable, Any] = {}

    def get_config(self) -> Dict[str, Any]:
        return {}

    def is_read_only(self) -> bool:
        return False

    def count(self) -> int:
        return len(self._table)

    def keys(self) -> Iterator[Hashable]:
        return iter(self._table.keys())

    def values(self) -> Iterator[Any]:
        return iter(self._table.values())

    def has(self, key: Hashable) -> bool:
        return key in self._table

    def add(self, key: Hashable, value: Any) -> "MemoryKeyValueStore":
        if self.is_read_only():
            raise ReadOnlyError(f"{self} is read-only.")
        self._table[key] = value
        return self

    def add_many(self, d: Mapping[Hashable, Any]) -> "MemoryKeyValueStore":
        if self.is_read_only():
            raise ReadOnlyError(f"{self} is read-only.")
        self._table.update(d)
        return self

    def remove(self, key: Hashable) -> "MemoryKeyValueStore":
        if self.is_read_only():
            raise ReadOnlyError(f"{self} is read-only.")
        del self._table[key]
        return self

    def remove_many(self, keys: Iterable[Hashable]) -> "MemoryKeyValueStore":
        if self.is_read_only():
            raise ReadOnlyError(f"{self} is read-only.")
        keys = list(keys)
        for k in keys:
            if k not in self._table:
                raise KeyError(k)
        for k in keys:
            del self._table[k]
        return self

    def get(self, key: Hashable, default: Any = _SENTINEL) -> Any:
        if key in self._table:
            return self._table[key]
        if default is _SENTINEL:
            raise KeyError(key)
        return default

    def clear(self) -> "MemoryKeyValueStore":
        if self.is_read_only():
            raise ReadOnlyError(f"{self} is read-only.")
        self._table.clear()
        return self


class FileKeyValueStore (KeyValueStore):
    """Durable key-value store backed by an append-only record log.

    Fills the persistent-KVS role of the reference's three-store layout
    (the reference keeps uid<->idx maps and LSH ``hash2uuids`` in pluggable
    KeyValueStore instances persisted OUTSIDE the index payload —
    SMQTK-Indexing smqtk_indexing/impls/nn_index/faiss.py:260-274,
    lsh.py:160-234; disk-backed store impls come from smqtk-dataprovider).

    Every mutation appends one pickled ``(op, payload)`` record, so the
    O(delta) incremental uid-mirror sync (`models/nn_index/_kvs.py`) costs
    O(delta) bytes of IO, not a full-table rewrite. The full table is kept
    in memory (these stores hold mappings, not vectors). When dead records
    outnumber live keys by ``compact_factor`` the log is rewritten as a
    single snapshot record via an atomic ``os.replace``.

    Values go through ``pickle`` — same trust model as the reference's
    pickled index caches (only load files you wrote).
    """

    #: Log record opcodes: batch-add (a dict), batch-remove (a key list),
    #: clear (payload ignored).
    _OP_ADD, _OP_DEL, _OP_CLEAR = "A", "D", "C"

    def __init__(self, filepath: str, readonly: bool = False,
                 compact_factor: int = 4) -> None:
        super().__init__()
        self._filepath = str(filepath)
        self._readonly = bool(readonly)
        self._compact_factor = max(int(compact_factor), 1)
        self._table: Dict[Hashable, Any] = {}
        #: count of keys written by records that are no longer live
        #: (overwritten, removed, or cleared) — drives compaction.
        self._dead = 0
        if os.path.isfile(self._filepath) \
                and os.path.getsize(self._filepath):
            self._replay()

    def get_config(self) -> Dict[str, Any]:
        return {"filepath": self._filepath, "readonly": self._readonly,
                "compact_factor": self._compact_factor}

    def _replay(self) -> None:
        live: Dict[Hashable, Any] = {}
        dead = 0
        size = os.path.getsize(self._filepath)
        good = 0  # byte offset just past the last intact record
        tail_err = None
        with open(self._filepath, "rb") as f:
            unpickler = _Unpickler(f)
            while True:
                try:
                    op, payload = unpickler.load()
                    if op == self._OP_ADD:
                        dead += sum(1 for k in payload if k in live)
                        live.update(payload)
                    elif op == self._OP_DEL:
                        for k in payload:
                            if k in live:
                                del live[k]
                                dead += 1
                    elif op == self._OP_CLEAR:
                        dead += len(live)
                        live.clear()
                    else:
                        raise ValueError(f"unknown log opcode {op!r}")
                except EOFError:
                    break
                except Exception as ex:  # torn/corrupt record
                    tail_err = ex
                    break
                good = f.tell()
        if good < size:
            # Torn tail: a mutation was interrupted mid-append (or the
            # tail was otherwise corrupted). Keep every record before
            # it; truncate the log back to the last intact boundary so
            # future appends extend a valid stream (reference parity:
            # the post-load consistency-check-and-recover behavior of
            # faiss.py:426-438).
            warnings.warn(
                f"FileKeyValueStore log {self._filepath!r} has a "
                f"corrupt/torn tail at byte {good} of {size} "
                f"({type(tail_err).__name__ if tail_err is not None else 'EOFError'}: {tail_err}); "
                f"recovered {len(live)} live key(s)"
                + ("" if self._readonly
                   else " and truncated the damaged tail"))
            if not self._readonly:
                os.truncate(self._filepath, good)
        self._table = live
        self._dead = dead

    def _append(self, op: str, payload: Any) -> None:
        buf = io.BytesIO()
        pickle.dump((op, payload), buf, protocol=pickle.HIGHEST_PROTOCOL)
        with open(self._filepath, "ab") as f:
            f.write(buf.getvalue())

    def _maybe_compact(self) -> None:
        if self._dead <= self._compact_factor * max(len(self._table), 1):
            return
        tmp = self._filepath + ".compact.tmp"
        with open(tmp, "wb") as f:
            pickle.dump((self._OP_ADD, self._table), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self._filepath)
        self._dead = 0

    def is_read_only(self) -> bool:
        return self._readonly

    def count(self) -> int:
        return len(self._table)

    def keys(self) -> Iterator[Hashable]:
        return iter(self._table.keys())

    def values(self) -> Iterator[Any]:
        return iter(self._table.values())

    def has(self, key: Hashable) -> bool:
        return key in self._table

    def add(self, key: Hashable, value: Any) -> "FileKeyValueStore":
        return self.add_many({key: value})

    def add_many(self, d: Mapping[Hashable, Any]) -> "FileKeyValueStore":
        if self.is_read_only():
            raise ReadOnlyError(f"{self} is read-only.")
        d = dict(d)
        if not d:
            return self
        self._append(self._OP_ADD, d)
        self._dead += sum(1 for k in d if k in self._table)
        self._table.update(d)
        self._maybe_compact()
        return self

    def remove(self, key: Hashable) -> "FileKeyValueStore":
        return self.remove_many((key,))

    def remove_many(self, keys: Iterable[Hashable]) -> "FileKeyValueStore":
        if self.is_read_only():
            raise ReadOnlyError(f"{self} is read-only.")
        keys = list(keys)
        for k in keys:
            if k not in self._table:
                raise KeyError(k)
        if not keys:
            return self
        self._append(self._OP_DEL, keys)
        for k in keys:
            del self._table[k]
        self._dead += len(keys)
        self._maybe_compact()
        return self

    def get(self, key: Hashable, default: Any = _SENTINEL) -> Any:
        if key in self._table:
            return self._table[key]
        if default is _SENTINEL:
            raise KeyError(key)
        return default

    def clear(self) -> "FileKeyValueStore":
        if self.is_read_only():
            raise ReadOnlyError(f"{self} is read-only.")
        # A clear invalidates the whole log — truncate instead of append
        # (atomic replace with an empty snapshot).
        tmp = self._filepath + ".compact.tmp"
        with open(tmp, "wb") as f:
            pass
        os.replace(tmp, self._filepath)
        self._table.clear()
        self._dead = 0
        return self

    def __repr__(self) -> str:
        return (f"FileKeyValueStore(filepath={self._filepath!r}, "
                f"n={len(self._table)})")
