"""
Byte-blob persistence abstraction: minimal equivalent of
``smqtk_dataprovider.DataElement`` (used for model/index checkpointing by the
reference, e.g. SMQTK-Indexing smqtk_indexing/impls/nn_index/faiss.py:17-22).
Two implementations: in-memory bytes and a filesystem-backed element.
"""
from __future__ import annotations

import abc
import os
from typing import Any, Dict, Optional

from smqtk_indexing_tpu_torch.core.configuration import Configurable
from smqtk_indexing_tpu_torch.core.plugin import Pluggable
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError


class DataElement (Configurable, Pluggable, metaclass=abc.ABCMeta):
    """Abstract byte-blob container with writability semantics."""

    @abc.abstractmethod
    def is_empty(self) -> bool:
        """:return: Whether this element currently holds zero bytes."""

    @abc.abstractmethod
    def get_bytes(self) -> bytes:
        """:return: The byte content of this element."""

    @abc.abstractmethod
    def writable(self) -> bool:
        """:return: Whether ``set_bytes`` is permitted."""

    @abc.abstractmethod
    def set_bytes(self, b: bytes) -> None:
        """
        Overwrite this element's content.

        :raises ReadOnlyError: This element is not writable.
        """

    def is_read_only(self) -> bool:
        return not self.writable()


class DataMemoryElement (DataElement):
    """In-memory byte buffer element."""

    def __init__(self, bytes: Optional[bytes] = None,  # noqa: A002
                 readonly: bool = False):
        super().__init__()
        self._bytes = bytes if bytes is not None else b""
        self._readonly = bool(readonly)

    def get_config(self) -> Dict[str, Any]:
        return {
            # bytes are not JSON; expose latin-1 round-trippable string
            "bytes": self._bytes.decode("latin-1") if self._bytes else None,
            "readonly": self._readonly,
        }

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "DataMemoryElement":
        cfg = dict(config_dict)
        b = cfg.get("bytes")
        if isinstance(b, str):
            cfg["bytes"] = b.encode("latin-1")
        return cls(**cfg)

    def is_empty(self) -> bool:
        return not self._bytes

    def get_bytes(self) -> bytes:
        return self._bytes

    def writable(self) -> bool:
        return not self._readonly

    def set_bytes(self, b: bytes) -> None:
        if self._readonly:
            raise ReadOnlyError(f"{self} is read-only.")
        self._bytes = bytes(b)

    def __repr__(self) -> str:
        return f"DataMemoryElement(len={len(self._bytes)}, readonly={self._readonly})"


class DataFileElement (DataElement):
    """Filesystem-backed byte element."""

    def __init__(self, filepath: str, readonly: bool = False):
        super().__init__()
        self._filepath = filepath
        self._readonly = bool(readonly)

    def get_config(self) -> Dict[str, Any]:
        return {"filepath": self._filepath, "readonly": self._readonly}

    def is_empty(self) -> bool:
        return not (os.path.isfile(self._filepath)
                    and os.path.getsize(self._filepath) > 0)

    def get_bytes(self) -> bytes:
        if not os.path.isfile(self._filepath):
            return b""
        with open(self._filepath, "rb") as f:
            return f.read()

    def writable(self) -> bool:
        if self._readonly:
            return False
        if os.path.isfile(self._filepath):
            return os.access(self._filepath, os.W_OK)
        parent = os.path.dirname(os.path.abspath(self._filepath))
        return os.access(parent, os.W_OK)

    def set_bytes(self, b: bytes) -> None:
        if not self.writable():
            raise ReadOnlyError(f"{self} is read-only.")
        with open(self._filepath, "wb") as f:
            f.write(b)

    def __repr__(self) -> str:
        return f"DataFileElement({self._filepath!r})"


def from_uri(uri: str) -> DataElement:
    """
    Construct a DataElement from a URI string (equivalent of
    ``smqtk_dataprovider.from_uri`` as used by the reference FLANN impl,
    SMQTK-Indexing smqtk_indexing/impls/nn_index/flann.py:113-129).

    Supported: ``file://<path>`` or a bare filesystem path.
    """
    if uri.startswith("file://"):
        return DataFileElement(uri[len("file://"):])
    return DataFileElement(uri)
