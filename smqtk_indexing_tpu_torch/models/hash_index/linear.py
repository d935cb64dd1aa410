"""
Brute-force Hamming-distance hash index on a CUDA device: the port of
``smqtk_indexing_tpu/models/hash_index/linear.py``.

Capability-parity with the reference's ``LinearHashIndex`` (SMQTK-Indexing
smqtk_indexing/impls/hash_index/linear.py:28-244), which keeps a
``set[int]`` of arbitrary-precision codes and heap-scans with a Python
popcount. Here the unique codes live on ``device`` as packed words and a
query runs ``ops/hamming.CodeStore``'s routes (the ±1 route through K1's
bf16 form from 16,384 codes on). Distances returned are normalized by the
query bit length into [0, 1] (reference linear.py:243).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from smqtk_indexing_tpu_torch.core.configuration import (
    from_config_dict, make_default_config, merge_dict, to_config_dict,
)
from smqtk_indexing_tpu_torch.data.data_element import DataElement
from smqtk_indexing_tpu_torch.models.hash_index._base import (
    _CodeStoreHashIndex,
)
from smqtk_indexing_tpu_torch.parallel.mesh import device_config, mesh_for


class LinearHashIndex (_CodeStoreHashIndex):
    """
    Exhaustive Hamming search over unique hash codes.

    :param cache_element: Optional DataElement to persist index state to
        (write-through on every mutation; auto-loaded at construction —
        reference cache semantics, linear.py:121-142). The payload is the
        JAX index's: either package loads the other's.
    :param n_devices: Row-shard the packed codes across this many devices
        (a power of two); queries run the per-shard Hamming scan and the
        k-sized merge (``parallel/sharded_scan.py``). None or 1: one
        device.
    :param device: torch device of the codes: 'cuda' (default; raises
        when no card is present) or 'cpu'. With ``n_devices=n``: 'cuda'
        is cards 0 .. n-1, 'cpu' n CPU shards, and a list of n device
        strings places each shard.
    """

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        c = super().get_default_config()
        c["cache_element"] = make_default_config(DataElement.get_impls())
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "LinearHashIndex":
        if merge_default:
            config_dict = merge_dict(cls.get_default_config(),
                                     dict(config_dict))
        cfg = dict(config_dict)
        ce = cfg.get("cache_element")
        if ce and ce.get("type"):
            cfg["cache_element"] = from_config_dict(
                ce, DataElement.get_impls())
        else:
            cfg["cache_element"] = None
        return super().from_config(cfg, False)

    def __init__(self, cache_element: Optional[DataElement] = None,
                 n_devices: Optional[int] = None, device: str = "cuda"):
        super().__init__()
        self.cache_element = cache_element
        self.n_devices = n_devices
        self.device = device_config(device)
        self._mesh = mesh_for(n_devices, device)
        self._init_store()

    def _make_mesh(self):
        return self._mesh

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        if self.cache_element is not None:
            c["cache_element"] = merge_dict(
                c["cache_element"], to_config_dict(self.cache_element))
        c["n_devices"] = self.n_devices
        c["device"] = self.device
        return c
