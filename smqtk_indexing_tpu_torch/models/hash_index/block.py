"""
BallTree-equivalent hash index: the port of
``smqtk_indexing_tpu/models/hash_index/block.py``.

Capability-parity with the reference's ``SkLearnBallTreeHashIndex``
(SMQTK-Indexing smqtk_indexing/impls/hash_index/sklearn_balltree.py:33-375):
same constructor surface (``cache_element``, ``leaf_size``,
``random_seed``), same build-dedup / update / remove / normalized-Hamming
``nn`` semantics. As in the JAX package, it runs the exact packed-code
scan of ``LinearHashIndex`` (shared base ``_base._CodeStoreHashIndex``):
a metric ball tree's pointer chasing suits neither the TPU nor the card,
and the scan is exact. ``leaf_size`` and ``random_seed`` are kept for
configuration parity and do nothing. The two classes stay distinct
plugins so that configurations written for either reference index
resolve here.
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
from smqtk_indexing_tpu_torch.ops.device import resolve_device


class BallTreeHashIndex (_CodeStoreHashIndex):
    """
    Hamming hash index with the reference BallTree configuration surface,
    executing as an exact packed-code scan.

    :param cache_element: Optional DataElement for write-through persistence.
    :param leaf_size: Accepted for parity with the reference's sklearn
        BallTree parameter (sklearn_balltree.py:96-104); the scan has no
        tree, so this affects nothing and is preserved in config
        round-trips.
    :param random_seed: Accepted for parity; unused (the scan is exact and
        deterministic).
    :param device: torch device of the codes: 'cuda' (default; raises
        when no card is present) or 'cpu'.
    """

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        c = super().get_default_config()
        c["cache_element"] = make_default_config(DataElement.get_impls())
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "BallTreeHashIndex":
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
                 leaf_size: int = 40,
                 random_seed: Optional[int] = None,
                 device: str = "cuda"):
        super().__init__()
        self.cache_element = cache_element
        self.leaf_size = leaf_size
        self.random_seed = random_seed
        self.device = str(resolve_device(device))
        self._init_store()

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        if self.cache_element is not None:
            c["cache_element"] = merge_dict(
                c["cache_element"], to_config_dict(self.cache_element))
        c["leaf_size"] = self.leaf_size
        c["random_seed"] = self.random_seed
        c["device"] = self.device
        return c
