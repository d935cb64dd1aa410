"""
Drop-in configuration adapter for the reference's FAISS wrapper, over the
port's indexes.

Port of ``smqtk_indexing_tpu/models/nn_index/faiss_compat.py:60-303``.
``FaissNearestNeighborsIndex`` here accepts the EXACT constructor/config
surface of the reference class of the same name (its
``smqtk_indexing/impls/nn_index/faiss.py:150-343``:
``factory_string``, ``metric_type`` label-or-int, ``ivf_nprobe``,
``use_gpu``/``gpu_id``, the three-store ``descriptor_set``/
``uid2idx_kvs``/``idx2uid_kvs`` layout, and the split
``index_element``/``index_param_element`` persistence), plus the port's
``device``, and serves it with the port's engines via the factory-string
mapping (models/nn_index/factory.py). A JSON config written for the
reference deserializes here unchanged — the literal "switch frameworks by
editing the plugin type name" path.

Differences, all surfaced rather than silent:

- ``use_gpu``/``gpu_id`` are accepted and ignored with a warning, as in
  the JAX package: ``device`` ('cuda' by default, 'cpu' for the kernels'
  plain versions) places the inner index, so ``use_gpu=False`` does not
  move it off the card, and ``gpu_id`` selects nothing (pass
  ``device='cuda:<i>'``).
- ``index_param_element`` persists the same parameter JSON the reference
  stores beside the index; on load a factory-string mismatch between the
  element and the instance logs a warning (reference behavior: the
  loaded index silently wins).
- ``metric_type`` integer constants follow the FAISS values
  (``METRIC_INNER_PRODUCT == 0``, ``METRIC_L2 == 1``); other constants
  raise ValueError like the reference's label check.
"""
from __future__ import annotations

import json
import logging
import warnings
from typing import Any, Dict, Hashable, Iterable, List, Optional, Sequence, Union

import torch

from smqtk_indexing_tpu_torch.core.configuration import (
    from_config_dict, make_default_config, merge_dict, to_config_dict,
)
from smqtk_indexing_tpu_torch.data.data_element import DataElement
from smqtk_indexing_tpu_torch.data.descriptor import (
    DescriptorElement, DescriptorSet, MemoryDescriptorSet,
)
from smqtk_indexing_tpu_torch.data.key_value import (
    KeyValueStore, MemoryKeyValueStore,
)
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex, NNResult,
)
from smqtk_indexing_tpu_torch.models.nn_index.factory import (
    index_from_factory_string,
)
from smqtk_indexing_tpu_torch.ops.device import device_report

LOG = logging.getLogger(__name__)

#: FAISS metric constants (faiss.py:51-67 introspects faiss.METRIC_*;
#: these two are the ones the reference wrapper actually supports).
_METRIC_CONST = {0: "inner_product", 1: "l2"}
_METRIC_LABELS = {"l2": "l2", "inner_product": "ip", "ip": "ip",
                  "cosine": "cosine", "euclidean": "l2"}


class FaissNearestNeighborsIndex (NearestNeighborsIndex):
    """
    Reference-config-compatible FAISS-wrapper adapter over the port's
    index implementations.

    :param device: torch device of the inner index: 'cuda' (default;
        raises when no card is present) or 'cpu'.

    >>> import numpy as np
    >>> from smqtk_indexing_tpu_torch.data.descriptor import (
    ...     DescriptorMemoryElement)
    >>> rng = np.random.default_rng(0)
    >>> els = [DescriptorMemoryElement(i, rng.normal(size=8)
    ...        .astype(np.float32)) for i in range(64)]
    >>> index = FaissNearestNeighborsIndex(factory_string="IDMap,Flat",
    ...                                    metric_type="l2", device="cpu")
    >>> index.build_index(els)
    >>> index.nn(els[4], 2)[0][0].uuid()
    4
    """

    # is_usable() keeps the default True: this module imports torch, so
    # the class exists only where torch imports. HOW it runs (CUDA kernels
    # or their plain CPU versions) is in usability_report().

    @classmethod
    def usability_report(cls) -> dict:
        r = super().usability_report()
        # The JAX adapter's switches (faiss_compat.py:245-251).
        r.update(device_report("cuda", flags=(
            "SMQTK_TPU_NO_DMA_IVF", "SMQTK_TPU_NO_FUSED")))
        return r

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        c = super().get_default_config()
        c["descriptor_set"] = make_default_config(DescriptorSet.get_impls())
        c["uid2idx_kvs"] = make_default_config(KeyValueStore.get_impls())
        c["idx2uid_kvs"] = make_default_config(KeyValueStore.get_impls())
        c["index_element"] = make_default_config(DataElement.get_impls())
        c["index_param_element"] = make_default_config(
            DataElement.get_impls())
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "FaissNearestNeighborsIndex":
        if merge_default:
            config_dict = merge_dict(cls.get_default_config(),
                                     dict(config_dict))
        cfg = dict(config_dict)
        ds_cfg = cfg.get("descriptor_set")
        if ds_cfg and ds_cfg.get("type"):
            cfg["descriptor_set"] = from_config_dict(
                ds_cfg, DescriptorSet.get_impls())
        else:
            cfg["descriptor_set"] = None
        for slot in ("uid2idx_kvs", "idx2uid_kvs"):
            sc = cfg.get(slot)
            if sc and sc.get("type"):
                cfg[slot] = from_config_dict(sc, KeyValueStore.get_impls())
            else:
                cfg[slot] = None
        for slot in ("index_element", "index_param_element"):
            sc = cfg.get(slot)
            if sc and sc.get("type"):
                cfg[slot] = from_config_dict(sc, DataElement.get_impls())
            else:
                cfg[slot] = None
        return super().from_config(cfg, False)

    def __init__(
        self,
        descriptor_set: Optional[DescriptorSet] = None,
        idx2uid_kvs: Optional[KeyValueStore] = None,
        uid2idx_kvs: Optional[KeyValueStore] = None,
        index_element: Optional[DataElement] = None,
        index_param_element: Optional[DataElement] = None,
        read_only: bool = False,
        factory_string: str = "IDMap,Flat",
        metric_type: Union[str, int] = "l2",
        ivf_nprobe: int = 1,
        use_gpu: bool = False,
        gpu_id: int = 0,
        random_seed: Optional[int] = None,
        device: str = "cuda",
    ):
        super().__init__()
        if not isinstance(factory_string, str):
            # Reference wording (faiss.py:254-256).
            raise ValueError("The factory_string parameter must be a "
                             "recognized string type.")
        if isinstance(metric_type, int):
            if metric_type not in _METRIC_CONST:
                raise ValueError(
                    f"Given metric type value of '{metric_type}' "
                    f"({type(metric_type)}) did not match a valid key "
                    "nor a valid integer constant value. Valid labels "
                    f"are {sorted(_METRIC_LABELS)} and valid integers "
                    f"are {sorted(_METRIC_CONST)}.")
            self._metric_label = _METRIC_CONST[metric_type]
        else:
            if str(metric_type).lower() not in _METRIC_LABELS:
                raise ValueError(
                    f"Given metric type value of '{metric_type}' "
                    f"({type(metric_type)}) did not match a valid key "
                    "nor a valid integer constant value. Valid labels "
                    f"are {sorted(_METRIC_LABELS)} and valid integers "
                    f"are {sorted(_METRIC_CONST)}.")
            self._metric_label = str(metric_type).lower()
        if int(ivf_nprobe) < 1:
            raise ValueError("ivf_nprobe must be >= 1.")
        if use_gpu:
            warnings.warn(
                "use_gpu/gpu_id are ignored: the index is placed by its "
                "'device' argument (default 'cuda'; 'cuda:<i>' picks a "
                "card).")

        self.descriptor_set = descriptor_set if descriptor_set is not None \
            else MemoryDescriptorSet()
        self.uid2idx_kvs = uid2idx_kvs if uid2idx_kvs is not None \
            else MemoryKeyValueStore()
        self.idx2uid_kvs = idx2uid_kvs if idx2uid_kvs is not None \
            else MemoryKeyValueStore()
        self.index_element = index_element
        self.index_param_element = index_param_element
        self.read_only = bool(read_only)
        self.factory_string = factory_string
        self.metric_type = metric_type
        self.ivf_nprobe = int(ivf_nprobe)
        self.use_gpu = bool(use_gpu)
        self.gpu_id = int(gpu_id)
        self.random_seed = random_seed
        self.device = str(torch.device(device))

        metric = _METRIC_LABELS[self._metric_label]
        kwargs: Dict[str, Any] = dict(
            descriptor_set=self.descriptor_set,
            index_element=self.index_element,
            read_only=self.read_only,
            uid2idx_kvs=self.uid2idx_kvs,
            idx2uid_kvs=self.idx2uid_kvs,
            device=self.device,
        )
        if random_seed is not None \
                and "ivf" in factory_string.lower():
            # Only the coarse-quantized impls take a seed (k-means);
            # the flat tiers are deterministic.
            kwargs["random_seed"] = int(random_seed)
        self._inner = index_from_factory_string(
            factory_string, metric=metric, **kwargs)
        if hasattr(self._inner, "nprobe"):
            self._inner.nprobe = self.ivf_nprobe
        self._check_param_element()

    # -- persistence of the parameter side-element ----------------------
    def _params(self) -> Dict[str, Any]:
        return {"factory_string": self.factory_string,
                "metric_type": self.metric_type,
                "ivf_nprobe": self.ivf_nprobe,
                "read_only": self.read_only,
                "random_seed": self.random_seed}

    def _check_param_element(self) -> None:
        e = self.index_param_element
        if e is None or e.is_empty():
            return
        try:
            saved = json.loads(e.get_bytes().decode())
        except Exception:
            LOG.warning("Unreadable index_param_element; ignoring.")
            return
        if saved.get("factory_string") not in (None, self.factory_string):
            LOG.warning(
                "index_param_element was written for factory_string %r; "
                "instance is configured with %r.",
                saved.get("factory_string"), self.factory_string)

    def _save_params(self) -> None:
        e = self.index_param_element
        if e is None:
            return
        if not e.is_read_only():
            e.set_bytes(json.dumps(self._params()).encode())

    # -- config ----------------------------------------------------------
    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        c["descriptor_set"] = merge_dict(
            c["descriptor_set"], to_config_dict(self.descriptor_set))
        c["uid2idx_kvs"] = merge_dict(
            c["uid2idx_kvs"], to_config_dict(self.uid2idx_kvs))
        c["idx2uid_kvs"] = merge_dict(
            c["idx2uid_kvs"], to_config_dict(self.idx2uid_kvs))
        if self.index_element is not None:
            c["index_element"] = merge_dict(
                c["index_element"], to_config_dict(self.index_element))
        if self.index_param_element is not None:
            c["index_param_element"] = merge_dict(
                c["index_param_element"],
                to_config_dict(self.index_param_element))
        c.update({
            "factory_string": self.factory_string,
            "metric_type": self.metric_type,
            "ivf_nprobe": self.ivf_nprobe,
            "read_only": self.read_only,
            "random_seed": self.random_seed,
            "use_gpu": self.use_gpu,
            "gpu_id": self.gpu_id,
            "device": self.device,
        })
        return c

    # -- index API (delegation) -------------------------------------------
    def count(self) -> int:
        return self._inner.count()

    def _sync_nprobe(self) -> None:
        # ivf_nprobe is the reference's query-time tunable; honor live
        # attribute changes the way the reference honors nprobe on a
        # loaded IVF index (faiss.py:715-749).
        if hasattr(self._inner, "nprobe"):
            self._inner.nprobe = int(self.ivf_nprobe)

    def _build_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        self._inner.build_index(descriptors)
        self._save_params()

    def _update_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        self._inner.update_index(descriptors)
        self._save_params()

    def _remove_from_index(self, uids: Iterable[Hashable]) -> None:
        self._inner.remove_from_index(uids)
        self._save_params()

    def _nn(self, d: DescriptorElement, n: int = 1) -> NNResult:
        self._sync_nprobe()
        return self._inner._nn(d, n)

    def _nn_many(self, ds: Sequence[DescriptorElement],
                 n: int = 1) -> List[NNResult]:
        self._sync_nprobe()
        return self._inner._nn_many(ds, n)
