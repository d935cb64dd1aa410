"""
Plugin discovery layer: the port's own copy of
``smqtk_indexing_tpu/core/plugin.py``, with the port's own registry.

Equivalent in contract to ``smqtk_core.Pluggable`` as used by the reference
interfaces (SMQTK-Indexing smqtk_indexing/interfaces/nearest_neighbor_index.py:8,13):
``get_impls()`` returns the set of usable, concrete implementation classes of
an interface, discovered both from imported subclasses and from installed
distributions exposing the ``smqtk_plugins`` entry-point group
(SMQTK-Indexing pyproject.toml:71-82).
"""
from __future__ import annotations

import abc
import importlib
import inspect
import logging
from typing import Set, Type, TypeVar

LOG = logging.getLogger(__name__)

P = TypeVar("P", bound="Pluggable")

# Entry-point group name kept identical to the reference ecosystem so plugin
# packages written against SMQTK register the same way here.
PLUGIN_ENTRYPOINT_GROUP = "smqtk_plugins"

# The port's modules that provide implementations. Imported lazily on the
# first get_impls() call so that subclass discovery sees them without
# requiring the distribution to be installed (entry points only resolve for
# installed packages). Only modules the port has are listed.
_BUILTIN_IMPL_MODULES = (
    "smqtk_indexing_tpu_torch.models.nn_index.flat",
    "smqtk_indexing_tpu_torch.models.nn_index.ivf",
    "smqtk_indexing_tpu_torch.models.nn_index.lsh",
    "smqtk_indexing_tpu_torch.models.nn_index.mrpt",
    "smqtk_indexing_tpu_torch.models.nn_index.faiss_compat",
    "smqtk_indexing_tpu_torch.models.nn_index.autotune",
    "smqtk_indexing_tpu_torch.models.hash_index.linear",
    "smqtk_indexing_tpu_torch.models.hash_index.block",
    "smqtk_indexing_tpu_torch.models.lsh_functor.itq",
    "smqtk_indexing_tpu_torch.models.lsh_functor.simple_rp",
    "smqtk_indexing_tpu_torch.data.data_element",
    "smqtk_indexing_tpu_torch.data.descriptor",
    "smqtk_indexing_tpu_torch.data.key_value",
)

#: Entry points are loaded only under this prefix. The group is shared with
#: the JAX package, whose entries import jax; their classes subclass the
#: JAX package's interfaces, so they could never be this registry's impls.
_ENTRYPOINT_PREFIX = "smqtk_indexing_tpu_torch."

_discovery_done = False


def _run_discovery() -> None:
    """Import the built-in impl modules and the port's ``smqtk_plugins``
    entry points."""
    global _discovery_done
    if _discovery_done:
        return
    _discovery_done = True
    for mod in _BUILTIN_IMPL_MODULES:
        try:
            importlib.import_module(mod)
        except Exception:  # pragma: no cover - defensive
            LOG.warning("Failed importing built-in plugin module %s", mod,
                        exc_info=True)
    try:
        from importlib import metadata
        eps = metadata.entry_points()
        group = [ep for ep in eps.select(group=PLUGIN_ENTRYPOINT_GROUP)
                 if ep.value.startswith(_ENTRYPOINT_PREFIX)]
        for ep in group:
            try:
                ep.load()
            except Exception:  # pragma: no cover - third-party plugin failure
                LOG.warning("Failed loading plugin entry point %s", ep,
                            exc_info=True)
    except Exception:  # pragma: no cover
        LOG.debug("Entry-point discovery unavailable", exc_info=True)


class NotUsableError (Exception):
    """
    Raised when a Pluggable implementation is constructed or used but is not
    usable in the current environment (``is_usable() == False``).
    """


class Pluggable (metaclass=abc.ABCMeta):
    """
    Interface mixin providing implementation discovery.

    Mirrors the behavioral contract of ``smqtk_core.Pluggable``: every
    interface inheriting this gains ``get_impls()`` (set of concrete, usable
    subclasses) and the ``is_usable()`` environment gate honored by it
    (reference usage: SMQTK-Indexing smqtk_indexing/impls/nn_index/faiss.py:86-89).
    """

    def __init__(self) -> None:
        if not self.is_usable():
            raise NotUsableError(
                f"Implementation class '{type(self).__name__}' is not "
                "currently usable."
            )

    @classmethod
    def is_usable(cls) -> bool:
        """
        :return: Whether this implementation is available for use in the
            current environment. Default True; implementations with optional
            dependencies override this.
        """
        return True

    @classmethod
    def usability_report(cls) -> dict:
        """
        Detailed availability/capability report for this implementation.

        ``is_usable()`` answers only "can it run at all"; this answers
        "HOW will it run" — compute-backed impls extend it with their
        backend, kernel tier ('cuda' vs 'cpu-reference'), any
        env-flag-disabled engines, and a summary ``degraded`` bool, so a
        service operator can distinguish the hand-written kernels from the
        plain PyTorch versions before taking traffic (the reference's
        availability gate pattern, faiss.py:86-89, extended to degraded
        modes the boolean cannot express).

        :return: dict with at least ``class`` and ``usable``.
        """
        return {"class": cls.__name__, "usable": cls.is_usable()}

    @classmethod
    def get_impls(cls: Type[P]) -> Set[Type[P]]:
        """
        Discover and return concrete, usable implementation classes of this
        interface type.

        :return: Set of implementation class types.
        """
        _run_discovery()
        impls: Set[Type[P]] = set()
        stack = list(cls.__subclasses__())
        seen = set()
        while stack:
            sub = stack.pop()
            if sub in seen:
                continue
            seen.add(sub)
            stack.extend(sub.__subclasses__())
            if inspect.isabstract(sub):
                continue
            try:
                usable = sub.is_usable()
            except Exception:  # pragma: no cover - defensive
                usable = False
            if usable:
                impls.add(sub)
        return impls
