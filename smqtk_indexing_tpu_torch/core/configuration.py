"""
JSON-configuration introspection layer.

Contract-equivalent to ``smqtk_core.Configurable`` plus the helper functions
from ``smqtk_core.configuration`` that the reference implementations use for
nested plugin configuration (SMQTK-Indexing smqtk_indexing/impls/nn_index/lsh.py:18-23):
``make_default_config`` / ``from_config_dict`` / ``to_config_dict`` /
``merge_dict``, and the ``configuration_test_helper`` the reference test suite
round-trips every implementation through
(SMQTK-Indexing tests/impls/nn_index/test_lsh.py:12,69).
"""
from __future__ import annotations

import abc
import inspect
import json
from typing import Any, Dict, Iterable, Tuple, Type, TypeVar

T = TypeVar("T", bound="Configurable")


def merge_dict(a: Dict, b: Dict, deep_copy: bool = False) -> Dict:
    """
    Recursively merge dictionary ``b`` into dictionary ``a``, in place,
    returning ``a``. Nested dicts merge recursively; all other values from
    ``b`` overwrite.
    """
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(a.get(k), dict):
            merge_dict(a[k], v, deep_copy)
        else:
            if deep_copy:
                v = json.loads(json.dumps(v)) if isinstance(v, (dict, list)) else v
            a[k] = v
    return a


class Configurable (metaclass=abc.ABCMeta):
    """
    Mixin for classes constructible from a JSON-compliant configuration
    dictionary introspected from the constructor signature.
    """

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        """
        Generate and return a default configuration dictionary for this class
        by introspecting the constructor's parameters: each argument name
        becomes a key, with its default value (or None if no default).
        """
        sig = inspect.signature(cls.__init__)
        cfg: Dict[str, Any] = {}
        for name, param in sig.parameters.items():
            if name == "self":
                continue
            if param.kind in (inspect.Parameter.VAR_POSITIONAL,
                              inspect.Parameter.VAR_KEYWORD):
                continue
            if param.default is inspect.Parameter.empty:
                cfg[name] = None
            else:
                cfg[name] = param.default
        return cfg

    @classmethod
    def from_config(
        cls: Type[T],
        config_dict: Dict,
        merge_default: bool = True
    ) -> T:
        """
        Instantiate a new instance of this class from a configuration
        dictionary. When ``merge_default``, the given configuration is merged
        on top of ``get_default_config()``.
        """
        if merge_default:
            config_dict = merge_dict(cls.get_default_config(), dict(config_dict))
        return cls(**config_dict)  # type: ignore[call-arg]

    @abc.abstractmethod
    def get_config(self) -> Dict[str, Any]:
        """
        :return: JSON-compliant dictionary that could be passed to this
            class's ``from_config`` to produce an equivalent instance.
        """


def cls_conf_key(cls: type) -> str:
    """Configuration key for a class: its fully-qualified name."""
    return f"{cls.__module__}.{cls.__name__}"


def make_default_config(configurable_iter: Iterable[type]) -> Dict[str, Any]:
    """
    Generate the nested plugin-selection default configuration block for a set
    of Configurable implementation types::

        {"type": None,
         "<module>.<ClassName>": {<that class's default config>}, ...}
    """
    cfg: Dict[str, Any] = {"type": None}
    for impl in configurable_iter:
        try:
            cfg[cls_conf_key(impl)] = impl.get_default_config()
        except Exception:  # pragma: no cover - defensive vs bad plugins
            pass
    return cfg


def to_config_dict(instance: Configurable) -> Dict[str, Any]:
    """
    Wrap an instance's configuration into the plugin-selection block format::

        {"type": "<module>.<ClassName>",
         "<module>.<ClassName>": {<instance config>}}
    """
    key = cls_conf_key(type(instance))
    return {"type": key, key: instance.get_config()}


def from_config_dict(
    config: Dict[str, Any],
    type_iter: Iterable[type],
) -> Any:
    """
    Instantiate the implementation selected by ``config['type']`` from the
    given candidate types, using the nested configuration block under that
    type's key.

    :raises ValueError: ``type`` field missing, or does not match a provided
        candidate type.
    """
    if "type" not in config:
        raise ValueError("Configuration dictionary given does not have an "
                         "implementation type specification.")
    sel = config["type"]
    type_map = {cls_conf_key(t): t for t in type_iter}
    # Also accept bare class names for convenience.
    name_map = {t.__name__: t for t in type_iter}
    cls = type_map.get(sel) or name_map.get(sel)
    if cls is None:
        raise ValueError(
            f"Implementation type specification '{sel}' does not match any "
            f"candidate types: {sorted(type_map)}"
        )
    inner = config.get(sel, config.get(cls.__name__, {}))
    return cls.from_config(inner)


def configuration_test_helper(
    inst: Configurable,
    config_ignored_params: frozenset = frozenset(),
    from_config_args: Tuple = (),
) -> list:
    """
    Test helper round-tripping an instance through the configuration API, the
    same checks the reference suite applies to every implementation:

    1. ``get_config`` returns a dict whose keys (minus ignored params) cover
       the constructor parameters.
    2. ``from_config(inst.get_config())`` constructs successfully, with and
       without default-merging.
    3. The round-tripped instances report an equal configuration.

    :return: List of instances constructed during the check:
        ``[inst, via merge_default=True, via merge_default=False]``.
    """
    cls = type(inst)
    inst_config = inst.get_config()
    assert isinstance(inst_config, dict), "get_config did not return a dict"

    default_config = cls.get_default_config()
    param_keys = set(default_config) - set(config_ignored_params)
    missing = param_keys - set(inst_config)
    assert not missing, (
        f"get_config() of {cls.__name__} missing constructor parameter keys: "
        f"{sorted(missing)}"
    )

    inst_merge = cls.from_config(inst_config, *from_config_args) \
        if from_config_args else cls.from_config(inst_config, True)
    inst_nomerge = cls.from_config(inst_config, False) \
        if not from_config_args else inst_merge

    for other in (inst_merge, inst_nomerge):
        assert other.get_config() == inst_config, (
            f"Round-tripped configuration of {cls.__name__} differs:\n"
            f"  original: {inst_config}\n  round-trip: {other.get_config()}"
        )
    return [inst, inst_merge, inst_nomerge]
