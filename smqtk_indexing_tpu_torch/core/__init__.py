"""
Configuration and plugin layer: the port's own copy of
``smqtk_indexing_tpu/core/``, with the port's own plugin registry.
"""
from smqtk_indexing_tpu_torch.core.configuration import (  # noqa: F401
    Configurable,
    configuration_test_helper,
    from_config_dict,
    make_default_config,
    merge_dict,
    to_config_dict,
)
from smqtk_indexing_tpu_torch.core.plugin import NotUsableError, Pluggable  # noqa: F401
