"""
The descriptor, data-element and key-value storage layer: the port's own
copy of ``smqtk_indexing_tpu/data/`` (which imports no jax), kept at the
same paths so each module has its counterpart there.
"""
from smqtk_indexing_tpu_torch.data.data_element import (  # noqa: F401
    DataElement,
    DataFileElement,
    DataMemoryElement,
    from_uri,
)
from smqtk_indexing_tpu_torch.data.descriptor import (  # noqa: F401
    DescriptorElement,
    DescriptorMemoryElement,
    DescriptorSet,
    MemoryDescriptorSet,
)
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError  # noqa: F401
from smqtk_indexing_tpu_torch.data.key_value import (  # noqa: F401
    KeyValueStore,
    MemoryKeyValueStore,
)
