"""
The descriptor, data-element and key-value storage layer, shared with
``smqtk_indexing_tpu.data`` (it imports no jax) and re-exported here so
that users of the port import from one package.
"""
from smqtk_indexing_tpu.data import (  # noqa: F401
    DataElement,
    DataFileElement,
    DataMemoryElement,
    DescriptorElement,
    DescriptorMemoryElement,
    DescriptorSet,
    KeyValueStore,
    MemoryDescriptorSet,
    MemoryKeyValueStore,
    ReadOnlyError,
    from_uri,
)
