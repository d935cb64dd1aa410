class ReadOnlyError (Exception):
    """
    Raised when a mutating operation is attempted against a read-only
    container (equivalent of ``smqtk_dataprovider.exceptions.ReadOnlyError``,
    used e.g. at SMQTK-Indexing smqtk_indexing/impls/nn_index/lsh.py:25).
    """
