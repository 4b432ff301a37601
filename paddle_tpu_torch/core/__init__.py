"""Core data structures of the port: ``core.lod`` (``LoD``,
``LoDTensor``, ``pack_indices``)."""
