"""Sequence parallelism: the mesh of virtual ranks and ring attention."""
