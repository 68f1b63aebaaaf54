"""Columnar tables (own copy of the subset of ``mmlspark_tpu.data``)."""
