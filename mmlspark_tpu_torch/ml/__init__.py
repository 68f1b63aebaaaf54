"""Evaluation of scored tables: the metrics the port's flows report."""
