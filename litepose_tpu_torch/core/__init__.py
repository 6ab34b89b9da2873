"""Stage aggregation and the end-to-end serving engine."""
