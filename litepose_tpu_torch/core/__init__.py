"""Stage aggregation and the engine (serving and the eval protocol), and
the training losses."""
