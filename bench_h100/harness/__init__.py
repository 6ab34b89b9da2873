"""The harness of the benchmark: its contract, traces, frozen counts and
the scene generator."""
