"""Shared parts of the benchmark: weights, statistics, traces, FLOP counts."""
