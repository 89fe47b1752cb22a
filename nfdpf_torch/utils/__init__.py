"""Utilities: checkpointing, metrics logging, parameter freezing, profiling."""
