"""Serialization and profiling helpers (counterpart of :mod:`csr_tpu.utils`)."""
