"""Sparse operators over the micro-block layout (counterpart of
:mod:`csr_tpu.ops`)."""
