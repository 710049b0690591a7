"""
cardbench: the benchmark of ``csr_tpu_torch`` on an NVIDIA H100.

``BENCHMARK.json`` at the repository's root names its cells; each is a
configuration (``configs/<name>.json``, a rating set made on the card
from the seed by :mod:`cardbench.generate`) under a traffic mix
(``traffic/<mix>.json``, operations of :mod:`cardbench.ops` that
:mod:`cardbench.program` runs).  :mod:`cardbench.reference` is the plain
reference the check holds the program to (:mod:`cardbench.check`), and
``metrics/<name>.py`` reads each metric.  Run a cell with
``python3 -m cardbench.run`` (:mod:`cardbench.run`).
"""
