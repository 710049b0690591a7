"""Small sizes of the configurations that the harness's tests run at,
for those whose entry ``test_cardbench_harness.TINY`` lacks: every law
kept, the counts cut (the harness's cell tests read ``TINY`` by the
cell's configuration)."""

from cardbench.tests import test_cardbench_harness as harness

SIZES = {"yahoo-kddcup11": {"users": 400, "items": 3000, "ratings": 12000}}

for _name, _size in SIZES.items():
    harness.TINY.setdefault(_name, _size)
