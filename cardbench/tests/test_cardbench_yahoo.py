"""The KDD-Cup'11 Yahoo! Music configuration (``configs/yahoo-kddcup11.json``):
its published counts, the degree law at full size on the CPU, and the
generator at the small size ``conftest.py`` gives it.

    python -m pytest cardbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import torch

from cardbench import cell, generate
from cardbench.tests.conftest import SIZES
from cardbench.tests.test_cardbench_harness import SEED

NAME = "yahoo-kddcup11"
#: Track 1's counts (Dror et al., KDD-Cup'11): users, items, ratings
PUBLISHED = (1_000_990, 624_961, 262_810_175)
#: the items: tracks, albums, artists and genres, one id space
KINDS = (507_172, 88_909, 27_888, 992)
#: ratings each user holds out: 4 in validation, 6 in test
HELD_OUT = 4 + 6


def test_published_counts_and_degrees_at_full_size():
    cfg = generate.load_config(NAME)
    assert (cfg["users"], cfg["items"], cfg["ratings"]) == PUBLISHED
    assert sum(KINDS) == cfg["items"]
    assert cfg["reduced"] == [] and cfg["user_degree"]["min"] == HELD_OUT
    deg = generate.degrees(cfg, generate.generator(0, "sizes", "cpu"), "cpu")
    assert deg.numel() == cfg["users"] and int(deg.sum()) == cfg["ratings"]
    assert int(deg.min()) >= HELD_OUT and int(deg.max()) <= cfg["items"]
    # rows of hundreds of entries: past the CSR-form SpMM's share of
    # 1,024 merge items for more than a tenth of the users
    assert float(deg.double().mean()) > 260 and int((deg > 1024).sum()) > cfg["users"] // 40


def test_generator_at_the_small_size():
    cfg = generate.load_config(NAME)
    cfg.update(SIZES[NAME])
    trip = generate.ratings(cfg, SEED, "cpu")
    d = generate.describe(trip)
    assert (d["users"], d["items"], d["ratings"]) == (cfg["users"], cfg["items"], cfg["ratings"])
    assert d["user_min"] >= HELD_OUT
    key = trip["rows"].long() * cfg["items"] + trip["cols"].long()
    assert bool((key[1:] > key[:-1]).all()), "sorted, each (user, item) pair once"
    vals = trip["vals"]
    assert vals.dtype == torch.float32 and bool((vals == vals.round()).all())
    assert float(vals.min()) >= 0 and float(vals.max()) <= 100


def test_cells_on_one_card():
    bench = cell.load_benchmark()
    cfg = next(c for c in bench["configs"] if c["name"] == NAME)
    assert cfg["file"] == f"cardbench/configs/{NAME}.json" and cfg["reduced"] == []
    for name, config, traffic in (("ml25m.lanczos", "ml25m", "lanczos"),
                                  (f"{NAME}.als", NAME, "als")):
        w = cell.find_cell(bench, name)
        assert (w["config"], w["traffic"], w["chips"]) == (config, traffic, 1)
