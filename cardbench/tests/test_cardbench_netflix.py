"""The Netflix Prize configuration (``configs/netflix.json``): the published
counts, the degree law at full size on the CPU, the generator's
convergence at a small size, and the cell ``netflix.als`` at that size.

Importing this module adds ``netflix``'s small size to
``test_cardbench_harness.TINY``, as ``conftest.py`` does for yahoo, so the
harness's own cell tests run ``netflix.als`` too.

    python -m pytest cardbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import pytest
import torch

from cardbench import cell, generate
from cardbench.tests import test_cardbench_harness as harness
from cardbench.tests.test_cardbench_harness import SEED, over, run_tiny

NAME = "netflix"
#: the training set's counts (Bennett and Lanning, KDD Cup 2007):
#: users, movies, ratings
PUBLISHED = (480_189, 17_770, 100_480_507)
#: the most titles a user, where the source has users near all 17,770
CAP = 15_000
#: the small size: every law kept, the counts cut, the cap with them (a
#: user rating all but a few titles would take the redraws hundreds of
#: rounds)
SMALL = {"users": 1200, "items": 300, "ratings": 18000,
         "user_degree": {"law": "lognormal", "sigma": 1.2, "min": 1, "cap": 250}}

harness.TINY.setdefault(NAME, SMALL)


def test_published_counts_and_assumed_laws():
    cfg = generate.load_config(NAME)
    assert (cfg["users"], cfg["items"], cfg["ratings"]) == PUBLISHED
    assert cfg["reduced"] == [] and cfg["pairs"] == "distinct"
    assert cfg["dtype"] == "float32"
    assert cfg["ratings_scale"] == {"low": 1.0, "high": 5.0, "step": 1.0}
    assert cfg["user_degree"] == {"law": "lognormal", "sigma": 1.2, "min": 1, "cap": CAP}
    assert cfg["item_popularity"] == {"law": "power", "exponent": 0.6}
    assumed = " ".join(cfg["assumed"])
    for word in ("sigma 1.2", "minimum of 1", "15,000", "not fitted", "uniform",
                 "drawn again"):
        assert word in assumed, word
    bench = cell.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == NAME)
    assert entry["file"] == f"cardbench/configs/{NAME}.json" and entry["reduced"] == []


def test_degrees_at_full_size():
    """The law meets the published total exactly, within the cap and the
    minimum, at 209 ratings a user: a few users at the cap, none past."""
    cfg = generate.load_config(NAME)
    deg = generate.degrees(cfg, generate.generator(0, "sizes", "cpu"), "cpu")
    assert deg.numel() == cfg["users"] and int(deg.sum()) == cfg["ratings"]
    assert int(deg.min()) >= 1 and int(deg.max()) <= CAP
    assert int((deg == CAP).sum()) >= 1
    assert 209 <= float(deg.double().mean()) < 210


@pytest.mark.parametrize("seed", [SEED, SEED + 1, 7])
def test_generator_converges_at_the_small_size(seed):
    cfg = generate.load_config(NAME)
    cfg.update(SMALL)
    trip = generate.ratings(cfg, seed, "cpu")
    d = generate.describe(trip)
    assert (d["users"], d["items"], d["ratings"]) == (cfg["users"], cfg["items"], cfg["ratings"])
    assert d["user_min"] >= 1 and d["user_max"] <= SMALL["user_degree"]["cap"]
    assert d["redraw_rounds"] < generate.MAX_REDRAWS
    key = trip["rows"].long() * cfg["items"] + trip["cols"].long()
    assert bool((key[1:] > key[:-1]).all()), "sorted, each (user, item) pair once"
    vals = trip["vals"]
    assert vals.dtype == torch.float32 and bool((vals == vals.round()).all())
    assert float(vals.min()) >= 1 and float(vals.max()) <= 5


def test_cell_on_one_card():
    w = cell.find_cell(cell.load_benchmark(), f"{NAME}.als")
    assert (w["config"], w["traffic"], w["chips"]) == (NAME, "als", 1)


@pytest.mark.parametrize("traced", [False, True])
def test_cell_at_the_small_size(traced):
    r = run_tiny(f"{NAME}.als", traced=traced, seconds=0.4)
    assert r["correct"] and not over(r["checks"]), r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    if traced:
        assert {"api_host_ms", "first_call_s"} <= set(r["metrics"])
    else:
        assert r["metrics"]["step_ms"]["value"] > 0
