"""
The one generator of the benchmark's data: a configuration's rating
triples, made on the device from the seed.

A configuration file (``configs/<name>.json``) states a rating set's
published counts and the laws of the sizes the source does not publish
(its ``assumed`` list).  :func:`ratings` draws every user's number of
ratings from ``user_degree`` and brings them to the exact published
total (the rewrite, in PyTorch on the device, of ``chip_smoke.py``'s
``movielens_shape`` and ``realistic_hypersparse``); each rating's item
from a power law of popularity over a random order of the item ids; and
draws again every rating that repeats a (user, item) pair until each
pair is rated once, as in the source.  The triples come back sorted by
user, then item.

The sizes (each user's number of ratings, each item's popularity) are
drawn once for the configuration, the same for every seed; the seed
draws which items each user rates, and the ratings.  So every seed asks
the same work of the program, arranged differently, and runs with other
seeds differ no more than two runs of one seed do.

:func:`dense` makes a dense input (factors, a start vector) from the
seed and the input's name, so the reference can make the same one again
without sharing the program's tensor.
"""

from __future__ import annotations

import json
import math
import os
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

#: draws of repeated pairs again before the generator gives up
MAX_REDRAWS = 400


def load_config(name: str) -> dict:
    """The configuration file ``configs/<name>.json``."""
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def generator(seed: int, salt: str, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and a name, so each
    input's draws do not depend on the order the inputs are made in."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + zlib.crc32(salt.encode())) % (1 << 63))
    return g


def zipf_exponent(mean: float, cap: int) -> float:
    """The exponent ``s`` of a Zipf law over ``1 .. cap`` whose mean is
    ``mean`` (bisection; the mean falls as ``s`` grows)."""
    k = np.arange(1, cap + 1, dtype=np.float64)

    def law_mean(s):
        p = k ** -s
        return float((k * p).sum() / p.sum())

    lo, hi = 1.0001, 8.0
    if not law_mean(hi) < mean < law_mean(lo):
        raise ValueError(f"no Zipf law over 1..{cap} has mean {mean}")
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if law_mean(mid) > mean else (lo, mid)
    return 0.5 * (lo + hi)


def _weights(law: dict, users: int, items: int, mean: float, g, device):
    """Each user's share of the ratings above the minimum, drawn from the
    configuration's law of user degrees."""
    lo = int(law["min"])
    if law["law"] == "lognormal":
        z = torch.randn(users, generator=g, device=device, dtype=torch.float64)
        return torch.exp(float(law["sigma"]) * z)
    if law["law"] == "zipf":
        cap = min(int(law["cap"]), items)
        s = zipf_exponent(mean, cap)
        k = torch.arange(1, cap + 1, device=device, dtype=torch.float64)
        cdf = torch.cumsum(k ** -s, 0)
        u = torch.rand(users, generator=g, device=device, dtype=torch.float64)
        d = torch.searchsorted(cdf, u * cdf[-1]).clamp_max(cap - 1) + 1
        return (d - lo).to(torch.float64)
    raise ValueError(f"unknown law of user degrees: {law['law']}")


def degrees(cfg: dict, g, device) -> torch.Tensor:
    """Ratings of each user (int64): at least ``min``, at most ``cap`` and
    the item count, summing to the published total exactly."""
    users, items, total = int(cfg["users"]), int(cfg["items"]), int(cfg["ratings"])
    law = cfg["user_degree"]
    lo = int(law["min"])
    most = min(int(law.get("cap", items)), items) - lo
    w = _weights(law, users, items, total / users, g, device)
    extra_total = total - lo * users
    extra = torch.floor(w / w.sum() * extra_total).to(torch.int64).clamp(0, most)
    rem = extra_total - int(extra.sum())
    room = torch.nonzero(extra < most).flatten()
    if rem > room.numel():
        raise ValueError("the degree law cannot reach the published total")
    pick = room[torch.randperm(room.numel(), generator=g, device=device)[:rem]]
    extra[pick] += 1
    return lo + extra


def _item_draw(cfg: dict, shape, g, device):
    """A function drawing ``n`` item ids (from ``g``) by power-law
    popularity over a random order of the ids (from ``shape``)."""
    items = int(cfg["items"])
    pop = cfg["item_popularity"]
    if pop["law"] != "power":
        raise ValueError(f"unknown law of item popularity: {pop['law']}")
    rank = torch.arange(1, items + 1, device=device, dtype=torch.float64)
    cdf = torch.cumsum(rank ** -float(pop["exponent"]), 0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(items, generator=shape, device=device)

    def draw(n: int) -> torch.Tensor:
        u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
        return perm[torch.searchsorted(cdf, u).clamp_max(items - 1)]

    return draw


def ratings(cfg: dict, seed: int, device) -> dict:
    """The triples of configuration ``cfg`` from ``seed``:
    ``{"rows", "cols", "vals", "shape"}``, rows and columns int32, values
    in the configuration's dtype, sorted by user and then item, each
    (user, item) pair once."""
    if cfg.get("kind") != "ratings" or cfg.get("pairs") != "distinct":
        raise ValueError("this generator makes rating sets of distinct pairs")
    shape = generator(0, "sizes", device)
    users, items = int(cfg["users"]), int(cfg["items"])
    deg = degrees(cfg, shape, device)
    total = int(cfg["ratings"])
    rows = torch.repeat_interleave(torch.arange(users, device=device), deg,
                                   output_size=total)
    g = generator(seed, "ratings", device)
    draw = _item_draw(cfg, shape, g, device)
    cols = draw(total)
    for rounds in range(MAX_REDRAWS):
        key, order = torch.sort(rows * items + cols, stable=True)
        again = order[1:][key[1:] == key[:-1]]
        if again.numel() == 0:
            break
        cols[again] = draw(again.numel())
    else:
        raise RuntimeError(f"pairs still repeat after {MAX_REDRAWS} draws")
    scale = cfg["ratings_scale"]
    steps = round((scale["high"] - scale["low"]) / scale["step"])
    level = torch.randint(0, steps + 1, (total,), generator=g, device=device)
    vals = (scale["low"] + scale["step"] * level.to(torch.float64)).to(
        getattr(torch, cfg["dtype"]))
    return {"rows": torch.div(key, items, rounding_mode="floor").to(torch.int32),
            "cols": (key % items).to(torch.int32), "vals": vals,
            "shape": (users, items), "redraw_rounds": rounds}


def dense(seed: int, name: str, shape, device) -> torch.Tensor:
    """A dense f32 input of ``shape``, standard normal, from the seed and
    the input's ``name``, in one call on ``device``."""
    g = generator(seed, "dense:" + name, device)
    return torch.randn(*shape, generator=g, device=device, dtype=torch.float32)


def describe(trip: dict) -> dict:
    """Counts of a triple set, for the run's report and the tests."""
    users, items = trip["shape"]
    deg = torch.bincount(trip["rows"].long(), minlength=users)
    pop = torch.bincount(trip["cols"].long(), minlength=items)
    return {"users": users, "items": items, "ratings": int(trip["rows"].numel()),
            "user_min": int(deg.min()), "user_max": int(deg.max()),
            "item_max": int(pop.max()), "items_unrated": int((pop == 0).sum()),
            "redraw_rounds": trip.get("redraw_rounds"),
            "mean_per_user": trip["rows"].numel() / users if users else math.nan}
