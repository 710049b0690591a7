"""
The interpreter of traffic mixes: a traffic file (``traffic/<mix>.json``)
lists the set-up's operations and one step's, each
``{"out": name, "op": operation, <argument>: value, ...}``.  A value
that names an earlier result is that result, ``"<name>.<attribute>"``
is an attribute of one (``"R.ncols"``), anything else is taken as
written.  ``{"op": "drop", "names": [...]}`` lets results go.

The same file drives the program (the operations of
:mod:`cardbench.ops`) and the plain reference (those of
:mod:`cardbench.reference`), by the operations' names.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))


def load_traffic(name: str) -> dict:
    """The traffic file ``traffic/<name>.json``."""
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


@dataclass
class Context:
    """What an operation may read besides its arguments: where it runs,
    the run's seed, the step it is in (``-1`` in set-up), the block the
    seed starts a walk at, the result's name, and the precision a
    reference computes in."""

    device: object
    seed: int
    start: int = 0
    step: int = -1
    out: str = ""
    precision: str = "float64"
    cache: dict = field(default_factory=dict)


@dataclass(frozen=True)
class Call:
    """One compiled operation of a traffic file."""

    out: str
    name: str
    fn: object
    args: tuple  # (argument, kind, payload): kind 0 a result, 1 an attribute, 2 as written
    spec: dict

    def resolve(self, env: dict) -> dict:
        got = {}
        for key, kind, payload in self.args:
            if kind == 0:
                got[key] = env[payload]
            elif kind == 1:
                got[key] = getattr(env[payload[0]], payload[1])
            else:
                got[key] = payload
        return got


def compile_ops(specs: list, registry: dict, known: set) -> list:
    """Calls of ``specs`` against ``registry`` (operation name to a
    function, or to an object with ``.run``); ``known`` holds the names
    results exist under before the first, and grows."""
    calls = []
    for spec in specs:
        if spec["op"] == "drop":
            calls.append(Call("", "drop", None, tuple(spec["names"]), spec))
            known.difference_update(spec["names"])
            continue
        if spec["op"] not in registry:
            raise ValueError(f"unknown operation {spec['op']}")
        entry = registry[spec["op"]]
        args = []
        for key, value in spec.items():
            if key in ("out", "op"):
                continue
            if isinstance(value, str) and value in known:
                args.append((key, 0, value))
            elif (isinstance(value, str) and "." in value
                  and value.split(".", 1)[0] in known):
                args.append((key, 1, tuple(value.split(".", 1))))
            else:
                args.append((key, 2, value))
        calls.append(Call(spec["out"], spec["op"], getattr(entry, "run", entry),
                          tuple(args), spec))
        known.add(spec["out"])
    return calls


def run_call(call: Call, ctx: Context, env: dict):
    """Run one call, binding its result in ``env``."""
    if call.name == "drop":
        for name in call.args:
            env.pop(name, None)
        return None
    ctx.out = call.out
    out = call.fn(ctx, **call.resolve(env))
    env[call.out] = out
    return out


def block_begin(ctx: Context, nrows: int, block: int) -> int:
    """The first row of this step's block: blocks of ``block`` rows taken
    in turn, from a block drawn from the seed."""
    blocks = -(-nrows // block)
    return (ctx.start + ctx.step) % blocks * block


def carried(step_specs: list) -> list:
    """Results a step reads before it writes them, in step order: the
    state it carries from one step to the next."""
    written, out = set(), []
    for spec in step_specs:
        for key, value in spec.items():
            if key in ("out", "op", "names") or not isinstance(value, str):
                continue
            name = value.split(".", 1)[0]
            if name not in written and name not in out and any(
                    s.get("out") == name for s in step_specs):
                out.append(name)
        if "out" in spec:
            written.add(spec["out"])
    return out
