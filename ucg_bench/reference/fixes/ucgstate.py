"""``fix ucgstate ld`` (fix_ucgstate.cpp:88-132): the posterior of the
state scores."""

from __future__ import annotations


def parse(args: list, workdir: str) -> dict:
    if args != ["ld"]:
        raise ValueError(f"fix ucgstate {args} not followed")
    return {"ucgstate": "ld"}
