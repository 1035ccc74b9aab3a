"""``fix nve/ucgld`` (fix_nve_ucgld.cpp:44-153): the extended-Lagrangian
velocity Verlet on (x, v) and (lambda, v_lambda), which ``md.follow_block``
writes; this fix adds nothing to it."""

from __future__ import annotations


def parse(args: list, workdir: str) -> dict:
    if args:
        raise ValueError(f"fix nve/ucgld {args} not followed")
    return {"integrator": "nve/ucgld", "integrator_args": {}}


def pre_force(lam, ucgstate, args):
    """The discrete state the pair forces see."""
    return ucgstate


def lambda_force(lam, args):
    """A force on lambda besides the pair's and the thermostat's."""
    return None


def end_step(lam, vlam, undecided, args):
    """(lambda, v_lambda, undecided) at the end of a step."""
    return lam, vlam, undecided
