"""``fix nve/ucgld/wall/hard`` (fix_nve_ucgld_wall_hard.cpp:99-257): the
integrator of ``fix nve/ucgld`` with hard walls that reflect a lambda that
has crossed 0 or 1, the discrete state set to whether lambda reached 0.5,
and with ``bias_potential b`` a double-well force on lambda.

Float32 arithmetic does not decide a wall or the threshold for a lambda
within ``BAND`` of it: such a bead is marked undecided."""

from __future__ import annotations

import torch

BAND = 1e-5


def parse(args: list, workdir: str) -> dict:
    bias = None
    if args[:1] == ["bias_potential"]:
        bias, args = float(args[1]), args[2:]
    if args:
        raise ValueError(f"fix nve/ucgld/wall/hard {args} not followed")
    return {"integrator": "nve/ucgld/wall/hard",
            "integrator_args": {"bias_potential": bias}}


def pre_force(lam, ucgstate, args):
    return (lam >= 0.5).to(ucgstate.dtype)


def lambda_force(lam, args):
    if args["bias_potential"] is None:
        return None
    xx = lam - 0.5
    return (-7980.0 * xx ** 9 + 2.0 * xx) * 10.0 * args["bias_potential"]


def end_step(lam, vlam, undecided, args):
    undecided = undecided | ((lam.abs() < BAND) | ((lam - 1.0).abs() < BAND)
                             | ((lam - 0.5).abs() < BAND))
    below, above = lam < 0.0, lam > 1.0
    lam = torch.where(below, -lam, torch.where(above, 2.0 - lam, lam))
    vlam = torch.where(below | above, -vlam, vlam)
    return lam, vlam, undecided
