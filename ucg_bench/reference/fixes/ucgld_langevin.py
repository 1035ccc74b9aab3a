"""``fix ucgld/langevin T_start T_stop period seed``
(fix_ucgld_langevin.cpp:165-296): the Langevin force on lambda, a drag on
v_lambda and a uniform kick a step, drawn by the program's generator; its
target temperature is also the pair styles' kT."""

from __future__ import annotations

import math

import torch


def parse(args: list, workdir: str) -> dict:
    return {"thermostat": "ucgld/langevin", "T_start": float(args[0]),
            "T_stop": float(args[1]), "t_period": float(args[2])}


def lambda_kick(ph, ml, dt: float):
    """``kick(pair lambda force, v_lambda, u)``: the lambda force with the
    drag and the kick of uniform draws ``u``."""
    if ph.T_start != ph.T_stop:
        raise ValueError("a temperature ramp is not followed")
    g1 = -ml / ph.t_period
    g2 = torch.sqrt(ml) * math.sqrt(24.0 / ph.t_period / dt) * math.sqrt(
        ph.T_start)
    return lambda lamf, vl, u: lamf + g1 * vl + g2 * (u - 0.5)
