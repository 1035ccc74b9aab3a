"""The fixes the reference follows, one module a fix style:
``<fix style with "/" as "_">.py``.  Each has ``parse(args, workdir)``,
which returns the fields of ``deck.Physics`` that the fix sets; an
integrator (``integrator``) also gives the hooks of ``md.follow_block``
(``pre_force``, ``lambda_force``, ``end_step``), a lambda thermostat
(``thermostat``) its ``lambda_kick``."""

from __future__ import annotations

import importlib


def module(style: str):
    """The module of ``fix ... style``; ValueError where there is none."""
    mod = f"ucg_bench.reference.fixes.{style.replace('/', '_')}"
    try:
        return importlib.import_module(mod)
    except ModuleNotFoundError as e:
        if e.name != mod:
            raise
        raise ValueError(f"fix {style} not followed") from None
