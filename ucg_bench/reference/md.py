"""One block of the timestep, written plainly: the extended-Lagrangian
velocity Verlet of ``fix nve/ucgld`` (fix_nve_ucgld.cpp:44-153), with what
the deck's integrator fix adds to it (its hooks in ``fixes/<fix>.py``: the
walls and the bias of ``fix nve/ucgld/wall/hard``), the lambda force of its
thermostat fix (``fix ucgld/langevin``) and the posterior of ``fix
ucgstate ld`` (fix_ucgstate.cpp:88-132), on the pair forces of the deck's
pair style.

The block starts from the program's own state at its start, the force
carry included (the Langevin part of a carried lambda force was drawn at the
step before, so nothing else could stand in for it), and replays the
program's uniform draws from its generator's state at that point, one
``(N,)`` draw a step indexed by tag.  Everything runs in ``dtype``.

An integrator marks the beads whose step float32 arithmetic does not
decide (a lambda at a wall or at the state threshold).  The pair forces come from
every pair within the cutoff, while the deck's neighbor settings (``neigh_
modify every N check yes``) promise only the pairs that were within the
cutoff plus the skin at the last list build (``x0``, rebuilt at a block's
start when a bead has moved more than half the skin): after a "dangerous
build", a pair that came from farther may or may not be computed, as the
program's list layout has it.  Such beads, a bead of such a pair, and every
bead within reach of their forces are marked ``undecided``.
"""

from __future__ import annotations

import torch

from ucg_bench.reference import fixes
from ucg_bench.reference.pairs import min_image, pairs_within


def posterior(scores, is_ucg):
    s = torch.clamp(scores, max=700.0)
    s = s - s.max(-1, keepdim=True).values
    ex = torch.exp(s)
    p1 = torch.clamp(ex[:, 1] / ex.sum(-1), 1e-6, 1 - 1e-6)
    return torch.where(is_ucg, p1, torch.ones_like(p1))


def follow_block(ph, style, inp: dict, gen_state, nsteps: int, L, dtype,
                 draw_dtype=torch.float32):
    """The state and forces after ``nsteps`` steps from ``inp`` (tag order:
    x v lam vlam ml typ ucgstate ucgp f lamforce), with the draws of a
    generator set to ``gen_state``, drawn in ``draw_dtype`` (the program's
    own)."""
    dev = inp["x"].device
    n = inp["x"].shape[0]
    c = {k: (v.to(dtype) if v.is_floating_point() else v)
         for k, v in inp.items()}
    x, v, lam, vl, ml = c["x"], c["v"], c["lam"], c["vlam"], c["ml"]
    typ, ust = c["typ"].long(), c["ucgstate"]
    f, uf = c["f"], c["lamforce"]
    mass = torch.as_tensor(ph.masses, dtype=dtype, device=dev)[typ]
    is_ucg = torch.as_tensor(ph.n_states, device=dev)[typ] > 1
    dt = ph.dt
    dtf = 0.5 * dt
    integ, iargs = fixes.module(ph.integrator), ph.integrator_args
    kick = (fixes.module(ph.thermostat).lambda_kick(ph, ml, dt)
            if ph.thermostat else None)
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    ucgp = c["ucgp"]
    undecided = torch.zeros(n, dtype=torch.bool, device=dev)
    Lt = torch.as_tensor(L, dtype=torch.float64, device=dev)
    x0 = inp["x0"].double() if "x0" in inp else inp["x"].double()
    moved = min_image(inp["x"].double() - x0, Lt)
    if float((moved * moved).sum(-1).max()) > (0.5 * ph.skin) ** 2:
        x0 = inp["x"].double()               # the block opens with a build
    reach = ph.max_cutoff + ph.skin
    out = None
    for _ in range(nsteps):
        v = v + (dtf / mass)[:, None] * f
        x = x + dt * v
        i, j = pairs_within(x, L, ph.max_cutoff)
        d0 = min_image(x0[i] - x0[j], Lt)
        far = (d0 * d0).sum(-1) >= reach * reach
        undecided[i[far]] = True
        vl = vl + dtf / ml * uf
        lam = lam + dt * vl
        ust = integ.pre_force(lam, ust, iargs)
        out = style.compute(x, typ, lam, ust, L)
        uf = out["lamf"]
        if kick is not None:
            u = torch.rand((n,), generator=gen, dtype=draw_dtype,
                           device=dev).to(dtype)
            uf = kick(uf, vl, u)
        extra = integ.lambda_force(lam, iargs)
        if extra is not None:
            uf = uf + extra
        f = out["f"]
        v = v + (dtf / mass)[:, None] * f
        vl = vl + dtf / ml * uf
        lam, vl, undecided = integ.end_step(lam, vl, undecided, iargs)
    if out["ucgp"] is not None:
        ucgp = out["ucgp"]
    elif ph.ucgstate == "ld":
        ucgp = posterior(out["scores"], is_ucg)
    if bool(undecided.any()):
        undecided = style.near(x, L, undecided)
    return {"x": x, "v": v, "lam": lam, "vlam": vl, "ucgstate": ust,
            "ucgp": ucgp, "f": f, "lamforce": uf, "pe": out["pe"],
            "undecided": undecided}
