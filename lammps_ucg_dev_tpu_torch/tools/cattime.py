"""Time ``colpack.pack``'s concatenation of the i-side rows on one path's
own inputs, atom-ordered and slot-ordered, and variants that tell apart
what its time depends on.

    python -m lammps_ucg_dev_tpu_torch.tools.cattime [--path density|ucgld]
                                                     [--n 1048576] [--reps 50]

Builds the path's system (``flagship.build_density_sim`` or
``build_sim``), runs setup and one block, then takes the state in atom
order and in the column list's real-slot order (``Simulation._to_slots``)
and times by CUDA events, each the mean of ``reps`` calls after a warm
one, the (rows, 8) float32 concatenation [x y z λ state valid aux typ]
that ``pack`` makes:

* ``atom``, ``slot``: ``torch.cat`` of the pieces as ``pack`` builds them;
* ``slot[:N]``: the slot pieces cut to the atom count (row views);
* ``fresh``: new random pieces of the slot shapes;
* ``columns``: the same (rows, 8) block written column by column into
  ``torch.empty``.

Prints the card's name and power limit, then one line per variant: ms,
GB/s (each input read once, the output written once) and the kernels one
call launches (``torch.profiler``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from lammps_ucg_dev_tpu_torch.tools.timing import card, cuda_ms


def pieces(x, lam, state, valid, aux, typ):
    f32 = torch.float32
    return [x.to(f32), lam.to(f32)[:, None], state.to(f32)[:, None],
            valid.to(f32)[:, None], aux.to(f32)[:, None],
            typ.to(f32)[:, None]]


def columns(ps):
    out = torch.empty((ps[0].shape[0], 8), dtype=torch.float32,
                      device=ps[0].device)
    c = 0
    for p in ps:
        out[:, c:c + p.shape[1]] = p
        c += p.shape[1]
    return out


def main() -> int:
    from lammps_ucg_dev_tpu_torch import flagship

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("density", "ucgld"),
                    default="density")
    ap.add_argument("--n", type=int, default=2**20)
    ap.add_argument("--reps", type=int, default=50)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cattime: no CUDA device")
    build = (flagship.build_density_sim if a.path == "density"
             else flagship.build_sim)
    sim = build(n=a.n)
    window = (0, 2 * sim.cfg.reneigh_every)
    sim.setup(window)
    sim.run_fused(1, run_window=window)
    st, cl = sim.state, sim._nbr
    ss, _ = sim._to_slots(st, sim._fcarry, cl)
    n, ns = st.n_atoms, cl.n_slots
    gen = torch.Generator(device=st.device)
    gen.manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=st.device)

    atom = pieces(st.x, rand(n), st.ucgstate,
                  torch.ones(n, dtype=torch.bool, device=st.device),
                  rand(n), st.typ)
    slot = pieces(ss.x, rand(ns), ss.ucgstate, cl.i_valid, rand(ns),
                  ss.typ)
    cut = [p[:n] for p in slot]
    fresh = [rand(*p.shape) for p in slot]
    print(card())
    print(f"[cattime {a.path}] N {n}, n_slots {ns}, {a.reps} calls each")
    for name, ps, fn in (("atom", atom, None), ("slot", slot, None),
                         ("slot[:N]", cut, None), ("fresh", fresh, None),
                         ("columns, atom", atom, columns),
                         ("columns, slot", slot, columns)):
        call = ((lambda ps=ps: torch.cat(ps, 1)) if fn is None
                else (lambda ps=ps, fn=fn: fn(ps)))
        ms = cuda_ms(call, a.reps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = sorted({e.key[:60] for e in prof.key_averages()
                          if e.device_type.name == "CUDA"})
        nbytes = 2 * 4 * 8 * ps[0].shape[0]
        print(f"{name:>14}: {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s; "
              f"{kernels}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
