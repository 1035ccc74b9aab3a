"""The atom decomposition over ``torch.distributed`` (port of
``lammps_ucg_dev_tpu/parallel/domain.py``): the fallback of a
``processors`` deck whose box the slabs and pencils cannot take (a tilted
box, or a grid with fewer than 3 cuts on an axis or subdomains narrower
than cutoff + skin).

The JAX package shards the per-atom rows over a device mesh and lets GSPMD
insert the collectives (replicated gathers, no reverse communication: every
tally is owned by its i-atom).  Here every rank holds the whole system and
tallies the i rows it owns:

* on the kernel path, the atoms of one contiguous range of the column
  list's i-clusters (8 real slots, the kernels' unit of work:
  ``colpack.restrict_i``), taken anew at each rebuild.  A cluster's hits
  share one queue and one set of partial sums (``csrc/colspan.cuh``), so a
  rank that tallied only some of a cluster's atoms would sum the others in
  another order; whole clusters keep one device's order.  On the reference
  path, one contiguous block of rows (its list's other rows emptied, what
  ``neighbor.build(i_valid=)`` does);
* the special pairs come off the owned rows' tallies only (their rows of
  the special lists, by the style's route, ``Simulation._pair_pass``), so
  the sum over the ranks takes each off once;
* after the pair pass one ``Ring.all_gather`` of f, the λ-force, the
  scores and the in-pass posterior, each atom's rows taken from its owner,
  makes them whole again on every rank, and one ``all_reduce`` sums pe,
  the virial and the out-of-table counts;
* the density styles gather ρ and the CV weights between their passes the
  same way, through the style's ``xchg`` hook;
* everything else (the bonded terms, the fixes, the integrator, the
  cluster_switch event, thermo) runs on the whole, identical state on every
  rank, with the same seeded draws.

Owned rows see the list and the summation order of one device, so the
per-atom trajectory is bit-identical to one process's (pe and the virial
are summed over the ranks in another order).  The slot-major interior is
off under this driver, and the cluster lists (K8) are not decomposed.
"""

from __future__ import annotations

import dataclasses

import torch

from lammps_ucg_dev_tpu_torch.ops import clusters, colpack
from lammps_ucg_dev_tpu_torch.parallel.comm import Ring
from lammps_ucg_dev_tpu_torch.runtime.sim import Simulation


class DomainSimulation(Simulation):
    """``Simulation`` decomposed by atoms over ``ring`` (its ``world``
    ranks; the grid's shape does not matter).  Every rank passes the same
    system, state and seed; the number of atoms must divide by the number
    of ranks.  The cluster_switch logs are written by rank 0."""

    def __init__(self, system, state, pair_compute, pair_params, nbr_spec,
                 cfg, ring: Ring, log_dir: str | None = None, **kw):
        n, world = state.n_atoms, ring.world
        if n % world:
            raise ValueError(f"n_atoms={n} not divisible by the {world} "
                             "ranks of the atom decomposition")
        if isinstance(nbr_spec, clusters.ClusterSpec):
            raise NotImplementedError("the cluster lists (K8) are not "
                                      "decomposed: use the column kernels")
        self.ring = ring
        # each atom's rank: row blocks on the reference path, i-clusters
        # of the column list on the kernel path (_nbr_build)
        self._owner = torch.arange(n, device=state.device) // (n // world)
        super().__init__(system, state, pair_compute, pair_params, nbr_spec,
                         cfg, log_dir=None if ring.rank else log_dir, **kw)
        self._slot_ok = False

    def _xchg(self, a: torch.Tensor) -> torch.Tensor:
        """The per-atom array ``a`` whole: each atom's rows from the rank
        that owns it."""
        every = torch.stack(self.ring.all_gather(a.contiguous()))
        return every[self._owner, torch.arange(a.shape[0],
                                               device=a.device)]

    def _whole(self, fout):
        """``fout`` of the owned rows made whole: one gather of the
        per-atom outputs and one sum of pe, the virial and the counts."""
        per = [fout.f, fout.ucgforce[:, None], fout.scores]
        if fout.ucgp is not None:
            per.append(fout.ucgp[:, None])
        W = self._xchg(torch.cat(per, 1))
        oob = [c for c in (fout.oob_low, fout.oob_high) if c is not None]
        tot = self.ring.all_reduce(torch.cat(
            [fout.pe.double().reshape(1), fout.virial.double()]
            + [c.double().reshape(1) for c in oob]))
        counts = [tot[7 + k].round().to(c.dtype) for k, c in enumerate(oob)]
        return dataclasses.replace(
            fout, f=W[:, 0:3].contiguous(), ucgforce=W[:, 3].contiguous(),
            scores=W[:, 4:6].contiguous(),
            ucgp=W[:, 6].contiguous() if fout.ucgp is not None else None,
            pe=tot[0].to(fout.pe.dtype),
            virial=tot[1:7].to(fout.virial.dtype),
            oob_low=counts[0] if fout.oob_low is not None else None,
            oob_high=counts[-1] if fout.oob_high is not None else None)

    def _pair_pass(self, state, nbr, pair_fn, kw, excl):
        """The pair pass over the owned rows, with the owned rows' special
        partners left out, made whole."""
        if excl is not None:
            excl = torch.where((self._owner == self.ring.rank)[:, None],
                               excl, state.n_atoms)
        if getattr(pair_fn, "supports_halo_xchg", False):
            kw = dict(kw, xchg=self._xchg)
        return self._whole(super()._pair_pass(state, nbr, pair_fn, kw, excl))

    def _nbr_build(self, state):
        nbr = super()._nbr_build(state)
        me = self.ring.rank
        if isinstance(nbr, colpack.ColumnList):
            n_clusters = nbr.i_valid.shape[0] // colpack.CL
            self._owner = ((nbr.atom_slot // colpack.CL) * self.ring.world
                           // n_clusters)
            return colpack.restrict_i(nbr, self._owner == me)
        return dataclasses.replace(nbr, idx=torch.where(
            (self._owner == me)[:, None], nbr.idx, state.n_atoms))


def from_simulation(sim: Simulation, ring: Ring) -> DomainSimulation:
    """``sim``'s system, pair path, configuration, topology, fixes and seed
    decomposed by atoms over ``ring``, on ``sim``'s device (the builders'
    default is the CUDA device)."""
    return DomainSimulation(
        sim.system, sim.state, sim.pair_compute, sim.pair_params,
        sim.nbr_spec, sim.cfg, ring, seed=sim.seed,
        extra_post_force=sim.extra_post_force, cluster_switch=sim.cswitch,
        log_dir=sim.log_dir, bonded=sim.bonded,
        excl_tags=(None if sim.excl_tags is None
                   else sim.excl_tags.cpu().numpy()))
