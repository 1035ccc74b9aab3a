"""``fix cluster_switch`` — MC molecule-population switching gated by a
connected-cluster criterion (port of
``lammps_ucg_dev_tpu/fixes/cluster_switch.py``).

Reference (``UCG/fix_cluster_switch.cpp``), every ``switchFreq`` steps:

1. ``check_cluster`` (:537-731): connected-component labeling over
   MOLECULES.  Two molecules are connected when an atom pair (i, j) with
   (type_i, type_j) in the contact map lies within the contact cutoff
   (:628-648); every molecule is also linked to its ``mol_offset`` partner
   (switchable molecules to m - offset, others to m + offset, :655-669).
   Min-label propagation runs to a fixpoint (:596-685).  The seed's
   cluster is locked ON; the other switchable molecules stay eligible.
2. ``attempt_switch`` (:733-839): each eligible molecule flips with
   probability probON (OFF→ON) or 1 - probON (ON→OFF); a flip changes the
   types of all its atoms between the ON and OFF lists (:799-823).
3. the 7-stat vector (:923-968) and the per-event log rows (:704-725).

Label propagation is a host loop of the JAX package's sweep: the contact
edges are found once per event, and each sweep scatter-mins every edge's
smallest label (over both ends and their partners) into both ends and their
partners, then pointer-jumps through the partner links.  The loop stops at
the fixpoint or at ``max_sweeps``; it reads the change flag every
``SWEEP_CHECK`` sweeps (sweeps past the fixpoint change nothing), and
reports the sweeps the JAX loop runs and its ``converged`` flag.  The
accept draws are an input: (maxmol + 1,) uniforms.

Distributed form (``ring=``, ``valid=``; JAX ``check_cluster(axis=)``),
for the spatial drivers: each rank sweeps the contact edges of its owned
rows (``valid`` marks its live rows, owned and ghost); ``mol_state`` and
``present`` are max-merged over the ranks, and every sweep min-merges the
labels over the ranks, the reference's local sweep and
``MPI_Allreduce(MIN)`` (``fix_cluster_switch.cpp:596-685``).  The merged
labels are the same on every rank, so the change flag read from them is
too, and the loop ends on every rank at once.  The accept draws come from
the replicated generator over per-molecule slots, so owned and ghost copies
of a molecule flip alike on every rank.
"""

from __future__ import annotations

import dataclasses

import torch

from lammps_ucg_dev_tpu_torch.core.state import SimState, resolve_device

LABEL_MAX = 2**31 - 1    # the JAX package's int32 "no label"
SWEEP_CHECK = 16         # sweeps between reads of the change flag


@dataclasses.dataclass(frozen=True)
class ClusterSwitchParams:
    contact_ok: torch.Tensor   # (T+1, T+1) bool contact map
    off_to_on: torch.Tensor    # (T+1,) int64 type map, identity off OFF
    on_to_off: torch.Tensor    # (T+1,) int64 type map, identity off ON
    is_on: torch.Tensor        # (T+1,) bool
    is_off: torch.Tensor       # (T+1,) bool
    cutsq: torch.Tensor        # () contact cutoff²
    probON: torch.Tensor       # ()
    maxmol: int = 0
    max_sweeps: int = 64
    mol_seed: int = 1
    mol_offset: int = 0


@dataclasses.dataclass(frozen=True)
class ClusterSwitchStats:
    """The 7-vector in compute_vector's order (:923-933): attemptsTotal,
    successTotal, attemptsON, attemptsOFF, successON, successOFF,
    nCluster."""

    v: torch.Tensor

    @staticmethod
    def zeros(dtype=torch.float32, device="cpu") -> "ClusterSwitchStats":
        return ClusterSwitchStats(v=torch.zeros(7, dtype=dtype,
                                                device=device))


def make_params(ntypes: int, contacts, atomtypes_on, atomtypes_off,
                probON: float, cutoff: float, mol_seed: int, mol_offset: int,
                maxmol: int, max_sweeps: int = 64, dtype=torch.float32,
                device="cuda") -> ClusterSwitchParams:
    """``contacts``: (type_a, type_b) contact pairs (symmetrized: the
    reference tests both pair directions against the map).  Builds on the
    CUDA device unless given ``device="cpu"``."""
    device = resolve_device(device)
    T = ntypes
    cmap = torch.zeros((T + 1, T + 1), dtype=torch.bool)
    for a, b in contacts:
        cmap[a, b] = cmap[b, a] = True
    o2n = torch.arange(T + 1)
    n2o = torch.arange(T + 1)
    is_on = torch.zeros(T + 1, dtype=torch.bool)
    is_off = torch.zeros(T + 1, dtype=torch.bool)
    for on_t, off_t in zip(atomtypes_on, atomtypes_off):
        o2n[off_t] = on_t
        n2o[on_t] = off_t
        is_on[on_t] = True
        is_off[off_t] = True
    return ClusterSwitchParams(
        contact_ok=cmap.to(device), off_to_on=o2n.to(device),
        on_to_off=n2o.to(device), is_on=is_on.to(device),
        is_off=is_off.to(device),
        cutsq=torch.tensor(cutoff * cutoff, dtype=dtype, device=device),
        probON=torch.tensor(probON, dtype=dtype, device=device),
        maxmol=int(maxmol), max_sweeps=int(max_sweeps),
        mol_seed=int(mol_seed), mol_offset=int(mol_offset))


def _mol_state(state: SimState, params: ClusterSwitchParams, valid=None):
    """(mol_state, present): per molecule 1 (ON), 0 (OFF) or -1, and its
    presence, from the atom types (constructor logic, :129-159); rows
    outside ``valid`` (a spatial rank's padding) count for no molecule."""
    M = params.maxmol
    dev = state.device
    typ, mol = state.typ.long(), state.mol.long()
    if valid is not None:
        mol = torch.where(valid, mol, M + 1)            # slot M + 1: dropped
    val = torch.where(params.is_on[typ], 1,
                      torch.where(params.is_off[typ], 0, -1))
    mol_state = torch.full((M + 2,), -1, dtype=torch.int64, device=dev)
    mol_state.scatter_reduce_(0, mol, val, "amax")
    present = torch.zeros(M + 2, dtype=torch.bool, device=dev)
    present[mol] = True
    return mol_state[:M + 1], present[:M + 1]


def _contact_edges(state: SimState, nbr, params: ClusterSwitchParams):
    """(molecule of i, molecule of j) of every contact in ``nbr``: a listed
    pair within the contact cutoff whose types the map connects."""
    n = state.n_atoms
    j = nbr.idx
    valid = j < n
    jc = torch.where(valid, j, 0)
    dr = state.box.min_image(state.x[:, None, :] - state.x[jc])
    rsq = torch.sum(dr * dr, dim=-1)
    typ = state.typ.long()
    contact = (valid & (rsq < params.cutsq)
               & params.contact_ok[typ[:, None], typ[jc]])
    ii, kk = contact.nonzero(as_tuple=True)
    mol = state.mol.long()
    return mol[ii], mol[jc[ii, kk]]


def sweep(labels, edges, partner, present):
    """One sweep of min-label propagation (:596-685): each contact edge's
    smallest label over both ends and their partners is scatter-minned
    into both ends and both partners, then every present molecule
    pointer-jumps through its partner link.  ``edges`` = (molecule of i,
    of j, partner of i, partner of j) per contact."""
    im, jm, pim, pjm = edges
    new = torch.minimum(torch.minimum(labels[im], labels[jm]),
                        torch.minimum(labels[pim], labels[pjm]))
    upd = labels.clone()
    for dst in edges:
        upd.scatter_reduce_(0, dst, new, "amin")
    return torch.minimum(upd, torch.where(present, upd[partner], upd))


def check_cluster(state: SimState, nbr, params: ClusterSwitchParams,
                  ring=None, valid=None):
    """Connected-component labeling over molecules (:537-731).  Returns
    (labels, mol_state, present, in_cluster, n_cluster, converged,
    sweeps): ``converged`` is False when ``max_sweeps`` cut the propagation
    short (the labels may then be wrong); ``sweeps`` is the number of
    sweeps the JAX package's loop runs.  ``ring`` (``parallel.comm.Ring``)
    and ``valid``: the distributed form (module docstring)."""
    M = params.maxmol
    dev = state.device
    mol_state, present = _mol_state(state, params, valid)
    if ring is not None:
        mol_state = ring.all_reduce(mol_state, "max")
        present = ring.all_reduce(present.to(torch.int32), "max") > 0
    switchable = (mol_state == 0) | (mol_state == 1)
    m_idx = torch.arange(M + 1, device=dev)
    partner = torch.where(switchable, m_idx - params.mol_offset,
                          m_idx + params.mol_offset).clamp(0, M)
    im, jm = _contact_edges(state, nbr, params)

    # initial labels: own id for present molecules; the seed and its
    # partner preset to the seed (:563-573)
    labels = torch.where(present, m_idx, LABEL_MAX)
    seed = params.mol_seed
    seed_partner = seed - params.mol_offset
    for m in (seed, seed_partner) if 0 <= seed_partner <= M else (seed,):
        labels[m] = torch.clamp(labels[m], max=seed)

    edges = (im, jm, partner[im], partner[jm])
    it, converged, sweeps = 0, False, params.max_sweeps
    while it < params.max_sweeps:
        batch = min(SWEEP_CHECK, params.max_sweeps - it)
        changed = []
        for _ in range(batch):
            upd = sweep(labels, edges, partner, present)
            if ring is not None:
                upd = ring.all_reduce(upd, "min")
            changed.append(torch.any(upd != labels))
            labels = upd
        changed = torch.stack(changed).tolist()
        if not changed[-1]:
            converged = True
            sweeps = it + changed.index(False) + 1
            break
        it += batch

    cluster_id = labels[seed]
    in_cluster = present & (labels == cluster_id)
    return (labels, mol_state, present, in_cluster, in_cluster.sum(),
            converged, sweeps)


def attempt_switch(u: torch.Tensor, state: SimState, mol_state, present,
                   in_cluster, params: ClusterSwitchParams):
    """MC flips of the eligible molecules (:733-839) with the (maxmol + 1,)
    uniforms ``u``.  Returns (new types, new mol_state, accept mask,
    eligible mask)."""
    M = params.maxmol
    switchable = (mol_state == 0) | (mol_state == 1)
    # the seed cluster is locked (:693-698); the seed pair itself is never
    # eligible (:144-153)
    m_idx = torch.arange(M + 1, device=state.device)
    is_seed = ((m_idx == params.mol_seed)
               | (m_idx == params.mol_seed - params.mol_offset))
    eligible = present & switchable & ~in_cluster & ~is_seed
    p_acc = torch.where(mol_state == 0, params.probON, 1.0 - params.probON)
    accept = eligible & (u.to(p_acc.dtype) < p_acc)

    mol, t = state.mol.long(), state.typ.long()
    flipped = torch.where(mol_state[mol] == 0, params.off_to_on[t],
                          params.on_to_off[t])
    new_typ = torch.where(accept[mol], flipped, t).to(state.typ.dtype)
    new_mol_state = torch.where(accept, 1 - mol_state, mol_state)
    return new_typ, new_mol_state, accept, eligible


def apply(u: torch.Tensor, state: SimState, nbr,
          params: ClusterSwitchParams, stats: ClusterSwitchStats,
          ring=None, valid=None):
    """One cluster-switch event with the accept uniforms ``u``.  Returns
    (state', stats', info); info holds the per-molecule cluster and state
    vectors for the event logs (cluster_assignment.log /
    state_assignment.log, :704-725), ``converged`` and ``sweeps``.
    ``ring`` and ``valid``: the distributed form (module docstring); the
    stats and info are then the same on every rank."""
    (labels, mol_state, present, in_cluster, n_cluster, converged,
     sweeps) = check_cluster(state, nbr, params, ring, valid)
    # the cluster's switchable molecules become designated ON (:693-697)
    switchable = (mol_state == 0) | (mol_state == 1)
    mol_state = torch.where(switchable & in_cluster, 1, mol_state)
    new_typ, new_mol_state, accept, eligible = attempt_switch(
        u, state, mol_state, present, in_cluster, params)
    att_on = eligible & (mol_state == 0)
    att_off = eligible & (mol_state == 1)
    d = torch.stack([eligible.sum(), accept.sum(), att_on.sum(),
                     att_off.sum(), (accept & att_on).sum(),
                     (accept & att_off).sum(), torch.zeros_like(n_cluster)])
    v = stats.v + d.to(stats.v.dtype)
    v[6] = n_cluster.to(v.dtype)
    info = {"in_cluster": in_cluster, "mol_state": new_mol_state,
            "n_cluster": n_cluster, "accept": accept, "converged": converged,
            "sweeps": sweeps}
    return (dataclasses.replace(state, typ=new_typ),
            ClusterSwitchStats(v=v), info)
