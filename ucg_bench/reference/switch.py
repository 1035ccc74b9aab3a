"""One ``fix cluster_switch`` event, written plainly
(fix_cluster_switch.cpp:537-839): molecules connected by a contact (a pair
of beads whose types the contact map joins, closer than the contact
cutoff) or by the ``mol_offset`` partner link form clusters; the seed
molecule's cluster is locked ON; every other present switchable molecule
flips with probability probON (OFF to ON) or 1 - probON (ON to OFF), its
beads' types moving between the ON and OFF lists.

The program keeps positions in float32, so a contact whose squared distance
lies within ``band`` of the cutoff's square is not decided by the
configuration's precision.  The seed's cluster is worked out with every
such contact and with none of them; a molecule in the first and not in the
second is undecided and is not judged.  Connectivity only grows with
edges, so every other molecule's membership is the same either way.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from ucg_bench.reference.pairs import min_image, pairs_within

BAND = 1e-4


def _seed_cluster(nmol, a, b, seed):
    g = coo_matrix((np.ones(len(a), np.int8), (a, b)), shape=(nmol, nmol))
    _, lab = connected_components(g, directed=False)
    return lab == lab[seed]


def event(sw: dict, x, typ, mol, u, L, dtype, band: float = BAND):
    """(new types, in_cluster, decided) of one event: ``x`` (N, 3), ``typ``
    and ``mol`` of the beads before it, ``u`` the (maxmol + 1,) accept
    uniforms.  ``in_cluster`` and ``decided`` are per molecule id."""
    dev = x.device
    typ = typ.long()
    mol = mol.long()
    M = int(mol.max())
    T = int(max(max(sw["on"]), max(sw["off"]), int(typ.max())))
    cmap = torch.zeros((T + 1, T + 1), dtype=torch.bool, device=dev)
    for a, b in sw["contacts"]:
        cmap[a, b] = cmap[b, a] = True
    cut = sw["cutoff"]
    i, j = pairs_within(x, L, cut + 0.01, half=True)
    ok = cmap[typ[i], typ[j]]
    i, j = i[ok], j[ok]
    xd = x.to(dtype)
    dr = min_image(xd[i] - xd[j], torch.as_tensor(L, dtype=dtype, device=dev))
    rsq = (dr * dr).sum(-1).double()
    sure = rsq < cut * cut - band
    maybe = rsq < cut * cut + band
    is_on = torch.zeros(T + 1, dtype=torch.bool, device=dev)
    is_off = torch.zeros(T + 1, dtype=torch.bool, device=dev)
    on_of = torch.arange(T + 1, device=dev)
    off_of = torch.arange(T + 1, device=dev)
    for on_t, off_t in zip(sw["on"], sw["off"]):
        is_on[on_t], is_off[off_t] = True, True
        on_of[off_t], off_of[on_t] = on_t, off_t
    state = torch.where(is_on[typ], 1, torch.where(is_off[typ], 0, -1))
    mol_state = torch.full((M + 1,), -1, dtype=torch.int64, device=dev)
    mol_state.scatter_reduce_(0, mol, state, "amax")
    present = torch.zeros(M + 1, dtype=torch.bool, device=dev)
    present[mol] = True
    switchable = (mol_state == 0) | (mol_state == 1)
    ids = torch.arange(M + 1, device=dev)
    partner = torch.where(switchable, ids - sw["mol_offset"],
                          ids + sw["mol_offset"]).clamp(0, M)
    links = [(ids[present].cpu().numpy(), partner[present].cpu().numpy())]

    def cluster(mask):
        a = np.concatenate([mol[i[mask]].cpu().numpy(), links[0][0]])
        b = np.concatenate([mol[j[mask]].cpu().numpy(), links[0][1]])
        return torch.as_tensor(_seed_cluster(M + 1, a, b, sw["mol_seed"]),
                               device=dev)

    lo, hi = cluster(sure), cluster(maybe)
    decided = lo == hi
    in_cluster = lo & present
    seed = sw["mol_seed"]
    is_seed = (ids == seed) | (ids == seed - sw["mol_offset"])
    mol_state = torch.where(switchable & in_cluster, 1, mol_state)
    eligible = present & switchable & ~in_cluster & ~is_seed
    p_on = torch.as_tensor(sw["probON"], dtype=dtype, device=dev)
    p_acc = torch.where(mol_state == 0, p_on, 1.0 - p_on)
    accept = eligible & (u.to(dtype) < p_acc)
    flipped = torch.where(mol_state[mol] == 0, on_of[typ], off_of[typ])
    new_typ = torch.where(accept[mol], flipped, typ)
    return new_typ, in_cluster, decided
