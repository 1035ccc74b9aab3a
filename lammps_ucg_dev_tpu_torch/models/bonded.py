"""Bonded interactions on a fixed topology (port of
``lammps_ucg_dev_tpu/models/bonded.py``).

``atom_style ucg`` is molecular: the reference's atom style carries bonds,
angles, dihedrals and impropers (``UCG/atom_vec_ucg.cpp:33-96``) and the
stock LAMMPS styles compute their forces:

* ``bond_style harmonic``:     E = K (r - r0)^2,   F = -2 K (r - r0) r̂
* ``angle_style harmonic``:    E = K (θ - θ0)^2    (θ0 given in degrees)
* ``dihedral_style harmonic``: E = K [1 + d cos(nφ)],  d = ±1
* ``improper_style harmonic``: E = K (χ - χ0)^2    (χ0 given in degrees)

Topology is stored as atom TAGS; a tag→row map is rebuilt at each
evaluation.  Bonds and angles are in closed form.  Dihedrals and impropers
take their member forces from one ``torch.autograd.grad`` of the summed
energy with respect to the three min-imaged bond vectors, so F = -∇E
exactly and momentum is conserved by construction.  Per-term forces are
scattered to their member rows with ``index_add_`` (on CUDA that sum's
order, and so its last bits, can vary from run to run).  Energies and
virials are tallied once per term (newton-on bookkeeping).

Exclusions: :func:`special_tags` builds the per-atom special-partner tag
lists that ``special_bonds lj 0 0 0`` (the default) removes from the pair
lists.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import SimState, resolve_device

ACOS_SIN_FLOOR = 1e-3    # improper_harmonic's SMALL
ANGLE_SIN_FLOOR = 1e-8   # angle_harmonic's SMALL


@dataclasses.dataclass(frozen=True)
class BondedParams:
    """Fixed-shape topology with per-term coefficients (gathered by type,
    so evaluation has no type indirection).  Zero-length arrays are
    valid."""

    bond_tags: torch.Tensor      # (B, 2) int64, 1-based atom tags
    bond_k: torch.Tensor         # (B,)
    bond_r0: torch.Tensor        # (B,)
    angle_tags: torch.Tensor     # (A, 3) int64 tags; the center is column 1
    angle_k: torch.Tensor        # (A,)
    angle_t0: torch.Tensor       # (A,) radians
    dihedral_tags: torch.Tensor  # (D, 4) int64 tags, chain order 1-2-3-4
    dihedral_k: torch.Tensor     # (D,)
    dihedral_d: torch.Tensor     # (D,) ±1 in E = K[1 + d cos(nφ)]
    dihedral_wsel: torch.Tensor  # (D, NMAX+1) one-hot multiplicity selector
    improper_tags: torch.Tensor  # (I, 4) int64 tags (χ over the 1-2-3-4 chain)
    improper_k: torch.Tensor     # (I,)
    improper_x0: torch.Tensor    # (I,) radians

    @property
    def n_bonds(self) -> int:
        return self.bond_tags.shape[0]

    @property
    def n_angles(self) -> int:
        return self.angle_tags.shape[0]

    @property
    def n_dihedrals(self) -> int:
        return self.dihedral_tags.shape[0]

    @property
    def n_impropers(self) -> int:
        return self.improper_tags.shape[0]


def _coeffs(rows, coeffs, what: str, ncols: int):
    """(tags (R, ncols), [coefficient column arrays]) of data-file rows
    ``id type a1 .. a_ncols`` and a ``{type: coefficients}`` dict."""
    rows = np.asarray(rows, np.int64)
    missing = set(rows[:, 1]) - set(coeffs or {})
    if missing:
        raise ValueError(f"no {what}_coeff for {what} types "
                         f"{sorted(missing)}")
    cols = list(zip(*(coeffs[t] for t in rows[:, 1])))
    return rows[:, 2:2 + ncols], [np.asarray(c) for c in cols]


def make_params(bonds=None, bond_coeffs=None, angles=None,
                angle_coeffs=None, dtype=torch.float32, dihedrals=None,
                dihedral_coeffs=None, impropers=None, improper_coeffs=None,
                device="cuda") -> BondedParams:
    """From data-file topology rows (``(nb, 4) = id type a1 a2`` bonds,
    ``(na, 5) = id type a1 a2 a3`` angles, ``(nd/ni, 6) = id type a1 a2 a3
    a4`` dihedrals/impropers) and per-type coefficient dicts ``{type: (K,
    r0)}`` / ``{type: (K, theta0_degrees)}`` / ``{type: (K, d, n)}`` /
    ``{type: (K, chi0_degrees)}``.  Builds on the CUDA device unless given
    ``device="cpu"``."""
    device = resolve_device(device)
    empty = np.zeros((0,))
    bt, (bk, br) = ((np.zeros((0, 2), np.int64), (empty, empty))
                    if bonds is None or len(bonds) == 0
                    else _coeffs(bonds, bond_coeffs, "bond", 2))
    at, (ak, a0) = ((np.zeros((0, 3), np.int64), (empty, empty))
                    if angles is None or len(angles) == 0
                    else _coeffs(angles, angle_coeffs, "angle", 3))
    a0 = np.deg2rad(a0)
    if dihedrals is None or len(dihedrals) == 0:
        dtags, dk, dd, dw = (np.zeros((0, 4), np.int64), empty, empty,
                             np.zeros((0, 1)))
    else:
        dtags, (dk, dd, dn) = _coeffs(dihedrals, dihedral_coeffs,
                                      "dihedral", 4)
        if not np.all(np.isin(dd, (-1.0, 1.0))):
            raise ValueError("dihedral harmonic d must be +1 or -1")
        dn = dn.astype(np.int64)
        if np.any(dn < 0):
            raise ValueError("dihedral harmonic n must be >= 0")
        dw = np.zeros((len(dn), int(dn.max()) + 1))
        dw[np.arange(len(dn)), dn] = 1.0           # one-hot T_n selector
    it, (ik, ix0) = ((np.zeros((0, 4), np.int64), (empty, empty))
                     if impropers is None or len(impropers) == 0
                     else _coeffs(impropers, improper_coeffs, "improper", 4))
    ix0 = np.deg2rad(ix0)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return BondedParams(
        bond_tags=i(bt), bond_k=f(bk), bond_r0=f(br), angle_tags=i(at),
        angle_k=f(ak), angle_t0=f(a0), dihedral_tags=i(dtags),
        dihedral_k=f(dk), dihedral_d=f(dd), dihedral_wsel=f(dw),
        improper_tags=i(it), improper_k=f(ik), improper_x0=f(ix0))


def _tag_rows(state: SimState) -> torch.Tensor:
    """tag → storage-row map (the identity while atoms are unsorted)."""
    inv = torch.zeros(state.rng_n, dtype=torch.int64, device=state.device)
    inv[state.tag.long() - 1] = torch.arange(state.n_atoms,
                                             device=state.device)
    return inv


def _rows(inv, tags):
    return [inv[tags[:, k] - 1] for k in range(tags.shape[1])]


def _cos_torsion(b1, b2, b3):
    """cos φ = (b1×b2)·(b2×b3) / (|b1×b2| |b2×b3|) of the bond-vector chain,
    guarded against collinear chains (|n| → 0).  Both the dihedral and the
    improper harmonic styles' plane-normal forms reduce to it."""
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    denom = torch.sqrt(torch.clamp(torch.sum(n1 * n1, -1)
                                   * torch.sum(n2 * n2, -1), min=1e-24))
    return torch.clamp(torch.sum(n1 * n2, -1) / denom, -1.0, 1.0)


class _AcosGuarded(torch.autograd.Function):
    """arccos whose derivative carries improper_harmonic's sin guard:
    d/dc = -1/max(√(1-c²), 1e-3), so the improper force stays finite at
    planar χ (0 or π), where plain autograd of arccos divides by zero."""

    @staticmethod
    def forward(ctx, c):
        cc = torch.clamp(c, -1.0, 1.0)
        ctx.save_for_backward(cc)
        return torch.arccos(cc)

    @staticmethod
    def backward(ctx, grad):
        (cc,) = ctx.saved_tensors
        s = torch.clamp(torch.sqrt(torch.clamp(1.0 - cc * cc, min=0.0)),
                        min=ACOS_SIN_FLOOR)
        return -grad / s


def _dihedral_e_of_c(k, d, wsel):
    """E(c) = K [1 + d·T_n(cos φ)]: cos(nφ) by the Chebyshev recurrence (a
    polynomial in c, smooth everywhere), n chosen per term by ``wsel``."""
    deg = wsel.shape[1] - 1

    def e(c):
        tprev = torch.ones_like(c)
        acc = wsel[:, 0] * tprev
        tcur = c
        if deg >= 1:
            acc = acc + wsel[:, 1] * tcur
        for m in range(2, deg + 1):
            tnew = 2.0 * c * tcur - tprev
            acc = acc + wsel[:, m] * tnew
            tprev, tcur = tcur, tnew
        return k * (1.0 + d * acc)

    return e


def _improper_e_of_c(k, x0):
    """E(c) = K (χ - χ0)², χ = arccos(c) with the guarded derivative."""
    def e(c):
        return k * (_AcosGuarded.apply(c) - x0) ** 2

    return e


def _torsion_terms(x, box, i1, i2, i3, i4, e_of_c):
    """4-body terms in bond-vector form: (per-term energies (T,), member
    forces f1..f4 (T, 3) with f1 = g1, f2 = g2 - g1, f3 = g3 - g2, f4 = -g3,
    per-term virials (T, 6) W = -Σ_j b_j ⊗ g_j, off-diagonal symmetrized),
    g_j = dE/db_j from one autograd pass."""
    b1 = box.min_image(x[i2] - x[i1])
    b2 = box.min_image(x[i3] - x[i2])
    b3 = box.min_image(x[i4] - x[i3])
    with torch.enable_grad():
        bs = torch.stack([b1, b2, b3], dim=1).detach().requires_grad_(True)
        pe_t = e_of_c(_cos_torsion(bs[:, 0], bs[:, 1], bs[:, 2]))
        (g,) = torch.autograd.grad(pe_t.sum(), bs)
    pe_t = pe_t.detach()
    g1, g2, g3 = g[:, 0], g[:, 1], g[:, 2]
    bb, gg = (b1, b2, b3), (g1, g2, g3)
    diag = [-sum(b[:, a] * gj[:, a] for b, gj in zip(bb, gg))
            for a in range(3)]
    off = [-0.5 * sum(b[:, a] * gj[:, c] + b[:, c] * gj[:, a]
                      for b, gj in zip(bb, gg))
           for (a, c) in ((0, 1), (0, 2), (1, 2))]
    return pe_t, (g1, g2 - g1, g3 - g2, -g3), torch.stack(diag + off, dim=1)


def _vtally(fpair, d):
    return torch.stack([
        torch.sum(fpair * d[:, 0] * d[:, 0]),
        torch.sum(fpair * d[:, 1] * d[:, 1]),
        torch.sum(fpair * d[:, 2] * d[:, 2]),
        torch.sum(fpair * d[:, 0] * d[:, 1]),
        torch.sum(fpair * d[:, 0] * d[:, 2]),
        torch.sum(fpair * d[:, 1] * d[:, 2])])


def compute(state: SimState, params: BondedParams):
    """(f, pe, virial) of every bonded term, shaped as the pair ForceOut's
    fields so the driver adds them in.  Coefficients are cast to the
    state's dtype (params built at another precision must not widen
    pe/virial)."""
    x, box = state.x, state.box
    dt = x.dtype
    f = torch.zeros_like(x)
    pe = torch.zeros((), dtype=dt, device=x.device)
    vir = torch.zeros(6, dtype=dt, device=x.device)
    inv = _tag_rows(state)

    if params.n_bonds:
        i, j = _rows(inv, params.bond_tags)
        k, r0 = params.bond_k.to(dt), params.bond_r0.to(dt)
        d = box.min_image(x[i] - x[j])
        r = torch.sqrt(torch.sum(d * d, dim=1))
        dr = r - r0
        # bond_harmonic.cpp: fbond = -2 K dr / r; f[i] += fbond d
        fbond = torch.where(r > 0, -2.0 * k * dr / r, torch.zeros_like(r))
        fb = fbond[:, None] * d
        f.index_add_(0, i, fb)
        f.index_add_(0, j, -fb)
        pe = pe + torch.sum(k * dr * dr)
        vir = vir + _vtally(fbond, d)

    if params.n_angles:
        i1, i2, i3 = _rows(inv, params.angle_tags)
        k, t0 = params.angle_k.to(dt), params.angle_t0.to(dt)
        d1 = box.min_image(x[i1] - x[i2])
        d2 = box.min_image(x[i3] - x[i2])
        r1 = torch.sqrt(torch.sum(d1 * d1, dim=1))
        r2 = torch.sqrt(torch.sum(d2 * d2, dim=1))
        c = torch.clamp(torch.sum(d1 * d2, dim=1) / (r1 * r2), -1.0, 1.0)
        s = torch.clamp(torch.sqrt(1.0 - c * c), min=ANGLE_SIN_FLOOR)
        dtheta = torch.arccos(c) - t0
        a = -2.0 * k * dtheta / s
        a11 = a * c / (r1 * r1)
        a12 = -a / (r1 * r2)
        a22 = a * c / (r2 * r2)
        f1 = a11[:, None] * d1 + a12[:, None] * d2
        f3 = a22[:, None] * d2 + a12[:, None] * d1
        f.index_add_(0, i1, f1)
        f.index_add_(0, i3, f3)
        f.index_add_(0, i2, -(f1 + f3))
        pe = pe + torch.sum(k * dtheta * dtheta)
        vir = vir + torch.stack([
            torch.sum(d1[:, a] * f1[:, b] + d2[:, a] * f3[:, b])
            for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])

    for n_terms, tags, e_of_c in (
            (params.n_dihedrals, params.dihedral_tags,
             lambda: _dihedral_e_of_c(params.dihedral_k.to(dt),
                                      params.dihedral_d.to(dt),
                                      params.dihedral_wsel.to(dt))),
            (params.n_impropers, params.improper_tags,
             lambda: _improper_e_of_c(params.improper_k.to(dt),
                                      params.improper_x0.to(dt)))):
        if n_terms:
            rows = _rows(inv, tags)
            pe_t, fs, vir_t = _torsion_terms(x, box, *rows, e_of_c())
            for r, fm in zip(rows, fs):
                f.index_add_(0, r, fm)
            pe = pe + torch.sum(pe_t)
            vir = vir + torch.sum(vir_t, dim=0)

    return f, pe, vir


def compute_spatial(state: SimState, params: BondedParams, rows: dict,
                    nloc):
    """(f, pe, virial) of the bonded terms on one rank of the spatial
    drivers (JAX ``bonded.compute_spatial``).  The topology is replicated
    on every rank; ``rows`` holds this rank's row of each term member,
    ``{"bond": (i, j), "angle": (a1, a2, a3), "dihedral": (d1..d4),
    "improper": (i1..i4)}``, with ``n_rows`` where the member is absent,
    and rows below ``nloc`` are owned.  The driver maps the tags once per
    block and raises its overflow flag when a term with an owned member
    misses one (bonds are shorter than the halo).

    Newton-off bookkeeping, as the pair pass: each owned member takes only
    its own share of the force, and pe and the virial are tallied 1/2 per
    owned bond member, 1/3 per owned angle member and 1/4 per owned
    dihedral or improper member, so the sum over the ranks counts each
    term once.  Terms with an absent member add nothing."""
    x, box = state.x, state.box
    n = x.shape[0]
    dt = x.dtype
    dev = x.device
    f = torch.zeros((n + 1, 3), dtype=dt, device=dev)   # row n: dropped
    pe = torch.zeros((), dtype=dt, device=dev)
    vir = torch.zeros(6, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def members(key):
        rs = rows[key]
        pres = functools.reduce(torch.logical_and, [r < n for r in rs])
        owned = [pres & (r < nloc) for r in rs]
        return (pres, [torch.where(o, r, n) for r, o in zip(rs, owned)],
                [o.to(dt) for o in owned], [torch.clamp(r, max=n - 1)
                                            for r in rs])

    if params.n_bonds:
        pres, (si, sj), (wi, wj), (ic, jc) = members("bond")
        k, r0 = params.bond_k.to(dt), params.bond_r0.to(dt)
        d = box.min_image(x[ic] - x[jc])
        r = torch.sqrt(torch.sum(d * d, dim=1))
        dr = r - r0
        fbond = torch.where(pres & (r > 0), -2.0 * k * dr / r, zero)
        fb = fbond[:, None] * d
        f.index_add_(0, si, fb)
        f.index_add_(0, sj, -fb)
        w2 = 0.5 * (wi + wj)
        pe = pe + torch.sum(torch.where(pres, w2 * k * dr * dr, zero))
        vir = vir + _vtally(w2 * fbond, d)

    if params.n_angles:
        pres, (s1, s2, s3), (w1, w2, w3), (i1, i2, i3) = members("angle")
        k, t0 = params.angle_k.to(dt), params.angle_t0.to(dt)
        d1 = box.min_image(x[i1] - x[i2])
        d2 = box.min_image(x[i3] - x[i2])
        r1 = torch.sqrt(torch.sum(d1 * d1, dim=1))
        r2 = torch.sqrt(torch.sum(d2 * d2, dim=1))
        c = torch.clamp(torch.sum(d1 * d2, dim=1)
                        / torch.clamp(r1 * r2, min=1e-30), -1.0, 1.0)
        s = torch.clamp(torch.sqrt(1.0 - c * c), min=ANGLE_SIN_FLOOR)
        dtheta = torch.arccos(c) - t0
        a = torch.where(pres, -2.0 * k * dtheta / s, zero)
        a11 = a * c / torch.clamp(r1 * r1, min=1e-30)
        a12 = -a / torch.clamp(r1 * r2, min=1e-30)
        a22 = a * c / torch.clamp(r2 * r2, min=1e-30)
        f1 = a11[:, None] * d1 + a12[:, None] * d2
        f3 = a22[:, None] * d2 + a12[:, None] * d1
        f.index_add_(0, s1, f1)
        f.index_add_(0, s3, f3)
        f.index_add_(0, s2, -(f1 + f3))
        wf = (w1 + w2 + w3) / 3.0
        pe = pe + torch.sum(torch.where(pres, wf * k * dtheta * dtheta,
                                        zero))
        vir = vir + torch.stack([
            torch.sum(wf * (d1[:, p] * f1[:, q] + d2[:, p] * f3[:, q]))
            for p, q in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])

    for key, n_terms, e_of_c in (
            ("dihedral", params.n_dihedrals,
             lambda: _dihedral_e_of_c(params.dihedral_k.to(dt),
                                      params.dihedral_d.to(dt),
                                      params.dihedral_wsel.to(dt))),
            ("improper", params.n_impropers,
             lambda: _improper_e_of_c(params.improper_k.to(dt),
                                      params.improper_x0.to(dt)))):
        if n_terms:
            pres, scat, ws, cl = members(key)
            pe_t, fs, vir_t = _torsion_terms(x, box, *cl, e_of_c())
            for r, fm in zip(scat, fs):
                f.index_add_(0, r, torch.where(pres[:, None], fm, zero))
            wf = sum(ws) / 4.0
            pe = pe + torch.sum(torch.where(pres, wf * pe_t, zero))
            vir = vir + torch.sum(torch.where(pres[:, None],
                                              wf[:, None] * vir_t, zero),
                                  dim=0)

    return f[:n], pe, vir


def potential_energy(x: torch.Tensor, state: SimState,
                     params: BondedParams) -> torch.Tensor:
    """E(x) of every bonded term, for autograd force checks (f = -∂E/∂x)."""
    box = state.box
    inv = _tag_rows(state)
    e = torch.zeros((), dtype=x.dtype, device=x.device)
    if params.n_bonds:
        i, j = _rows(inv, params.bond_tags)
        d = box.min_image(x[i] - x[j])
        r = torch.sqrt(torch.sum(d * d, dim=1))
        e = e + torch.sum(params.bond_k * (r - params.bond_r0) ** 2)
    if params.n_angles:
        i1, i2, i3 = _rows(inv, params.angle_tags)
        d1 = box.min_image(x[i1] - x[i2])
        d2 = box.min_image(x[i3] - x[i2])
        c = (torch.sum(d1 * d2, dim=1)
             / torch.sqrt(torch.sum(d1 * d1, 1) * torch.sum(d2 * d2, 1)))
        dtheta = torch.arccos(torch.clamp(c, -1.0, 1.0)) - params.angle_t0
        e = e + torch.sum(params.angle_k * dtheta * dtheta)

    def torsion_e(tags, e_of_c):
        i1, i2, i3, i4 = _rows(inv, tags)
        c = _cos_torsion(box.min_image(x[i2] - x[i1]),
                         box.min_image(x[i3] - x[i2]),
                         box.min_image(x[i4] - x[i3]))
        return torch.sum(e_of_c(c))

    if params.n_dihedrals:
        e = e + torsion_e(params.dihedral_tags,
                          _dihedral_e_of_c(params.dihedral_k,
                                           params.dihedral_d,
                                           params.dihedral_wsel))
    if params.n_impropers:
        e = e + torsion_e(params.improper_tags,
                          _improper_e_of_c(params.improper_k,
                                           params.improper_x0))
    return e


def special_tags(n_atoms: int, bonds=None, angles=None, dihedrals=None,
                 weights=(0.0, 0.0, 0.0),
                 cap: int | None = None) -> np.ndarray:
    """Per-atom special-partner TAG lists for pair-list exclusion (numpy).

    LAMMPS ``special_bonds`` with weight-0 orders only (the default ``lj 0 0
    0``): 1-2 partners from bonds, 1-3 from angles, 1-4 from dihedrals are
    removed from the pair lists.  Fractional weights raise.  Returns an
    (N, S) int32 array of tags, 0-padded; all zero when nothing is
    excluded."""
    for w in weights:
        if w not in (0.0, 1.0):
            raise NotImplementedError(
                f"fractional special_bonds weight {w} unsupported "
                "(only 0 = exclude, 1 = full)")
    per = [set() for _ in range(n_atoms + 1)]        # 1-based tags

    def pair(a, b):
        per[a].add(b)
        per[b].add(a)

    for w, rows, (ca, cb) in ((weights[0], bonds, (2, 3)),
                              (weights[1], angles, (2, 4)),
                              (weights[2], dihedrals, (2, 5))):
        if w == 0.0 and rows is not None:
            for row in np.asarray(rows, np.int64):
                pair(int(row[ca]), int(row[cb]))
    smax = max((len(s) for s in per), default=0)
    S = cap if cap is not None else max(smax, 1)
    if smax > S:
        raise ValueError(f"special-neighbor capacity {S} < max degree {smax}")
    out = np.zeros((n_atoms, S), np.int32)
    for tag in range(1, n_atoms + 1):
        lst = sorted(per[tag])
        out[tag - 1, :len(lst)] = lst
    return out
