"""Carry parameters and state across from the JAX package.

The JAX package's ``UCGLDParams`` / ``TableBank`` / ``UCGTypeParams`` /
``ChebBank``, ``BetheParams``, ``BetheDensityParams``, ``RLEUCGParams``,
``SimState``, the cluster lists' ``ClusterList``, ``BondedParams`` and
``ClusterSwitchParams`` are dataclasses of arrays.  ``as_numpy_dict``
turns any such object into nested dicts of numpy arrays and Python scalars (it reads
fields only and needs no JAX import); the ``*_from_numpy`` functions build
this package's counterparts from those dicts, so both packages can compute
on identical inputs.  They build on the CUDA device unless given
``device="cpu"``, and raise without CUDA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import Box, SimState, resolve_device
from lammps_ucg_dev_tpu_torch.fixes.cluster_switch import ClusterSwitchParams
from lammps_ucg_dev_tpu_torch.models.bonded import BondedParams
from lammps_ucg_dev_tpu_torch.models.pair_bethe import BetheParams
from lammps_ucg_dev_tpu_torch.models.pair_bethe_density import (
    BetheDensityParams)
from lammps_ucg_dev_tpu_torch.models.pair_rleucg import RLEUCGParams
from lammps_ucg_dev_tpu_torch.models.pair_ucgld import UCGLDParams
from lammps_ucg_dev_tpu_torch.models.typemap import UCGTypeParams
from lammps_ucg_dev_tpu_torch.ops.chebtab import ChebBank
from lammps_ucg_dev_tpu_torch.ops.clusters import CL as CLUSTER_SLOTS
from lammps_ucg_dev_tpu_torch.ops.clusters import ClusterList
from lammps_ucg_dev_tpu_torch.ops.table import BITMAP, SPLINE, TableBank


def as_numpy_dict(obj):
    """Dataclass → dict of numpy arrays / Python scalars, recursively."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: as_numpy_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str, tuple)):
        return obj
    return np.asarray(obj)


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _float_dtype(a) -> torch.dtype:
    return torch.float64 if np.asarray(a).dtype == np.float64 else torch.float32


def bank_from_numpy(d: dict, device="cuda") -> TableBank:
    """``d`` = as_numpy_dict(JAX TableBank), any style.  SPLINE keeps e2
    and f2; BITMAP's bin edges and widths come from channels 4 and 5 of
    the JAX bank's ``packed`` (T*L, 6) rows, its masks from nmask and
    nshiftbits."""
    device = resolve_device(device)
    style = d["style"]
    dt = _float_dtype(d["e"])
    T, L = np.asarray(d["e"]).shape
    kw = {}
    if style == SPLINE:
        kw = {k: _t(d[k], dt, device) for k in ("e2", "f2")}
    elif style == BITMAP:
        pk = np.asarray(d["packed"]).reshape(T, L, 6)
        kw = dict(rsq=_t(pk[..., 4], dt, device),
                  drsq=_t(pk[..., 5], dt, device),
                  nmask=_t(d["nmask"], torch.int32, device),
                  nshiftbits=_t(d["nshiftbits"], torch.int32, device))
    return TableBank(
        style=style, nbins=int(d["nbins"]),
        **{k: _t(d[k], dt, device) for k in ("innersq", "invdelta", "delta",
                                             "cutsq", "e", "f", "de", "df",
                                             "deltasq6")},
        uniform=bool(d["uniform"]), **kw)


def typeparams_from_numpy(d: dict, device="cuda") -> UCGTypeParams:
    device = resolve_device(device)
    dt = _float_dtype(d["cutsq"])
    return UCGTypeParams(
        n_states=_t(d["n_states"], torch.int32, device),
        formal=_t(d["formal"], torch.int32, device),
        mu=_t(d["mu"], dt, device), mu_diff=_t(d["mu_diff"], dt, device),
        tab4=_t(d["tab4"], torch.int64, device),
        cutsq=_t(d["cutsq"], dt, device),
        use_density=_t(d["use_density"], torch.int32, device),
        use_entropy=_t(d["use_entropy"], torch.int32, device),
        cv_threshold=_t(d["cv_threshold"], dt, device),
        threshold_radius=_t(d["threshold_radius"], dt, device))


def cheb_from_numpy(d: dict, device="cuda") -> ChebBank:
    device = resolve_device(device)
    dt = _float_dtype(d["coeffs"])
    return ChebBank(**{k: _t(d[k], dt, device)
                       for k in ("coeffs", "lo", "hi", "max_abs_err",
                                 "max_rel_err")},
                    degree=int(d["degree"]))


def params_from_numpy(d: dict, device="cuda") -> UCGLDParams:
    """``d`` = as_numpy_dict(JAX UCGLDParams)."""
    device = resolve_device(device)
    bank = bank_from_numpy(d["bank"], device)
    return UCGLDParams(
        bank=bank, tp=typeparams_from_numpy(d["tp"], device),
        kT=_t(d["kT"], bank.e.dtype, device), chunk=int(d.get("chunk", 0)),
        cheb=(cheb_from_numpy(d["cheb"], device) if d.get("cheb") is not None
              else None))


def bethe_params_from_numpy(d: dict, device="cuda") -> BetheParams:
    """``d`` = as_numpy_dict(JAX BetheParams)."""
    device = resolve_device(device)
    bank = bank_from_numpy(d["bank"], device)
    dt = bank.e.dtype
    return BetheParams(
        bank=bank, tp=typeparams_from_numpy(d["tp"], device),
        kT=_t(d["kT"], dt, device),
        prior_ptype=_t(d["prior_ptype"], _float_dtype(d["prior_ptype"]),
                       device),
        noise_level=_t(d["noise_level"], _float_dtype(d["noise_level"]),
                       device),
        method=str(d["method"]), pseudo=bool(d["pseudo"]),
        prior_mode=str(d["prior_mode"]), chunk=int(d.get("chunk", 0)),
        cheb=(cheb_from_numpy(d["cheb"], device) if d.get("cheb") is not None
              else None))


def _cheb(d: dict, device):
    return (cheb_from_numpy(d["cheb"], device) if d.get("cheb") is not None
            else None)


def bethe_density_params_from_numpy(d: dict,
                                    device="cuda") -> BetheDensityParams:
    """``d`` = as_numpy_dict(JAX BetheDensityParams)."""
    device = resolve_device(device)
    bank = bank_from_numpy(d["bank"], device)
    return BetheDensityParams(
        bank=bank, tp=typeparams_from_numpy(d["tp"], device),
        kT=_t(d["kT"], bank.e.dtype, device), method=str(d["method"]),
        backforce_derivative=bool(d["backforce_derivative"]),
        pair_cv=str(d["pair_cv"]), chunk=int(d.get("chunk", 0)),
        cheb=_cheb(d, device))


def rleucg_params_from_numpy(d: dict, device="cuda") -> RLEUCGParams:
    """``d`` = as_numpy_dict(JAX RLEUCGParams)."""
    device = resolve_device(device)
    bank = bank_from_numpy(d["bank"], device)
    dt = bank.e.dtype
    i32 = torch.int32
    return RLEUCGParams(
        bank=bank, tabSS=_t(d["tabSS"], torch.int64, device),
        cutsq=_t(d["cutsq"], dt, device),
        n_states=_t(d["n_states"], i32, device),
        actual_from_state=_t(d["actual_from_state"], i32, device),
        use_entropy=_t(d["use_entropy"], i32, device),
        mu=_t(d["mu"], dt, device), cv_threshold=_t(d["cv_threshold"], dt,
                                                    device),
        threshold_radius=_t(d["threshold_radius"], dt, device),
        kT=_t(d["kT"], dt, device), max_states=int(d["max_states"]),
        feedback=str(d["feedback"]),
        conservative_sign=bool(d["conservative_sign"]),
        chunk=int(d.get("chunk", 0)), cheb=_cheb(d, device))


def state_from_numpy(d: dict, device="cuda") -> SimState:
    """``d`` = as_numpy_dict(JAX SimState) of a global (unsharded) state,
    its box orthogonal or tilted."""
    device = resolve_device(device)
    box = d["box"]
    if d.get("n_total", 0) not in (0, len(d["x"])):
        raise NotImplementedError("sharded (local-view) states are not ported")
    dt = _float_dtype(d["x"])
    i32 = torch.int32
    return SimState(
        step=int(d["step"]),
        x=_t(d["x"], dt, device), v=_t(d["v"], dt, device),
        tag=_t(d["tag"], i32, device), typ=_t(d["typ"], i32, device),
        mol=_t(d["mol"], i32, device), q=_t(d["q"], dt, device),
        image=_t(d["image"], i32, device),
        ucgstate=_t(d["ucgstate"], i32, device),
        ucgl=_t(d["ucgl"], dt, device), ucgvl=_t(d["ucgvl"], dt, device),
        ucgml=_t(d["ucgml"], dt, device), ucgp=_t(d["ucgp"], dt, device),
        box=Box(lo=_t(box["lo"], dt, device), hi=_t(box["hi"], dt, device),
                tilt=(None if box.get("tilt") is None
                      else _t(box["tilt"], dt, device)),
                periodic=tuple(bool(p) for p in box["periodic"])))


def cluster_list_from_numpy(d: dict, device="cuda") -> ClusterList:
    """``d`` = as_numpy_dict(JAX ClusterList, ``attic/clusters.py``).  Each
    ``jcl`` row is compacted, real entries first (the attic masks a row in
    place when its stencil holds at most KC clusters), and the occupied
    i-clusters are found from ``slot_atom``."""
    device = resolve_device(device)
    i64 = torch.int64
    jcl = np.asarray(d["jcl"])
    jcl = np.take_along_axis(
        jcl, np.argsort(jcl >= jcl.shape[0], axis=1, kind="stable"), axis=1)
    slot_atom = np.asarray(d["slot_atom"])
    real = (slot_atom < len(d["atom_slot"])).reshape(-1, CLUSTER_SLOTS)
    return ClusterList(
        jcl=_t(jcl, torch.int32, device),
        atom_slot=_t(d["atom_slot"], i64, device),
        slot_atom=_t(slot_atom, i64, device),
        x0=_t(d["x0"], _float_dtype(d["x0"]), device),
        overflow=_t(d["overflow"], torch.bool, device),
        max_occupancy=_t(d["max_occupancy"], i64, device), kc=int(d["kc"]),
        occupied=_t(np.flatnonzero(real.any(axis=1)), torch.int32, device))


def bonded_params_from_numpy(d: dict, device="cuda") -> BondedParams:
    """``d`` = as_numpy_dict(JAX BondedParams); tags become int64."""
    device = resolve_device(device)
    return BondedParams(**{
        k: _t(v, torch.int64 if k.endswith("_tags") else _float_dtype(v),
              device) for k, v in d.items()})


def cluster_switch_params_from_numpy(d: dict,
                                     device="cuda") -> ClusterSwitchParams:
    """``d`` = as_numpy_dict(JAX ClusterSwitchParams); type maps become
    int64."""
    device = resolve_device(device)
    b, i64 = torch.bool, torch.int64
    return ClusterSwitchParams(
        contact_ok=_t(d["contact_ok"], b, device),
        off_to_on=_t(d["off_to_on"], i64, device),
        on_to_off=_t(d["on_to_off"], i64, device),
        is_on=_t(d["is_on"], b, device), is_off=_t(d["is_off"], b, device),
        cutsq=_t(d["cutsq"], _float_dtype(d["cutsq"]), device),
        probON=_t(d["probON"], _float_dtype(d["probON"]), device),
        **{k: int(d[k]) for k in ("maxmol", "max_sweeps", "mol_seed",
                                  "mol_offset")})
