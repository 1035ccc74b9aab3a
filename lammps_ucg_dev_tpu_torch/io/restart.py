"""Binary checkpoint/restart (port of ``lammps_ucg_dev_tpu/io/restart.py``).

The reference's restart persists the per-atom UCG fields
{ucgstate, ucgl, ucgml, ucgvl, ucgp} with the atom style
(atom_vec_ucg.cpp:85) and only the pair-style SETTINGS (tables must be
re-declared after restart, pair_table_ucgld.cpp:1431-1471).  A restart file
is one .npz of the full SimState (positions, velocities, types, molecules,
charges, images, all UCG fields, step, box with its tilt), the pair-style
SETTINGS (style name, tabstyle, tablength), units and per-type masses, and
optional ``extra_`` entries (fix state).  Its fields, dtypes and
``_VERSION`` are the JAX package's, so each package reads the other's
file.

The random state does not convert (a JAX threefry key against a
``torch.Generator``).  The JAX reader requires a ``key``, so this writer
stores a uint32 (2,) key: ``[0, seed]``, the JAX package's
``PRNGKey(seed)`` of the caller's seed.  The port's own random state rides
in ``extra_`` entries (the deck runner's generators and its resume record,
``compat/script.py``); this reader ignores a ``key``.
"""

from __future__ import annotations

import numpy as np
import torch

from lammps_ucg_dev_tpu_torch.core.state import Box, SimState, resolve_device
from lammps_ucg_dev_tpu_torch.io.data import host

_VERSION = 1


def jax_key(seed: int) -> np.ndarray:
    """The raw uint32 (2,) threefry key of the JAX package's
    ``PRNGKey(seed)`` for 0 <= seed < 2^32."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def write_restart(path: str, state: SimState, extra: dict | None = None,
                  settings: dict | None = None, seed: int = 0) -> None:
    """``settings`` is a flat dict of scalars/strings/1-D arrays describing
    the non-atom configuration (pair style + tabstyle + tablength, units,
    per-type masses) — the analogue of the reference's
    ``PairTable_UCGLD::write_restart_settings``.  ``seed`` fills the JAX
    ``key`` field."""
    arrays = {
        "version": np.asarray(_VERSION),
        "step": np.asarray(state.step, np.int32),
        "x": host(state.x),
        "v": host(state.v),
        "tag": host(state.tag),
        "typ": host(state.typ),
        "mol": host(state.mol),
        "q": host(state.q),
        "image": host(state.image),
        "ucgstate": host(state.ucgstate),
        "ucgl": host(state.ucgl),
        "ucgvl": host(state.ucgvl),
        "ucgml": host(state.ucgml),
        "ucgp": host(state.ucgp),
        "key": jax_key(seed),
        "box_lo": host(state.box.lo),
        "box_hi": host(state.box.hi),
        "box_periodic": np.asarray(state.box.periodic),
        "box_tilt": (host(state.box.tilt) if state.box.tilt is not None
                     else np.zeros(0)),
    }
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = host(v)
    for k, v in (settings or {}).items():
        arrays[f"setting_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def read_restart(path: str, dtype=torch.float32, device="cuda"):
    """Returns (SimState, extra_dict)."""
    state, extra, _ = read_restart_all(path, dtype, device)
    return state, extra


def read_restart_all(path: str, dtype=torch.float32, device="cuda"):
    """Returns (SimState, extra_dict, settings_dict) from ONE archive read
    (large restarts decompress the full per-atom state; loading twice to
    split state from settings would double that cost).  The state lands on
    ``device`` (the card unless told ``device="cpu"``); a ``box_tilt`` of
    three values makes the box triclinic."""
    device = resolve_device(device)
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != _VERSION:
        raise ValueError(f"unsupported restart version {int(z['version'])}")

    def t(name, dt):
        return torch.as_tensor(z[name], dtype=dt, device=device)

    i32 = torch.int32
    tilted = "box_tilt" in z.files and z["box_tilt"].size == 3
    box = Box(lo=t("box_lo", dtype), hi=t("box_hi", dtype),
              tilt=t("box_tilt", dtype) if tilted else None,
              periodic=tuple(bool(p) for p in z["box_periodic"]))
    n = z["x"].shape[0]
    state = SimState(
        step=int(z["step"]), x=t("x", dtype), v=t("v", dtype),
        tag=(t("tag", i32) if "tag" in z.files else
             torch.arange(1, n + 1, dtype=i32, device=device)),
        typ=t("typ", i32), mol=t("mol", i32), q=t("q", dtype),
        image=t("image", i32), ucgstate=t("ucgstate", i32),
        ucgl=t("ucgl", dtype), ucgvl=t("ucgvl", dtype),
        ucgml=t("ucgml", dtype), ucgp=t("ucgp", dtype), box=box)
    extra = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
    return state, extra, _settings_from(z)


def read_restart_settings(path: str) -> dict:
    """The ``settings`` dict stored by :func:`write_restart` (empty for
    restarts written before settings persistence).  String-valued settings
    come back as Python str, 0-d numerics as Python scalars."""
    return _settings_from(np.load(path, allow_pickle=False))


def _settings_from(z) -> dict:
    out = {}
    for k in z.files:
        if not k.startswith("setting_"):
            continue
        v = z[k]
        if v.dtype.kind in "US":
            out[k[len("setting_"):]] = str(v)
        elif v.ndim == 0:
            out[k[len("setting_"):]] = v.item()
        else:
            out[k[len("setting_"):]] = v
    return out
