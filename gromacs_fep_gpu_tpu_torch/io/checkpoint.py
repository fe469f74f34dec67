"""Checkpoint/restart of the port's simulation state — counterpart of
gromacs_fep_gpu_tpu/io/checkpoint.py (save_checkpoint, load_checkpoint;
reference: src/gromacs/fileio/checkpoint.cpp:2333 write_checkpoint_data /
:2635 read_checkpoint — the full t_state incl. lambda, fep_state, the
coupling variables and the RNG).

Format: an npz holding every State and CouplingState field by name and
the state of the generator of the thermostat's and sd's draws.  The JAX
package's .cpt flattens its pytree by position instead, so neither
package reads the other's .cpt: restarts across the two go through the
GROMACS-format .gmx.cpt (io/cptio.py), which both read.  Writes are atomic (tmp + rename), so an
interrupted write never corrupts the previous checkpoint.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..core.types import CouplingState, State

FORMAT = "gromacs_fep_gpu_tpu_torch state"
FORMAT_VERSION = 1
_INT_FIELDS = ("step", "fep_state")


def save_checkpoint(path: str, state: State,
                    generator: Optional[torch.Generator] = None):
    payload = {"format": np.asarray(FORMAT),
               "format_version": np.asarray(FORMAT_VERSION)}
    for f in dataclasses.fields(State):
        v = getattr(state, f.name)
        if f.name == "coupling":
            for cf in dataclasses.fields(CouplingState):
                payload[f"coupling_{cf.name}"] = (
                    getattr(v, cf.name).detach().cpu().numpy())
        elif f.name in _INT_FIELDS:
            payload[f.name] = np.asarray(int(v), np.int64)
        else:
            payload[f.name] = v.detach().cpu().numpy()
    if generator is not None:
        payload["generator_state"] = generator.get_state().numpy()
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".cpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, device,
                    generator: Optional[torch.Generator] = None) -> State:
    """The State on `device`; restores `generator` when the file holds a
    generator state."""
    data = np.load(path)
    if "format" not in data.files or str(data["format"]) != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of this package (a "
                         "checkpoint of the JAX package restarts through "
                         "its .gmx.cpt)")
    if int(data["format_version"]) != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format version "
                         f"{int(data['format_version'])}, expected "
                         f"{FORMAT_VERSION}")
    dev = torch.device(device)

    def t(name):
        return torch.as_tensor(data[name], device=dev)
    coupling = CouplingState(**{cf.name: t(f"coupling_{cf.name}")
                                for cf in dataclasses.fields(CouplingState)})
    kw = {}
    for f in dataclasses.fields(State):
        if f.name == "coupling":
            kw[f.name] = coupling
        elif f.name in _INT_FIELDS:
            kw[f.name] = int(data[f.name])
        else:
            kw[f.name] = t(f.name)
    if generator is not None and "generator_state" in data.files:
        generator.set_state(torch.as_tensor(data["generator_state"]))
    return State(**kw)
