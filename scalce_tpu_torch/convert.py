"""State carried across between ``scalce_tpu`` and the port.

A codec has no weights: its state is the Config, the per-block rANS
tables and the container, and the file format carries all three (a
triplet written by either package decodes with the other).  What
crosses in memory is arrays: the reference's numpy/JAX stage arrays
(u32, i32, u8, ...) and the port's tensors.  torch has no arithmetic
on ``uint16``/``uint32``, so those widen to int32/int64 holding the same
values (``ops/bitops.py``); every other dtype crosses as it is.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_WIDEN = {np.dtype(np.uint16): np.int32, np.dtype(np.uint32): np.int64}


def host_form(a) -> np.ndarray:
    """A reference array as the port's tensors hold it: u16 -> int32,
    u32 -> int64, other dtypes unchanged; C-contiguous and writable (what
    ``torch.from_numpy`` takes without a copy)."""
    a = np.asarray(a)
    wide = _WIDEN.get(a.dtype)
    if wide is not None:
        return a.astype(wide)
    if not (a.flags.c_contiguous and a.flags.writeable):
        return a.copy()
    return a


def from_reference(arrays: Mapping[str, np.ndarray], device
                   ) -> Dict[str, torch.Tensor]:
    """Reference arrays -> port tensors on ``device`` (u16 -> int32,
    u32 -> int64, other dtypes unchanged)."""
    return {name: torch.from_numpy(host_form(a)).to(device)
            for name, a in arrays.items()}


def to_numpy(tensors: Mapping[str, torch.Tensor],
             dtypes: Mapping[str, np.dtype]) -> Dict[str, np.ndarray]:
    """Port tensors -> numpy arrays of the reference's ``dtypes`` (for
    example ``{"perm": np.int32, "ck": np.uint32}``)."""
    return {name: t.detach().cpu().numpy().astype(dtypes[name], copy=False)
            for name, t in tensors.items()}
