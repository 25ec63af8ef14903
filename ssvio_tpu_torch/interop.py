"""Carry state between the JAX package and this port, through numpy.

The tests run a step in `ssvio_tpu`, take its state with `np.asarray`, turn
it into the port's tensors here, run the port's counterpart and compare.
This module imports neither jax nor `ssvio_tpu`: it reads any object with
the right field names (a JAX NamedTuple of arrays, a dict of numpy arrays)
and gives back the port's NamedTuples of tensors, or numpy dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Type

import numpy as np
import torch

from ssvio_tpu_torch import config
from ssvio_tpu_torch.engine import EngineCarry, FrameOut
from ssvio_tpu_torch.frontend import FeatState, Pyr
from ssvio_tpu_torch.map import MapState


def _field(src: Any, name: str):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def to_torch(src: Any, cls: Type[NamedTuple], device=None):
    """Build `cls` (a NamedTuple of tensors) from the same-named fields of
    `src`, each converted with np.asarray (dtypes kept)."""
    return cls(*[torch.as_tensor(np.array(np.asarray(_field(src, f))),
                                 device=device) for f in cls._fields])


def to_numpy(nt: NamedTuple) -> Dict[str, np.ndarray]:
    """A NamedTuple of tensors as a dict of numpy arrays."""
    return {f: v.detach().cpu().numpy() for f, v in zip(nt._fields, nt)}


def feat_state(src: Any, device=None) -> FeatState:
    return to_torch(src, FeatState, device)


def map_state(src: Any, device=None) -> MapState:
    return to_torch(src, MapState, device)


def pose(T: Any, device=None) -> torch.Tensor:
    """A [3, 4] pose (T_cw or rel_motion) as a float32 tensor."""
    return torch.as_tensor(np.array(np.asarray(T), np.float32), device=device)


def engine_carry(src: Any, device=None) -> EngineCarry:
    """The chunked engine's carry (JAX `engine.EngineCarry`): the pyramid,
    feature and map states as tensors, the status as a host int."""
    pyr = _field(src, "pyr_last")
    return EngineCarry(
        pyr_last=Pyr(*[tuple(torch.as_tensor(np.array(np.asarray(a)),
                                             device=device)
                             for a in _field(pyr, f)) for f in Pyr._fields]),
        feat=feat_state(_field(src, "feat"), device),
        T_cw=pose(_field(src, "T_cw"), device),
        rel_motion=pose(_field(src, "rel_motion"), device),
        m=map_state(_field(src, "m"), device),
        status=int(np.asarray(_field(src, "status"))))


def frame_out(src: Any, device=None) -> FrameOut:
    """A chunk's stacked per-frame outputs (JAX `engine.FrameOut`, whose
    loop descriptors `desc`/`dval` the port does not carry)."""
    fields = [f for f in FrameOut._fields if f != "feat"]
    return FrameOut(
        **{f: torch.as_tensor(np.array(np.asarray(_field(src, f))),
                              device=device) for f in fields},
        feat=feat_state(_field(src, "feat"), device))


def settings(src: Any) -> config.Settings:
    """The port's Settings with every field copied from a Settings-like
    dataclass (the JAX package's Settings has the same fields)."""
    out = config.Settings()
    for f in dataclasses.fields(config.Settings):
        v = getattr(src, f.name)
        if dataclasses.is_dataclass(v):
            v = config.CameraConfig(**dataclasses.asdict(v))
        setattr(out, f.name, v)
    return out
