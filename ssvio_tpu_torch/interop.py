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
from ssvio_tpu_torch.loopclosing import LoopClosing, LoopEvent
from ssvio_tpu_torch.map import MapState
from ssvio_tpu_torch.ops.bow import Vocabulary
from ssvio_tpu_torch.ops.pgo import PGOProblem


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
    """A chunk's stacked per-frame outputs (JAX `engine.FrameOut`), its
    uint32 loop descriptors carried as int32 bits."""
    fields = [f for f in FrameOut._fields if f not in ("feat", "desc")]
    return FrameOut(
        **{f: torch.as_tensor(np.array(np.asarray(_field(src, f))),
                              device=device) for f in fields},
        feat=feat_state(_field(src, "feat"), device),
        desc=descriptors(_field(src, "desc"), device))


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


def descriptors(desc_u32: Any, device=None) -> torch.Tensor:
    """Packed descriptors [..., 8] uint32 (the JAX package's) as the
    port's int32 tensor holding the same bits."""
    a = np.ascontiguousarray(np.asarray(desc_u32), np.uint32)
    return torch.as_tensor(a.view(np.int32).copy(), device=device)


def descriptors_numpy(desc: torch.Tensor) -> np.ndarray:
    """The port's int32 descriptors as the uint32 words they stand for."""
    return np.ascontiguousarray(desc.detach().cpu().numpy()).view(np.uint32)


def vocabulary(src: Any, device=None) -> Vocabulary:
    """A vocabulary tree (JAX `bow.Vocabulary`) as the port's, its uint32
    node descriptors carried as int32 bits."""
    return Vocabulary(
        descriptors(_field(src, "node_desc"), device),
        *[torch.as_tensor(np.array(np.asarray(_field(src, f))), device=device)
          for f in Vocabulary._fields[1:]])


def pgo_problem(src: Any, device=None) -> PGOProblem:
    return to_torch(src, PGOProblem, device)


_settings_of = settings


def loop_closing(src: Any, settings=None, device=None) -> LoopClosing:
    """The port's LoopClosing in the state of a JAX `LoopClosing`: the
    database tensors (descriptors as int32 bits), the row bookkeeping, the
    vocabulary, the gate state (last closure, drift-rate anchor and
    history, loop edges, events) and the deferred candidates. `settings`:
    the port's Settings, by default copied from `src.s`."""
    s = settings if settings is not None else _settings_of(_field(src, "s"))
    lc = LoopClosing(s, float(src._fx), float(src._fy), float(src._cx),
                     float(src._cy), device=device)

    def t(a):
        return torch.as_tensor(np.array(np.asarray(a)), device=device)

    lc.cap, lc.n = int(src.cap), int(src.n)
    lc.bow_db = t(src.bow_db)
    lc.desc_db = descriptors(src.desc_db, device)
    lc.desc_valid, lc.kp_xy = t(src.desc_valid), t(src.kp_xy)
    lc.lm_pos, lc.lm_has = t(src.lm_pos), t(src.lm_has)
    lc.lm_gid_db = t(src.lm_gid_db)
    lc.db_gid = np.array(src.db_gid, np.int64)
    lc.db_gid_dev = t(src.db_gid_dev).to(torch.int32)
    lc.row_of_gid = {int(g): int(r) for g, r in src.row_of_gid.items()}
    lc.vocab = (None if src.vocab is None
                else vocabulary(src.vocab, device))
    lc._vocab_levels = int(src._vocab_levels)
    lc._vocab_loaded = bool(src._vocab_loaded)
    lc.last_closed_gid = int(src.last_closed_gid)
    a = getattr(src, "_residual_anchor", None)
    lc._residual_anchor = None if a is None else (int(a[0]), float(a[1]))
    lc._large_hist = [(int(g), np.array(x))
                      for g, x in getattr(src, "_large_hist", [])]
    lc.loop_edges = [(int(a), int(b), np.array(Z, np.float32))
                     for a, b, Z in src.loop_edges]
    lc.events = [LoopEvent(*ev) for ev in src.events]
    g = getattr(src, "last_loop_gid", None)
    lc.last_loop_gid = None if g is None else int(g)
    lc._pending = [
        (t(pack), [int(r) for r in rows], [int(x) for x in gids],
         tuple(t(f) for f in feats), [np.array(T, np.float32) for T in Ts],
         int(gauge_idx))
        for pack, rows, gids, feats, Ts, gauge_idx
        in getattr(src, "_pending", [])]
    return lc
