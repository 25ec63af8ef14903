"""The port's probes on the CPU: scripts/torch_probe_gauge_invariance.py
and scripts/torch_probe_tail_divergence.py, and the snapshot both take.

- Gauge invariance: after a rigid correction C (0.4 m, 0.05 rad) applied
  between chunks, and while a chunk is in flight, the later tracking
  health (median inlier count) of each chunk equals the uncorrected run's
  exactly, and every pose equals the uncorrected one moved into the new
  gauge, T_cw C, within the probe's POSE_TOL_M (1e-3 m in translation and
  rotation entries; measured on the CPU: 6.2e-06 m at this cut, 2.3e-04 m
  at a prefix of 20 frames and a tail of 20). The JAX probe
  (scripts/probe_gauge_invariance.py) runs 280 frames of the JAX System at
  import, minutes on this CPU, so it is not run against the port here; the
  probe's scene, C and checks are its, cut to chunks of CUT_CHUNK frames:
  a prefix of one chunk and a tail of one.
- The snapshot (scripts/torch_tools.py) copies the System's state and the loop closer's database
  tensors, pending candidates and Generator state: after more frames and a
  restore, the state is the snapshot's, and the same tail run twice from
  it gives bit-equal poses and equal healths.
- The tail probe at a cut (one chunk to the cut, one after it): its three
  tails (frozen, live, identity C) from one snapshot.

The probes' scene makes a keyframe, a local BA and a loop ingest nearly
every frame (~1.4 s a frame on one CPU thread), so every run here is cut
to chunks of CUT_CHUNK (the probes': 10).
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
sys.path.insert(0, SCRIPTS)

import torch_probe_gauge_invariance as gauge  # noqa: E402
import torch_probe_tail_divergence as tail  # noqa: E402
import torch_tools  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402

CPU = ["--device", "cpu"]
CUT_CHUNK = 5


@pytest.fixture
def cut(monkeypatch):
    monkeypatch.setattr(gauge, "CHUNK", CUT_CHUNK)
    monkeypatch.setattr(tail, "CHUNK", CUT_CHUNK)
    monkeypatch.setattr(tail, "CUT", CUT_CHUNK)
    monkeypatch.setattr(tail, "END", 2 * CUT_CHUNK)


def test_gauge_probe_holds_on_the_cpu(cut):
    r = gauge.main(CPU + ["--prefix", "5", "--end", "10"])
    base = r["baseline_healths"]
    assert len(base) == 1 and base[0] > 50
    for tag in ("corrected", "pipelined"):
        g = r[tag]
        assert g["healths"] == base and g["max_health_delta"] == 0.0
        assert g["max_translation_delta_m"] <= gauge.POSE_TOL_M
        assert g["max_rotation_delta"] <= gauge.POSE_TOL_M
        assert g["invariant"]


def _state(sys_):
    """What must come back from a snapshot: the map, the features, the
    pose, the records and the loop closer's database, as numpy."""
    lc = sys_.loopclosing
    out = {f"map.{k}": v.numpy().copy() for k, v in sys_.map._asdict().items()}
    out.update({f"feat.{k}": v.numpy().copy()
                for k, v in sys_.feat._asdict().items()})
    out["T_cw"] = sys_.T_cw.numpy().copy()
    out["keyframes"] = np.array([[k["gid"], k["frame_id"]]
                                 for k in sys_.records.keyframes])
    for k in ("desc_db", "desc_valid", "lm_pos", "db_gid_dev"):
        out[f"lc.{k}"] = getattr(lc, k).numpy().copy()
    out["lc.n"] = np.array(lc.n)
    out["gen"] = lc._gen.get_state().numpy().copy()
    return out


def test_snapshot_and_restore_give_one_state(cut):
    s = gauge.settings()
    _, L, R = tail.render(s, 10, "cpu")
    sys_ = System(s, enable_backend=True, enable_loop_closing=True,
                  device="cpu")
    with torch.no_grad():
        sys_.run_chunk(L[:5], R[:5])
        snap = torch_tools.snapshot(sys_)
        before = _state(sys_)
        # the loop closer draws from its Generator: moving it must not
        # reach the snapshot
        torch.rand(4, generator=sys_.loopclosing._gen)
        runs = []
        for _ in range(2):
            torch_tools.restore(sys_, snap)
            now = _state(sys_)
            assert set(now) == set(before)
            for k in before:
                np.testing.assert_array_equal(now[k], before[k], err_msg=k)
            recs = sys_.records
            assert recs.by_gid[recs.keyframes[-1]["gid"]] is \
                recs.keyframes[-1]           # shared records stay shared
            runs.append(tail.drive(sys_, L, R, 5, 10)
                        + [sys_.frame_trajectory()[1]])
    assert runs[0][:-1] == runs[1][:-1]
    np.testing.assert_array_equal(runs[0][-1], runs[1][-1])


def test_tail_probe_at_a_cut(cut):
    r = tail.main(CPU)
    assert set(r["tails"]) == set(tail.VARIANTS)
    frozen = r["tails"]["frozen"]
    assert len(frozen["healths"]) == 1 and frozen["healths"][0] > 50
    for v in tail.VARIANTS[1:]:
        t = r["tails"][v]
        assert len(t["healths"]) == 1
        assert t["min_health_vs_frozen"] == t["healths"][0] - \
            frozen["healths"][0]


@pytest.mark.parametrize("argv", [["--prefix", "15"], ["--prefix", "40",
                                                       "--end", "30"]])
def test_gauge_probe_refuses_frames_off_the_chunks(argv):
    with pytest.raises(SystemExit):
        gauge.main(CPU + argv)
