"""The keyframe records (`records.py`) on the CPU: the gauge rule's two
forms against each other, the BA refresh of the window's keyframes by
gid, and a checkpoint round trip through the records."""

import json

import numpy as np
import torch

from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.ops import se3
from ssvio_tpu_torch.records import KeyframeRecords
from ssvio_tpu_torch.system import System
from ssvio_tpu_torch.utils import checkpoint
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)


def _poses(rng, n, scale=0.3):
    xi = rng.normal(0, scale, (n, 6)).astype(np.float32)
    return se3.exp(torch.from_numpy(xi)).numpy()


def _filled(rng, n=6):
    recs = KeyframeRecords()
    for g, T in enumerate(_poses(rng, n)):
        recs.add(10 + g, 0.1 * g, T, 3 * g, odometry_edge=g != 3)
    return recs


def test_regauged_poses_and_the_owed_correction_agree():
    """A pose taken at gauge index i, carried into the live gauge, then
    given what a correction C computed at i still owes, lands where C puts
    the pose in its own gauge: regauge(T, i) owed(C, i) = T C. The events
    are composed in order; with none since i both forms are the identity
    on their argument, bit for bit."""
    rng = np.random.default_rng(0)
    recs = KeyframeRecords()
    T, C = _poses(rng, 5), _poses(rng, 1)[0]
    assert recs.gauge_index() == 0
    assert recs.regauge(T, 0) is T
    np.testing.assert_array_equal(recs.owed(C, 0), C)
    events = _poses(rng, 3, scale=0.2)
    for E in events:
        recs.add_gauge_event(E)
    assert recs.gauge_index() == 3
    for i in range(4):
        live = recs.regauge(T, i)
        want = T
        for E in events[i:]:
            want = se3.compose_np(want, E)
        np.testing.assert_allclose(live, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(
            se3.compose_np(live, recs.owed(C, i)), se3.compose_np(T, C),
            atol=2e-5, rtol=0)
    np.testing.assert_array_equal(recs.owed(C, 3), C)


def test_refresh_keeps_an_evicted_but_valid_keyframe_by_gid():
    """The window's slots are not in record order: distance-based
    eviction keeps an old keyframe (gid 11) beside the newest ones. Its
    record takes its window pose by gid; a slot not valid (gid 12), and
    a gid never recorded, move nothing; the odometry edges stay as they
    were inserted."""
    rng = np.random.default_rng(1)
    recs = _filled(rng)
    before = [T.copy() for T in recs.poses()]
    edges = [(a, b, Z.copy()) for a, b, Z in recs.odometry_edges]
    assert [(a, b) for a, b, _ in edges] == [(10, 11), (11, 12), (13, 14),
                                            (14, 15)]
    new = _poses(rng, 5)
    recs.refresh(np.array([15, 11, 12, 14, 99], np.int32),
                 np.array([True, True, False, True, True]), new)
    moved = {15: new[0], 11: new[1], 14: new[3]}
    for g, T_old in zip(recs.gids(), before):
        np.testing.assert_array_equal(recs.pose(g), moved.get(g, T_old))
    assert recs.pose(11) is recs.keyframes[1]["T_cw"]
    for (a, b, Z), (a0, b0, Z0) in zip(recs.odometry_edges, edges):
        assert (a, b) == (a0, b0)
        np.testing.assert_array_equal(Z, Z0)
    _, T_wc = recs.trajectory()
    np.testing.assert_allclose(T_wc[:, :, 3], recs.centres(), atol=1e-5)


def test_checkpoint_round_trip_rebuilds_the_index(tmp_path):
    """save_checkpoint writes the records and edges under the JSON keys
    both packages read; load_checkpoint gives the System records equal to
    the saved ones with a gid index over the same dicts, which a refresh
    then reaches."""
    s = Settings()
    s.image_width, s.image_height = 128, 64
    s.max_features, s.max_landmarks, s.max_window = 64, 256, 6
    first = System(s, enable_loop_closing=False, device="cpu")
    rng = np.random.default_rng(2)
    first.records = _filled(rng)
    p = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(first, p)
    meta = json.loads(bytes(np.load(p)["meta_json"]).decode())
    assert list(meta)[-2:] == ["keyframes", "kf_rel_edges"]
    assert meta["keyframes"] == first.records.state()["keyframes"]

    resumed = System(s, enable_loop_closing=False, device="cpu")
    checkpoint.load_checkpoint(resumed, p)
    got, want = resumed.records, first.records
    assert got.gids() == want.gids() == list(got.by_gid)
    assert all(got.by_gid[k["gid"]] is k for k in got.keyframes)
    for a, b in zip(got.keyframes, want.keyframes):
        assert (a["frame_id"], a["timestamp"]) == (b["frame_id"],
                                                   b["timestamp"])
        np.testing.assert_array_equal(a["T_cw"], b["T_cw"])
    assert [(a, b) for a, b, _ in got.odometry_edges] == \
        [(a, b) for a, b, _ in want.odometry_edges]
    for (_, _, Z), (_, _, Z0) in zip(got.odometry_edges,
                                     want.odometry_edges):
        np.testing.assert_array_equal(Z, Z0)
    T = _poses(rng, 1)
    got.refresh(np.array([13]), np.array([True]), T)
    np.testing.assert_array_equal(got.keyframes[3]["T_cw"], T[0])
