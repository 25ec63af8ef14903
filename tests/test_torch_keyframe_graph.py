"""The device-resident keyframe branch on the CPU: local BA as a fixed trip,
the map inserts with device scalars, the keyframe branch with no host read,
and the static-buffer path of `graphs.KeyframeGraph` against the eager
branch.

- The fixed-trip `local_ba` is held against JAX's `local_ba` (two
  `while_loop`s that exit on data) at tests/test_torch_ba.py's tolerances,
  and bit for bit against the loops it replaced, which read their stop
  flags on the host and broke out (`_host_read_local_ba`, kept here as the
  reference), rounds and LM steps included.
- `insert_keyframe_device` and `add_landmarks` against JAX's on a free
  slot, a full window (eviction), and dead lanes that share a row with
  live ones (a dead lane must not reach a real row).
- The keyframe branch (`Engine.keyframe_branch`, `local_ba`) and a
  `KeyframeGraph` call run under a guard that raises on every host read:
  the Python ones (`Tensor.item`, `__bool__`, ...) and, through a dispatch
  mode, the ones C++ makes (`aten._local_scalar_dense`: indexing by a 0-d
  tensor; `nonzero` and boolean-mask indexing) and every tensor made from
  host data. A frame through `Engine._step` and `System.run_step` reads
  only what the engine's docstring names.
- On the CPU a `KeyframeGraph` runs the branch on its static buffers
  without a capture; a System so built must equal one built with
  `eager=True` bit for bit on 24 frames, through run_step and pipelined
  chunks, with loop_desc on and off.
The capture and its replays need the card: tests/test_torch_gpu.py.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ssvio_tpu import map as map_j
from ssvio_tpu.ops import ba as ba_j
from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch import graphs, interop
from ssvio_tpu_torch import map as map_t
from ssvio_tpu_torch.ops import ba as ba_t
from ssvio_tpu_torch.ops import se3 as se3_t
from ssvio_tpu_torch.system import System
from test_ba import BASELINE, CX, CY, FX, FY, build_ba_problem
from test_torch_ba import LM_TOL_M, POSE_TOL, _twist_err
from test_torch_engine import render_sequence
from test_torch_graph_step import HostRead, no_host_reads
from test_torch_map_frontend import _assert_maps_equal, _random_map_inputs
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)


def _host_read_local_ba(prob, fx, fy, cx, cy, baseline, max_rounds=5,
                        iters=10, target_inlier_ratio=0.7):
    """local_ba (no mesh) as the port ran it before: both stop flags read
    on the host, and breaks. Returns (result, rounds, LM steps run)."""
    bl = torch.as_tensor(baseline, dtype=torch.float32)
    pose_free = (prob.kf_valid & ~prob.kf_fixed).to(torch.float32)
    lm_has_obs = torch.any(prob.obs_valid.flatten(1), dim=1)
    lm_free = (prob.lm_valid & ~prob.lm_fixed & lm_has_obs).to(torch.float32)
    steps = 0

    def lm_inner(kf_T_cw, lm_pos, edge_active, n_iters):
        nonlocal steps
        blocks = ba_t._ba_cost_and_blocks(prob, kf_T_cw, lm_pos, fx, fy, cx,
                                          cy, bl, edge_active)
        lam = 1e-5 * torch.max(torch.diagonal(blocks[1], dim1=1, dim2=2))
        nu = torch.tensor(2.0)
        T, lp = kf_T_cw, lm_pos
        for _ in range(n_iters):
            steps += 1
            F, Hpp, Hll, Hpl, bp, blm = blocks
            dxp, dxl = ba_t._schur_solve(Hpp, Hll, Hpl, bp, blm, lam,
                                         pose_free, lm_free)
            T_new = se3_t.compose(se3_t.exp(dxp), T)
            lp_new = lp + dxl
            blocks_new = ba_t._ba_cost_and_blocks(prob, T_new, lp_new, fx, fy,
                                                  cx, cy, bl, edge_active)
            pred_l = torch.sum(dxl * (lam * dxl + blm.T))
            step = torch.maximum(torch.max(torch.abs(dxp)),
                                 torch.max(torch.abs(dxl)))
            finite = torch.all(torch.isfinite(dxp)) \
                & torch.all(torch.isfinite(dxl))
            pred = 0.5 * (torch.sum(dxp * (lam * dxp + bp)) + pred_l)
            rho = (F - blocks_new[0]) / torch.clamp(pred, min=1e-9)
            accept = (rho > 0) & finite
            T = torch.where(accept, T_new, T)
            lp = torch.where(accept, lp_new, lp)
            blocks = tuple(torch.where(accept, n, o)
                           for n, o in zip(blocks_new, blocks))
            lam = torch.where(
                accept,
                lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                lam * nu)
            nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
            if bool(((step < 1e-5) & finite).item()):
                break
        return T, lp

    base_active = prob.obs_valid & prob.lm_valid[:, None, None] \
        & prob.kf_valid[None, :, None]
    n_act = torch.clamp(torch.sum(base_active), min=1)
    kf_T_cw, lm_pos = prob.kf_T_cw, prob.lm_pos
    inlier_edges = torch.ones_like(prob.obs_valid)
    rounds = 0
    for _ in range(max_rounds):
        rounds += 1
        kf_T_cw, lm_pos = lm_inner(kf_T_cw, lm_pos, base_active & inlier_edges,
                                   iters)
        r, _, z_ok = ba_t._ba_residuals(prob, kf_T_cw, lm_pos, fx, fy, cx, cy,
                                        bl)
        inlier_edges = (torch.sum(r * r, dim=-1) < ba_t.BACKEND_CHI2_TH) \
            & z_ok[..., None]
        ratio = torch.sum(inlier_edges & base_active) / n_act
        if bool((ratio > target_inlier_ratio).item()):
            break
    r, _, z_ok = ba_t._ba_residuals(prob, kf_T_cw, lm_pos, fx, fy, cx, cy, bl)
    chi2 = torch.sum(r * r, dim=-1)
    final_inlier = (chi2 < ba_t.BACKEND_CHI2_TH) & z_ok[..., None]
    ratio = torch.sum(final_inlier & base_active) / n_act
    return (ba_t.LocalBAResult(kf_T_cw, lm_pos, prob.obs_valid & final_inlier,
                               chi2, ratio.to(torch.float32)), rounds, steps)


# tests/test_torch_ba.py's two cases (the ratio flag set after the first
# round, the inner LM to its cap), one whose ratio flag is set after the
# second round, one that runs all five, and a noiseless one whose inner LM
# stalls within its cap
CASES = [
    dict(perturb_pose=0.1, perturb_lm=0.3),
    dict(noise=0.5, outlier_frac=0.1, perturb_pose=0.05, perturb_lm=0.2),
    dict(noise=0.9, outlier_frac=0.24, perturb_pose=0.05, perturb_lm=0.2),
    dict(noise=1.5, outlier_frac=0.35, perturb_pose=0.05, perturb_lm=0.2),
    dict(noise=0.0, perturb_pose=0.001, perturb_lm=0.0),
]


def _problems(seed, **kw):
    prob_j, _, _, _, n_lm = build_ba_problem(
        np.random.default_rng(seed), W=4, M=256, n_kf=4, **kw)
    return prob_j, interop.to_torch(prob_j, ba_t.LocalBAProblem), n_lm


# JAX's result is compared on every case but the one that stops after the
# second round: there the two packages' float32 sums, taken in different
# orders, leave one landmark 39 m deep 1.9 mm apart (more than LM_TOL_M;
# poses 2e-6, edges and ratio equal). The fixed trip's part in that case
# is its freeze, which the bit-equality to the host-read loop holds.
@pytest.mark.parametrize("case,vs_jax", [(c, i != 2)
                                         for i, c in enumerate(CASES)])
def test_fixed_trip_local_ba_matches_jax_and_the_host_read_loop(case, vs_jax):
    prob_j, prob_t, n_lm = _problems(302, **case)
    rt = ba_t.local_ba(prob_t, FX, FY, CX, CY, BASELINE)
    ref, rounds, steps = _host_read_local_ba(prob_t, FX, FY, CX, CY, BASELINE)
    for f in ref._fields:
        if getattr(ref, f) is not None:
            assert torch.equal(getattr(rt, f), getattr(ref, f)), f
    assert (int(rt.rounds), int(rt.iterations)) == (rounds, steps)
    assert 1 <= rounds <= 5 and rounds <= steps <= 10 * rounds
    if not vs_jax:
        return
    rj = ba_j.local_ba(prob_j, FX, FY, CX, CY, BASELINE)
    assert _twist_err(rt.kf_T_cw.numpy(), np.asarray(rj.kf_T_cw)).max() \
        < POSE_TOL
    np.testing.assert_allclose(rt.lm_pos.numpy()[:n_lm],
                               np.asarray(rj.lm_pos)[:n_lm], atol=LM_TOL_M)
    np.testing.assert_array_equal(rt.obs_valid.numpy(),
                                  np.asarray(rj.obs_valid))
    assert float(rt.inlier_ratio) == pytest.approx(float(rj.inlier_ratio))


def test_the_stops_freeze_the_state():
    """A round after the ratio flag and an LM step after the stop flag
    change nothing: more rounds or more steps than the flags allow leave
    the result bit for bit, and count the same rounds and steps."""
    _, prob, _ = _problems(302, **CASES[2])
    two = ba_t.local_ba(prob, FX, FY, CX, CY, BASELINE, max_rounds=2)
    five = ba_t.local_ba(prob, FX, FY, CX, CY, BASELINE, max_rounds=5)
    assert (int(five.rounds), int(five.iterations)) == (2, 20)
    _, prob, _ = _problems(302, **CASES[4])
    ten = ba_t.local_ba(prob, FX, FY, CX, CY, BASELINE, max_rounds=1)
    thirty = ba_t.local_ba(prob, FX, FY, CX, CY, BASELINE, max_rounds=1,
                           iters=30)
    assert 1 < int(ten.iterations) < 10
    for a, b in ((two, five), (ten, thirty)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# the round guards' three problems: the ratio flag set after round 1,
# after round 3 (outlier edges planted at the edge of the target ratio)
# and never
GUARD_CASES = {
    1: CASES[0],
    3: dict(noise=0.8, outlier_frac=0.265, perturb_pose=0.05, perturb_lm=0.2),
    5: CASES[3],
}


@pytest.mark.parametrize("skip", [False, True], ids=["uncaptured", "skips"])
@pytest.mark.parametrize("rounds", sorted(GUARD_CASES))
def test_round_guards_match_the_host_read_loop(monkeypatch, rounds, skip):
    """The rounds after the first behind their guard (`ba._if_live`): as
    the guard runs them outside a capture (every body runs, and its
    selects freeze the state after the ratio flag), and as a replay of the
    graph's conditional nodes runs them (a body runs only while its flag
    is set; here the flag is read on the host). Each is bit for bit the
    host-read loop, rounds and LM steps included, and meets its guard once
    a round after the first, set as long as the ratio flag is not."""
    _, prob, _ = _problems(302, **GUARD_CASES[rounds])
    guard = ba_t._if_live
    flags = []

    def if_live(live, body):
        flags.append(bool(live))
        if not skip:
            guard(live, body)
        elif flags[-1]:
            body()

    monkeypatch.setattr(ba_t, "_if_live", if_live)
    rt = ba_t.local_ba(prob, FX, FY, CX, CY, BASELINE)
    ref, n_rounds, steps = _host_read_local_ba(prob, FX, FY, CX, CY, BASELINE)
    assert n_rounds == rounds
    assert flags == [k < rounds for k in range(1, ba_t.LOCAL_BA_ROUNDS)]
    for f in ref._fields:
        if getattr(ref, f) is not None:
            assert torch.equal(getattr(rt, f), getattr(ref, f)), f
    assert (int(rt.rounds), int(rt.iterations)) == (rounds, steps)


def _map_case(seed, fill, dead_rows):
    """_random_map_inputs, and with `dead_rows` the features without a
    landmark, the invalid ones and the right eyes without a match link to
    the live features' landmark rows: dead lanes on real rows."""
    m, f, T_new = _random_map_inputs(seed, fill=fill)
    if dead_rows:
        live = f["valid"] & (f["lm_slot"] >= 0)
        rows = f["lm_slot"][live]
        dead = ~live
        f["lm_slot"][dead] = rows[np.arange(dead.sum()) % len(rows)]
        f["valid"] = live.copy()
        f["valid"][dead] = False
    return m, f, T_new


@pytest.mark.parametrize("fill,dead_rows", [(2, False), (4, False),
                                            (4, True)])
def test_device_scalar_map_inserts_match_jax(fill, dead_rows):
    """insert_keyframe_device and add_landmarks (device slot and gid)
    against JAX's, field for field."""
    m, f, T_new = _map_case(501 + fill, fill, dead_rows)
    mj = map_j.MapState(**{k: jnp.asarray(v) for k, v in m.items()})
    mt = interop.map_state(m)
    args = (T_new, f["lm_slot"], f["uv_l"], f["uv_r"], f["has_r"], f["valid"])
    mj2, slot_j, gid_j = map_j.insert_keyframe(mj, *[jnp.asarray(a)
                                                     for a in args])
    args_t = [torch.from_numpy(a) for a in args]
    mt2, slot_t, gid_t = map_t.insert_keyframe_device(mt, *args_t)
    assert slot_t.shape == gid_t.shape == ()
    assert slot_t.dtype == gid_t.dtype == torch.int32
    assert (int(slot_t), int(gid_t)) == (int(slot_j), int(gid_j))
    _assert_maps_equal(mt2, mj2)
    _assert_maps_equal(mt, mj)            # the input map untouched

    rng = np.random.default_rng(510 + fill)
    K = 40
    p_w = rng.uniform(-5, 5, (K, 3)).astype(np.float32)
    new_valid = rng.uniform(size=K) < 0.5
    add = (p_w, f["uv_l"], f["uv_r"], f["has_r"], new_valid)
    mj3, slots_j = map_j.add_landmarks(mj2, slot_j, gid_j,
                                       *[jnp.asarray(a) for a in add])
    mt3, slots_t = map_t.add_landmarks(mt2, slot_t, gid_t,
                                       *[torch.from_numpy(a) for a in add])
    np.testing.assert_array_equal(slots_t.numpy(), np.asarray(slots_j))
    _assert_maps_equal(mt3, mj3)


def test_dead_lanes_never_reach_a_real_row():
    """Every lane dead and linked to row 0: the map's observation tables
    change only in the cleared slot, landmark 0's rows not at all."""
    m, f, T_new = _map_case(521, 4, False)
    mt = interop.map_state(m)
    N = len(f["lm_slot"])
    zero = torch.zeros(N, dtype=torch.int32)
    uv = torch.full((N, 2), 777.0)
    mt2, slot, _ = map_t.insert_keyframe_device(
        mt, torch.from_numpy(T_new), zero, uv, uv,
        torch.ones(N, dtype=torch.bool), torch.zeros(N, dtype=torch.bool))
    mt3, slots = map_t.add_landmarks(
        mt2, slot, mt2.next_kf_gid - 1, torch.zeros((N, 3)), uv, uv,
        torch.ones(N, dtype=torch.bool), torch.zeros(N, dtype=torch.bool))
    assert torch.all(slots == -1)
    keep = torch.arange(mt.obs_uv.shape[1]) != int(slot)
    assert torch.equal(mt3.obs_uv[:, keep], mt.obs_uv[:, keep])
    assert not torch.any(mt3.obs_uv == 777.0)
    assert torch.equal(mt3.lm_pos, mt.lm_pos)
    assert torch.equal(mt3.lm_gid, mt.lm_gid)


class _NoSyncs(TorchDispatchMode):
    """Raises HostRead on the aten calls that read a device value on the
    host or wait for the device, and on a tensor made from host data (a
    host-to-device copy a CUDA graph cannot capture)."""

    REFUSED = {"_local_scalar_dense", "item", "nonzero", "masked_select",
               "_unique", "_unique2", "unique_dim", "unique_consecutive",
               "lift_fresh"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.REFUSED:
            raise HostRead(f"aten.{name}")
        if name in ("index", "index_put", "index_put_") and any(
                torch.is_tensor(i) and i.dtype in (torch.bool, torch.uint8)
                for i in (args[1] or ()) if i is not None):
            raise HostRead(f"aten.{name} by a boolean mask")
        if name == "repeat_interleave" and torch.is_tensor(args[0]) \
                and len(args) > 1 and torch.is_tensor(args[1]) \
                and kwargs.get("output_size") is None:
            raise HostRead("aten.repeat_interleave without output_size")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_syncs(monkeypatch):
    """No host read of any kind (no_host_reads's Python ones, and the
    dispatch mode's), and no tensor from numpy."""
    def refuse(*a, **k):
        raise HostRead("torch.from_numpy")

    with no_host_reads(monkeypatch), monkeypatch.context() as m:
        m.setattr(torch, "from_numpy", refuse)
        with _NoSyncs():
            yield


def test_the_dispatch_guard_catches_what_cpp_reads(monkeypatch):
    x = torch.arange(6.0)
    args = _insert_args()
    for bad in (lambda: x[torch.argmin(x)], lambda: x[x > 2],
                lambda: torch.tensor(2.0),
                lambda: int(map_t.insert_keyframe_device(*args)[1])):
        with no_syncs(monkeypatch), pytest.raises(HostRead):
            bad()
    with no_syncs(monkeypatch):
        map_t.insert_keyframe_device(*args)


def _insert_args():
    m, f, T_new = _random_map_inputs(531, fill=4)
    return (interop.map_state(m), torch.from_numpy(T_new),
            *[torch.from_numpy(f[k]) for k in ("lm_slot", "uv_l", "uv_r",
                                               "has_r", "valid")])


@pytest.fixture(scope="module")
def sequence():
    """test_torch_engine.render_sequence's 24 frames, at 1024 landmark
    slots (its 4096 make a fixed-trip BA ~5 s a keyframe on one CPU
    thread)."""
    s, poses, L, R = render_sequence()
    return dataclasses.replace(s, max_landmarks=1024), poses, L, R


class _Counted:
    """Counts the host reads of Tensor (item, __bool__, ...) inside it."""

    NAMES = ("item", "__bool__", "__int__", "__float__", "__index__",
             "tolist", "cpu", "numpy")

    def __init__(self, monkeypatch):
        self.mp, self.reads = monkeypatch, []

    def __enter__(self):
        self.ctx = self.mp.context()
        m = self.ctx.__enter__()
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def method(t, *a, _orig=orig, _name=name, **k):
                self.reads.append(_name)
                return _orig(t, *a, **k)
            m.setattr(torch.Tensor, name, method)
        return self

    def __exit__(self, *exc):
        self.ctx.__exit__(*exc)


def test_keyframe_branch_reads_no_host_value(sequence, monkeypatch):
    s, _, L, R = sequence
    # loop closing on: the engine emits the loop descriptors (the frames
    # run through Engine._step, so the loop closer sees none of them)
    sys_ = System(s, enable_backend=True, enable_loop_closing=True,
                  device="cpu")
    eng, f = sys_._engine, sys_.frontend
    reads = {}
    i = 0
    while True:
        before = sys_.status
        carry = sys_._carry()
        with _Counted(monkeypatch) as c:
            c2, fr = eng._step(carry, sys_._pad(L[i]),
                               lambda i=i: sys_._pad(R[i]))
        kind = ("init" if before == fe.INITING else
                "steady" if fr.keyframe else "tracked")
        reads.setdefault(kind, c.reads)
        if kind == "steady":
            break
        sys_._install(c2)
        sys_.frame_id += 1
        i += 1
    # the init gate, the status of a tracked frame, and of the tracked
    # frame a steady keyframe replays the keyframe branch after
    assert reads == {"init": ["__bool__"], "tracked": ["__int__"],
                     "steady": ["__int__"]}
    assert fr.ran_ba and fr.desc is not None

    # the branch itself and its graph, under the full guard, against the
    # call outside it
    pyr_l, out = eng._track(carry, sys_._pad(L[i]))
    args = (sys_._pad(R[i]), pyr_l, out.feat, out.T_cw, out.rel_motion,
            carry.m)
    want = eng.keyframe_branch(*args, is_init=False)
    graph = graphs.KeyframeGraph(eng.keyframe_branch, *args)
    prob = map_t.ba_problem_from_map(want.m)
    with no_syncs(monkeypatch):
        got = eng.keyframe_branch(*args, is_init=False)
        got_g = graph(args[0].to(torch.uint8), *args[1:])   # u8 promoted
        got_g = graph(*args)
        res = ba_t.local_ba(prob, f._fx, f._fy, f._cx, f._cy, f._baseline)
    assert torch.isfinite(res.kf_T_cw).all()
    leaves = torch.utils._pytree.tree_leaves
    for a, b in ((got, want), (got_g, want)):
        assert len(leaves(a)) == len(leaves(b))
        for x, y in zip(leaves(a), leaves(b)):
            assert torch.equal(x, y)
    assert bool(want.accept) and int(want.kf_slot) >= 0
    ins = leaves(graph._in)
    for x in leaves(got_g):
        assert all(x.data_ptr() != y.data_ptr() for y in ins)
    assert graph.calls == 2


def test_run_step_reads_a_keyframe_record_once(sequence, monkeypatch):
    """run_step on a steady keyframe frame: the status read, the record's
    one packed read, the returned pose."""
    s, _, L, R = sequence
    sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                  device="cpu")
    i = 0
    while True:
        before = (sys_.status, sys_.stats["n_keyframes"])
        with _Counted(monkeypatch) as c:
            sys_.run_step(L[i], R[i], 0.1 * i)
        i += 1
        if before[0] != fe.INITING and sys_.stats["n_keyframes"] > before[1]:
            break
    assert c.reads == ["__int__", "cpu", "numpy", "cpu", "numpy"]
    assert sys_.stats["n_ba"] == 1
    rec = sys_.records.keyframes[-1]
    assert rec["gid"] == int(sys_.map.kf_gid.max())


def _run(seq, eager, chunk, loop):
    """The 24 frames in steps of `chunk` (run_step for 1, else pipelined
    dispatch_chunk / collect_chunk); `loop`: loop closing on, so the
    engine emits the loop descriptors. Returns (System, statuses, T_cw
    after each frame, steady keyframe frames, descriptors)."""
    s, _, L, R = seq
    sys_ = System(s, enable_backend=True, enable_loop_closing=loop,
                  device="cpu", eager=eager)
    statuses, poses, descs, prev = [], [], [], None
    for k in range(0, 24, chunk):
        if chunk == 1:
            sys_.run_step(L[k], R[k], 0.1 * k)
            statuses.append(sys_.status)
            poses.append(sys_.T_cw.clone())
            continue
        h = sys_.dispatch_chunk(L[k:k + chunk], R[k:k + chunk])
        if prev is not None:
            sys_.collect_chunk(prev)
        prev = h
        statuses += [int(v) for v in h.outs.status]
        poses += list(h.outs.T_cw)
        descs.append(h.outs.desc)
    if prev is not None:
        sys_.collect_chunk(prev)
    before = [fe.INITING] + statuses[:-1]
    n_steady = sum(b in (fe.TRACKING_GOOD, fe.TRACKING_BAD)
                   and a == fe.TRACKING_BAD for b, a in zip(before, statuses))
    return sys_, statuses, torch.stack(poses), n_steady, descs


@pytest.mark.parametrize("chunk,loop", [(1, False), (6, True)])
def test_static_buffer_path_equals_eager(sequence, chunk, loop):
    ref, st_ref, T_ref, n_steady, d_ref = _run(sequence, True, chunk, loop)
    got, st, T, _, d = _run(sequence, False, chunk, loop)
    assert st == st_ref and fe.LOST not in st
    assert got.stats == ref.stats and ref.stats["n_ba"] == n_steady >= 2
    assert torch.equal(T, T_ref)
    assert all(torch.equal(a, b) for a, b in zip(d, d_ref))
    assert got.records.gids() == ref.records.gids()
    for a, b in zip(got.records.keyframes, ref.records.keyframes):
        np.testing.assert_array_equal(a["T_cw"], b["T_cw"])
    assert not ref._engine.kf_graphs
    # every steady keyframe went through the graph's buffers, and each
    # logged its BA's rounds and steps
    (graph,) = got._engine.kf_graphs.values()
    assert graph.calls == n_steady and graphs.replays()[1] == 0
    trips = torch.stack(list(got._engine.ba_trips))
    assert torch.equal(trips, torch.stack(list(ref._engine.ba_trips)))
    assert len(trips) == n_steady and bool(torch.all(trips[:, 0] >= 1))
    got.close()
    assert not got._engine.kf_graphs
