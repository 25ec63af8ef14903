"""The device-resident tracking step on the CPU: the fixed-trip pose-only
LM, the tracking branch with no host read, and the static-buffer path of
`graphs.TrackGraph` against the direct call.

- The fixed-trip `_lm_loop_6dof` is held against JAX's `_lm_loop_6dof`
  (a `while_loop` that exits on a stalled step) and `pose_only_optimize`
  at tests/test_torch_ba.py's tolerances (poses 1e-4 in twist norm, equal
  inlier decisions), and bit for bit against the loop it replaced, which
  read its stop flag on the host and broke out (`_host_read_lm`, kept
  here as the reference): frozen state and a break leave the same bits.
- The tracking branch (`Frontend.track_frame`, `_track_step`,
  `pose_only_optimize`) and a `TrackGraph` call run under a guard that
  raises on every host read of a tensor.
- On the CPU a `TrackGraph` runs the function on its static buffers
  without a capture; a System so built must equal one built with
  `eager=True` bit for bit on tests/test_torch_engine.py's 24 frames,
  through run_step and pipelined chunks, with a snapshot/restore
  (scripts/torch_tools.py) and a checkpoint load between frames.
The capture and its replays need the card: tests/test_torch_gpu.py.
"""

import contextlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu.ops import ba as ba_j
from ssvio_tpu.ops import se3 as se3_j
from ssvio_tpu_torch import frontend as fe
from ssvio_tpu_torch import graphs
from ssvio_tpu_torch.ops import ba as ba_t
from ssvio_tpu_torch.ops import se3 as se3_t
from ssvio_tpu_torch.system import System
from ssvio_tpu_torch.utils import checkpoint
from test_ba import CX, CY, FX, FY, project, synth_scene
from test_torch_ba import POSE_TOL, _twist_err
from test_torch_engine import render_sequence
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import torch_tools  # noqa: E402


def _host_read_lm(T0, p_w, uv, weight, fx, fy, cx, cy, iters):
    """The pose-only LM as the port ran it before: the stop flag read on
    the host once an iteration, and a break."""
    H, b, F = ba_t._pose_only_normal_eq(T0, p_w, uv, weight, fx, fy, cx, cy)
    lam = 1e-5 * torch.max(torch.diagonal(H))
    nu = torch.tensor(2.0, dtype=H.dtype, device=H.device)
    T = T0
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    for _ in range(iters):
        dx = ba_t._solve(H + lam * eye6, b)
        T_new = se3_t.compose(se3_t.exp(dx), T)
        H_new, b_new, F_new = ba_t._pose_only_normal_eq(
            T_new, p_w, uv, weight, fx, fy, cx, cy)
        pred = 0.5 * torch.dot(dx, lam * dx + b)
        rho = (F - F_new) / torch.clamp(pred, min=1e-12)
        finite = torch.all(torch.isfinite(dx))
        accept = (rho > 0) & finite
        T = torch.where(accept, T_new, T)
        H = torch.where(accept, H_new, H)
        b = torch.where(accept, b_new, b)
        F = torch.where(accept, F_new, F)
        lam = torch.where(
            accept,
            lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
            lam * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        if bool(((torch.max(torch.abs(dx)) < 1e-7) & finite).item()):
            break
    return T


def _scene(seed, outliers, noise=0.5, n_points=200):
    """tests/test_torch_ba.py's pose-only scene: (T_init, p_w, uv, valid)
    numpy."""
    rng = np.random.default_rng(seed)
    p_w, T = synth_scene(rng, n_points=n_points)
    uv, z = project(T[2], p_w)
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    if outliers:
        idx = rng.choice(len(uv), outliers, replace=False)
        uv[idx] += rng.uniform(15, 60, (outliers, 2)).astype(np.float32)
    valid = z > 0
    valid[:5] = False
    xi = np.array([0.1, 0.05, -0.1, -0.01, 0.02, 0.005], np.float32)
    T_init = np.array(se3_j.compose(se3_j.exp(jnp.asarray(xi)),
                                    jnp.asarray(T[2])))
    return T_init, p_w, uv, valid


# noise 0 stalls the LM within the 10 iterations (the stop flag freezes the
# state); 0.5 px with or without outliers runs it to the cap or near it
@pytest.mark.parametrize("seed,outliers,noise", [
    (301, 0, 0.5), (341, 40, 0.5), (377, 0, 0.0)])
def test_fixed_trip_lm_matches_jax_and_the_host_read_loop(seed, outliers,
                                                          noise):
    T_init, p_w, uv, valid = _scene(seed, outliers, noise)
    args_t = [torch.from_numpy(a) for a in (T_init, p_w, uv)]
    w = torch.from_numpy(valid.astype(np.float32))
    T_t = ba_t._lm_loop_6dof(*args_t, w, FX, FY, CX, CY, 10)
    T_ref = _host_read_lm(*args_t, w, FX, FY, CX, CY, 10)
    assert torch.equal(T_t, T_ref)
    T_j = ba_j._lm_loop_6dof(jnp.asarray(T_init), jnp.asarray(p_w),
                             jnp.asarray(uv), jnp.asarray(w.numpy()),
                             FX, FY, CX, CY, 10)
    assert _twist_err(T_t.numpy(), np.asarray(T_j)) < POSE_TOL

    rt = ba_t.pose_only_optimize(*args_t, torch.from_numpy(valid),
                                 FX, FY, CX, CY)
    rj = ba_j.pose_only_optimize(jnp.asarray(T_init), jnp.asarray(p_w),
                                 jnp.asarray(uv), jnp.asarray(valid),
                                 FX, FY, CX, CY)
    assert _twist_err(rt.T_cw.numpy(), np.asarray(rj.T_cw)) < POSE_TOL
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert int(rt.n_inliers) == int(rj.n_inliers)


def test_the_stall_freezes_the_state():
    """A noiseless scene stalls within the cap: more iterations than the
    stall leave the same pose bit for bit."""
    T_init, p_w, uv, valid = _scene(377, 0, 0.0)
    args = [torch.from_numpy(a) for a in (T_init, p_w, uv)]
    w = torch.from_numpy(valid.astype(np.float32))
    T10 = ba_t._lm_loop_6dof(*args, w, FX, FY, CX, CY, 10)
    T40 = ba_t._lm_loop_6dof(*args, w, FX, FY, CX, CY, 40)
    assert torch.equal(T10, T40)


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Every way a tensor's value reaches the host raises HostRead."""
    def refuse(name):
        def method(self, *a, **k):
            raise HostRead(f"Tensor.{name} read a value on the host")
        return method

    with monkeypatch.context() as m:
        for name in ("item", "__bool__", "__int__", "__float__", "__index__",
                     "tolist", "cpu", "numpy"):
            m.setattr(torch.Tensor, name, refuse(name))
        yield


def test_the_guard_catches_a_host_read(monkeypatch):
    with no_host_reads(monkeypatch):
        with pytest.raises(HostRead):
            _host_read_lm(*[torch.from_numpy(a) for a in
                            _scene(301, 0)[:3]],
                          torch.ones(200), FX, FY, CX, CY, 10)


@pytest.fixture(scope="module")
def sequence():
    return render_sequence()


def _tracking_system(seq, eager):
    """A System on the CPU run until it tracks: (system, next frame)."""
    s, _, L, R = seq
    sys_ = System(s, enable_backend=True, device="cpu", eager=eager)
    i = 0
    while sys_.status not in (fe.TRACKING_GOOD, fe.TRACKING_BAD):
        sys_.run_step(L[i], R[i], 0.1 * i)
        i += 1
    return sys_, i


def test_tracking_branch_reads_no_host_value(sequence, monkeypatch):
    sys_, i = _tracking_system(sequence, eager=False)
    f = sys_.frontend
    c = sys_._carry()
    img = sys_._pad(sequence[2][i])
    args = (c.pyr_last, c.feat, c.T_cw, c.rel_motion, c.m.lm_pos,
            c.m.lm_valid, c.m.lm_gid)
    pyr_ref, out_ref = f.track_frame(img, *args)
    graph = graphs.TrackGraph(f, img, *args)
    lm_args = [torch.from_numpy(a) for a in _scene(341, 40)]
    with no_host_reads(monkeypatch):
        pyr, out = f.track_frame(img, *args)
        res = ba_t.pose_only_optimize(*lm_args, FX, FY, CX, CY)
        pyr_g, out_g = graph(img.to(torch.uint8), *args)   # u8 promoted
        pyr_g, out_g = graph(img, *args)
    assert int(out.n_inliers) > sys_.s.tracking_bad
    assert torch.isfinite(res.T_cw).all()
    for a, b in ((pyr, pyr_ref), (out, out_ref), (pyr_g, pyr_ref),
                 (out_g, out_ref)):
        for x, y in zip(torch.utils._pytree.tree_leaves(a),
                        torch.utils._pytree.tree_leaves(b)):
            assert torch.equal(x, y)
    # the outputs are the caller's own, not the graph's buffers
    ins = torch.utils._pytree.tree_leaves(graph._in)
    for x in torch.utils._pytree.tree_leaves((pyr_g, out_g)):
        assert all(x.data_ptr() != y.data_ptr() for y in ins)
    assert graph.calls == 2


def _run(seq, eager, chunk, tmp_path):
    """The 24 frames in steps of `chunk` (run_step for 1, else pipelined
    dispatch_chunk / collect_chunk), with frames 8..11 run twice: a
    snapshot before frame 8 is restored after frame 11. Before frame 16 a
    checkpoint is saved and loaded back (its tensors replace the carry's).
    Returns (System, statuses, T_cw after each frame, tracked frames)."""
    s, _, L, R = seq
    sys_ = System(s, enable_backend=True, device="cpu", eager=eager)
    tracked = []
    track_frame = sys_.frontend.track_frame

    def counted(*a):
        tracked.append(1)
        return track_frame(*a)

    if eager:
        sys_.frontend.track_frame = counted
    statuses, poses, snap, prev = [], [], None, None
    for k in list(range(0, 12, chunk)) + list(range(8, 24, chunk)):
        if k in (8, 16) and prev is not None:
            sys_.collect_chunk(prev)
            prev = None
        if k == 8:
            if snap is None:
                snap = torch_tools.snapshot(sys_)
            else:
                torch_tools.restore(sys_, snap)
        if k == 16:
            path = str(tmp_path / f"ckpt_{eager}_{chunk}.npz")
            checkpoint.save_checkpoint(sys_, path)
            checkpoint.load_checkpoint(sys_, path)
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
    if prev is not None:
        sys_.collect_chunk(prev)
    return sys_, statuses, torch.stack(poses), len(tracked)


@pytest.mark.parametrize("chunk", [1, 4])
def test_static_buffer_path_equals_the_direct_call(sequence, tmp_path,
                                                   chunk):
    ref, st_ref, T_ref, n_tracked = _run(sequence, True, chunk, tmp_path)
    got, st, T, _ = _run(sequence, False, chunk, tmp_path)
    assert st == st_ref and len(st) == 28
    assert got.stats["n_keyframes"] == ref.stats["n_keyframes"] >= 2
    assert torch.equal(T, T_ref)
    assert not ref._engine.graphs
    # every tracked frame went through the graph's buffers
    (graph,) = got._engine.graphs.values()
    assert graph.calls == n_tracked > 10
    got.close()
    assert not got._engine.graphs
