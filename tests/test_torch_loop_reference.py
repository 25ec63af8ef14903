"""The loop correction of the port against the benchmark's plain reference
(`benchmark/reference_loop.py`), on the CPU:

- the configuration file of `robotcar_xb3_slam` holds its preset, by the
  rules the benchmark's own test holds the other configurations to;
- on seeded pose graphs shaped as a loop closure leaves them (24-64
  keyframes, a noisy odometry chain, 1-3 loop edges, the first keyframe
  and a window of 8 fixed), `ops/pgo.py::optimize` reaches the float64
  optimum within `benchmark/loop_check.py::GAP_LIMIT` (gap = (cost -
  optimum) / optimum), and the reference's own solve in TF32 misses it;
- `LoopClosing._correct_active_impl` moves the window and its landmarks
  as `reference_loop.correct_active` does, within 1e-5 (float32 against
  float64 on poses a few metres from the origin);
- `LoopClosing._pose_graph_optimize` records its span and the counters
  `pgo.keyframes` / `pgo.edges`, which are the problem's sizes.

The spans of a correction on the whole chunk path are held in
tests/test_torch_loop_chunked.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import loop_check
from benchmark import reference as ref
from benchmark import reference_loop as rl
from benchmark.test_bench_harness import \
    test_config_files_hold_the_presets as _holds_the_preset
from ssvio_tpu_torch.config import Settings
from ssvio_tpu_torch.loopclosing import LoopClosing
from ssvio_tpu_torch.ops import pgo
from ssvio_tpu_torch.records import KeyframeRecords
from ssvio_tpu_torch.utils import profiling
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

WINDOW = 8
ACTIVE_ATOL = 1e-5


def test_robotcar_slam_config_file_holds_its_preset():
    _holds_the_preset("robotcar_xb3_slam", "robotcar_xb3_slam_settings")


def loop_graph(seed: int, n: int, n_loops: int, noise: float = 0.01):
    """A PGOProblem as a loop closure leaves it: n keyframes on 1.1 laps
    of a 6 m circle, odometry edges (i = k + 1, j = k) and `n_loops` loop
    edges from the last third to the first, each measurement perturbed
    by `noise` (a twist's std); the poses integrate the noisy odometry
    from the first, except a window of the last WINDOW keyframes, which a
    correction has put back on the truth. The first keyframe and the
    window are fixed. Padded to powers of two, as the program pads."""
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    ang = torch.linspace(0, 2 * np.pi * 1.1, n, dtype=f64)
    xi = torch.zeros(n, 6, dtype=f64)
    xi[:, 4] = ang
    T_wc = rl.se3_exp(xi)
    T_wc[:, :, 3] = torch.stack([6 * torch.sin(ang), 0 * ang,
                                 6 * (1 - torch.cos(ang))], -1)
    T_cw = rl.inverse(T_wc)
    edges = [(k + 1, k) for k in range(n - 1)]
    for a in torch.randperm(n // 3, generator=g)[:n_loops].tolist():
        edges.append((n - 1 - a, a))
    ei = torch.tensor([e[0] for e in edges])
    ej = torch.tensor([e[1] for e in edges])
    Z = rl.compose(T_cw[ei], rl.inverse(T_cw[ej]))
    Z = rl.compose(rl.se3_exp(noise * torch.randn(len(edges), 6, generator=g,
                                                  dtype=f64)), Z)
    init = [T_cw[0]]
    for k in range(n - 1):
        init.append(rl.compose(Z[k], init[-1]))
    init = torch.stack(init)
    init[-WINDOW:] = T_cw[-WINDOW:]
    P = 1 << (n - 1).bit_length()
    E = 1 << (len(edges) - 1).bit_length()
    poses = torch.eye(3, 4).repeat(P, 1, 1)
    poses[:n] = init.float()
    valid = torch.arange(P) < n
    fixed = torch.zeros(P, dtype=torch.bool)
    fixed[0] = True
    fixed[n - WINDOW:n] = True
    eZ = torch.eye(3, 4).repeat(E, 1, 1)
    eZ[:len(edges)] = Z.float()
    i_ = torch.zeros(E, dtype=torch.int32)
    j_ = torch.zeros(E, dtype=torch.int32)
    i_[:len(edges)] = ei.int()
    j_[:len(edges)] = ej.int()
    return pgo.PGOProblem(poses, valid, fixed, i_, j_, eZ,
                          torch.arange(E) < len(edges), torch.ones(E))


@pytest.mark.parametrize("seed,n,n_loops", [(0, 24, 1), (1, 40, 2),
                                            (2, 64, 3), (3, 33, 1)])
def test_pgo_reaches_the_reference_optimum(seed, n, n_loops):
    prob = loop_graph(seed, n, n_loops)
    best = rl.pgo_solve(prob)
    assert best.converged, best.iterations
    assert best.cost < rl.pgo_cost(prob, prob.poses)
    port = pgo.optimize(prob, iters=20)
    port_gap = ref.gap(rl.pgo_cost(prob, port), best.cost)
    with ref.precision("tf32"):
        control = rl.pgo_solve(prob)
    control_gap = ref.gap(control.cost, best.cost)
    assert -loop_check.GAP_LIMIT < port_gap < loop_check.GAP_LIMIT, port_gap
    assert control_gap >= loop_check.GAP_LIMIT, control_gap
    # the fixed vertices stay where they were, in both solutions
    held = prob.pose_fixed & prob.pose_valid
    assert torch.equal(port[held], prob.poses[held])
    assert torch.allclose(best.poses[held].float(), prob.poses[held],
                          atol=1e-6)


def test_reference_jacobian_is_the_derivative_of_the_residual():
    """SE3's inverse left Jacobian of the reference against central
    differences of log(exp(e) A), at small and at large twists."""
    g = torch.Generator().manual_seed(5)
    for scale in (1e-4, 0.7):
        xi = scale * torch.randn(16, 6, generator=g, dtype=torch.float64)
        A = rl.se3_exp(xi)
        h = 1e-6
        J = torch.zeros(16, 6, 6, dtype=torch.float64)
        for k in range(6):
            e = torch.zeros(6, dtype=torch.float64)
            e[k] = h
            up = rl.se3_log(rl.compose(rl.se3_exp(e).expand(16, 3, 4), A))
            dn = rl.se3_log(rl.compose(rl.se3_exp(-e).expand(16, 3, 4), A))
            J[:, :, k] = (up - dn) / (2 * h)
        assert torch.allclose(rl.se3_log(A), xi, atol=1e-12)
        assert torch.allclose(J, rl.se3_jl_inv(xi), atol=1e-8)


def test_correct_active_matches_the_reference():
    g = torch.Generator().manual_seed(3)
    W, M = 16, 256
    kf = rl.se3_exp(torch.randn(W, 6, generator=g, dtype=torch.float64))
    kf[:, :, 3] *= 5.0
    lm = 8.0 * torch.randn(M, 3, generator=g, dtype=torch.float64)
    valid = torch.rand(M, generator=g) < 0.7
    C = rl.se3_exp(torch.tensor([0.8, -0.3, 1.2, 0.05, 0.2, -0.1],
                                dtype=torch.float64))
    kf_t, lm_t = LoopClosing._correct_active_impl(kf.float(), lm.float(),
                                                  valid, C.float())
    kf_r, lm_r = rl.correct_active(kf.float(), lm.float(), valid, C.float())
    assert torch.allclose(kf_t.double(), kf_r, atol=ACTIVE_ATOL)
    assert torch.allclose(lm_t.double(), lm_r, atol=ACTIVE_ATOL)
    # landmarks that are not valid are left alone, bit for bit
    assert torch.equal(lm_t[~valid], lm.float()[~valid])


class _Records:
    """The host side of a System as `_pose_graph_optimize` reads it."""

    def __init__(self, prob, n):
        self.records = KeyframeRecords()
        for k in range(n):
            self.records.add(100 + k, 0.0, prob.poses[k].numpy(), k,
                             odometry_edge=False)
        self.records.odometry_edges = [
            (100 + k, 101 + k, np.eye(3, 4, dtype=np.float32))
            for k in range(n - 1)]
        self.active = [100 + k for k in range(n - WINDOW, n)]

    def active_gids(self):
        return self.active


def test_pgo_span_and_counters_hold_the_problem_sizes(monkeypatch):
    s = dataclasses.replace(Settings(), max_keyframes_db=8, max_features=8,
                            loop_desc_scales=1, vocab_levels=1, vocab_k=2)
    lc = LoopClosing(s, 100.0, 100.0, 50.0, 40.0, device="cpu")
    n = 21
    sys_ = _Records(loop_graph(4, n, 1), n)
    lc.loop_edges = [(100, 100 + n - 1, np.eye(3, 4, dtype=np.float32)),
                     (101, 100 + n - 2, np.eye(3, 4, dtype=np.float32))]
    seen = []
    optimize = pgo.optimize

    def keep(prob, *a, **k):
        seen.append(prob)
        return optimize(prob, *a, **k)

    monkeypatch.setattr(pgo, "optimize", keep)
    profiling.TRACE.reset()
    lc._pose_graph_optimize(sys_)
    (prob,) = seen
    assert [c.value for c in profiling.TRACE.counts("pgo.keyframes")] == \
        [int(prob.pose_valid.sum())] == [n]
    assert [c.value for c in profiling.TRACE.counts("pgo.edges")] == \
        [int(prob.edge_valid.sum())] == [n - 1 + 2]
    (span,) = profiling.TRACE.spans("loopclosing.pgo")
    assert span.t1 >= span.t0
    # the first keyframe and the window are held
    fixed = prob.pose_fixed.nonzero()[:, 0].tolist()
    assert fixed == [0] + list(range(n - WINDOW, n))
