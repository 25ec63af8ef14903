"""The port's landmark-sharded local BA (ssvio_tpu_torch/parallel/dist_ba.py,
ops/ba.py's mesh branches) against the JAX package's, on the CPU.

The port's ranks are processes joined in a gloo process group
(tests/torch_dist_worker.py); the JAX side is `dist_ba.distributed_local_ba`
on conftest's 8-device CPU mesh. Problems: tests/test_ba.py's
build_ba_problem with seed 11 (W 8, M 256) and seed 12 (M 512, 300
landmarks, 0.3 px noise), as tests/test_dist_ba.py builds them.

Tolerances are tests/test_dist_ba.py's: poses 5e-4, landmarks 5e-3,
inlier ratio 0.02 (the same math, summed in another order over other
shards). Bit-equal where the arithmetic is the same: a world of 1 against
the port's own local_ba, the ranks' poses against each other (every rank
solves the one camera system from the same reduced sums), and the
PrimaryBA's whole result against the SPMD shards.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssvio_tpu.ops import se3 as se3_j
from ssvio_tpu.parallel import dist_ba as dist_ba_j
from ssvio_tpu_torch.ops import ba as ba_t
from ssvio_tpu_torch.parallel import dist_ba
from test_ba import BASELINE, CX, CY, FX, FY, build_ba_problem
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from torch_dist_worker import launch

POSE_ATOL, LM_ATOL, RATIO_ATOL = 5e-4, 5e-3, 0.02
CAM = (FX, FY, CX, CY, BASELINE)
SEEDS = {11: dict(W=8, M=256, perturb_pose=0.08, perturb_lm=0.25),
         12: dict(W=8, M=512, n_lm=300, noise=0.3, perturb_pose=0.08,
                  perturb_lm=0.2)}


def _problems():
    out = {}
    for seed, kw in SEEDS.items():
        prob, T_true, lm_true, n_kf, n_lm = build_ba_problem(
            np.random.default_rng(seed), **kw)
        out[seed] = dict(np={k: np.array(v) for k, v in
                             prob._asdict().items()},
                         jax=prob, T_true=T_true, n_kf=n_kf, n_lm=n_lm)
    return out


@pytest.fixture(scope="module")
def problems():
    return _problems()


@pytest.fixture(scope="module")
def jax_results(problems):
    mesh = dist_ba_j.make_mesh()
    assert len(mesh.devices.ravel()) == 8
    step = dist_ba_j.distributed_local_ba(mesh, *CAM)
    return {seed: step(dist_ba_j.shard_problem(mesh, p["jax"]))
            for seed, p in problems.items()}


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    """Every rank's results at worlds 1, 2 and 4 (one launch each)."""
    job = dict(mode="ba", cam=CAM,
               problems=[problems[s]["np"] for s in SEEDS])
    return {world: launch(job, world, tmp_path_factory.mktemp(f"w{world}"))
            for world in (1, 2, 4)}


def _assembled(outs, i):
    """Problem i's whole result from the ranks' SPMD shards."""
    shards = [o["spmd"][i] for o in outs]
    whole = {k: np.concatenate([s[k] for s in shards])
             for k in ("lm_pos", "obs_valid", "chi2")}
    whole.update(kf_T_cw=shards[0]["kf_T_cw"],
                 inlier_ratio=shards[0]["inlier_ratio"])
    return whole


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("seed", list(SEEDS))
def test_sharded_ba_matches_jax_distributed(ranks, problems, jax_results,
                                            world, seed):
    i = list(SEEDS).index(seed)
    got = _assembled(ranks[world], i)
    want = jax_results[seed]
    n_lm = problems[seed]["n_lm"]
    np.testing.assert_allclose(got["kf_T_cw"], np.asarray(want.kf_T_cw),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(got["lm_pos"][:n_lm],
                               np.asarray(want.lm_pos)[:n_lm], atol=LM_ATOL)
    assert abs(float(got["inlier_ratio"])
               - float(want.inlier_ratio)) < RATIO_ATOL


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ba_converges_to_truth(ranks, problems, world):
    """tests/test_dist_ba.py::test_distributed_converges_to_truth on the
    port's ranks (seed 12)."""
    p = problems[12]
    kf = _assembled(ranks[world], list(SEEDS).index(12))["kf_T_cw"]
    for w in range(p["n_kf"]):
        err = np.asarray(se3_j.log(se3_j.compose(
            jnp.asarray(kf[w]), se3_j.inverse(jnp.asarray(p["T_true"][w])))))
        assert np.abs(err[:3]).max() < 0.05, (world, w, err)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ranks_agree_and_primary_gathers_the_shards(ranks, world):
    """Every rank solves the same camera system: its poses and inlier
    ratio are bit-equal to rank 0's. Rank 0's PrimaryBA, with the other
    ranks serving, returns the SPMD shards put together, bit for bit, and
    each server counts every problem."""
    outs = ranks[world]
    for i in range(len(SEEDS)):
        for o in outs[1:]:
            for k in ("kf_T_cw", "inlier_ratio"):
                np.testing.assert_array_equal(o["spmd"][i][k],
                                              outs[0]["spmd"][i][k])
        whole = outs[0]["whole"][i]
        for k, v in _assembled(outs, i).items():
            np.testing.assert_array_equal(whole[k], v, err_msg=k)
    assert outs[0]["n_solves"] == len(SEEDS)
    assert [o["served"] for o in outs[1:]] == [len(SEEDS)] * (world - 1)


@pytest.mark.parametrize("seed", list(SEEDS))
def test_world_of_one_is_bit_equal_to_local_ba(ranks, problems, seed):
    """At a world of 1 every all_reduce is the identity and local_ba's
    mesh branches keep its order of operations: the result is the port's
    local_ba's, bit for bit."""
    p = problems[seed]
    want = ba_t.local_ba(ba_t.LocalBAProblem(
        **{k: torch.from_numpy(v) for k, v in p["np"].items()}), *CAM)
    got = ranks[1][0]["spmd"][list(SEEDS).index(seed)]
    for k, v in want._asdict().items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_layout(problems, n):
    """M/n landmark rows a rank, in rank order; the pose fields whole; the
    specs name exactly the landmark fields."""
    prob = ba_t.LocalBAProblem(**{k: torch.from_numpy(v) for k, v in
                                  problems[11]["np"].items()})
    M = prob.lm_pos.shape[0]
    split = {k for k, v in dist_ba.problem_specs()._asdict().items() if v}
    assert split == {"lm_pos", "lm_valid", "lm_fixed", "obs_uv", "obs_valid"}
    assert {k for k, v in dist_ba.result_specs()._asdict().items()
            if v} == {"lm_pos", "obs_valid", "chi2"}
    shards = [dist_ba.shard_problem(
        dist_ba.Mesh(None, r, n, torch.device("cpu")), prob)
        for r in range(n)]
    for k, whole in prob._asdict().items():
        parts = [getattr(s, k) for s in shards]
        if k in split:
            assert all(x.shape[0] == M // n for x in parts)
            assert torch.equal(torch.cat(parts), whole)
        else:
            assert all(torch.equal(x, whole) for x in parts)


def test_shard_needs_a_divisible_landmark_axis(problems):
    prob = ba_t.LocalBAProblem(**{k: torch.from_numpy(v[:250] if v.shape[0]
                                                      == 256 else v)
                                  for k, v in problems[11]["np"].items()})
    mesh = dist_ba.Mesh(None, 0, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        dist_ba.shard_problem(mesh, prob)
    with pytest.raises(ValueError, match="not divisible"):   # no collective
        dist_ba.PrimaryBA(mesh, *CAM)(prob)
    with pytest.raises(ValueError, match="rank 0"):
        dist_ba.serve(mesh, *CAM)
    with pytest.raises(ValueError, match="rank 0"):
        dist_ba.PrimaryBA(mesh._replace(rank=1), *CAM)
