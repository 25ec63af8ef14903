"""The port's chunked run against the JAX package, on the 24-frame 620x188
sequence of tests/test_engine_chunked.py (uint8 frames from the port's
renderer, the same numpy frames into both packages).

The JAX side runs `run_step`: tests/test_engine_chunked.py's
test_chunked_matches_per_frame already holds the JAX package's chunked run
equal to its per-frame run, and its scan program costs a long CPU compile.
Statuses and keyframes must be equal; per-frame camera positions within
that file's 5e-2 m (float32 summation order in LK, LM and BA moves a pose
by ~1e-4 m per frame; a different inlier set or keyframe moves it by
decimetres).
"""

import numpy as np

from ssvio_tpu.eval import ate
from ssvio_tpu.system import System as SystemJ
from ssvio_tpu_torch import frontend as fe_t
from test_engine_chunked import _settings
from test_torch_engine import render_sequence, run_chunks
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

POS_ATOL_M = 5e-2        # tests/test_engine_chunked.py's tolerance


def test_run_chunk_matches_jax_package():
    s_t, poses, L, R = render_sequence()
    sys_j = SystemJ(_settings(), enable_backend=True,
                    enable_loop_closing=False)
    st_j = []
    for i in range(len(L)):
        sys_j.run_step(L[i], R[i], 0.1 * i)
        st_j.append(sys_j.status)
    sys_t, st_t = run_chunks(s_t, L, R, [8, 8, 8])

    assert st_t == st_j
    assert fe_t.TRACKING_BAD in st_t and fe_t.LOST not in st_t
    assert sys_t.stats["n_keyframes"] == sys_j.stats["n_keyframes"] >= 2
    assert [k["frame_id"] for k in sys_t.records.keyframes] == \
        [k["frame_id"] for k in sys_j.keyframes]
    _, tj = sys_j.frame_trajectory()
    _, tt = sys_t.frame_trajectory()
    assert len(tt) == len(tj) == len(L)
    np.testing.assert_allclose(tt[:, :, 3], tj[:, :, 3], atol=POS_ATOL_M)
    for est in (tt, tj):
        assert ate.ape_translation(est[:, :, 3], poses[:, :, 3])["rmse"] < 0.3
