#!/usr/bin/env python
"""Convert KITTI ground-truth poses + times.txt into a TUM trajectory, with
the PyTorch port (the port's counterpart of
scripts/kitti_poses_and_timestamps_to_trajectory.py; it writes the same
file).

Produces the "t x y z qx qy qz qw" file evo consumes for APE evaluation
(reference scripts/kitti_poses_and_timestamps_to_trajectory.py:14-25),
through `ssvio_tpu_torch.dataio.kitti.kitti_gt_to_tum`. Host numpy only:
it needs no device.

Usage:
    python scripts/torch_kitti_poses_and_timestamps_to_trajectory.py \\
        poses.txt times.txt out.tum
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    from ssvio_tpu_torch.dataio import kitti
    kitti.kitti_gt_to_tum(argv[0], argv[1], argv[2])
    print(f"trajectory -> {argv[2]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
