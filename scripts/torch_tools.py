"""What the port's measurement tools (scripts/torch_profile_*.py and
scripts/torch_probe_*.py) share: the device a tool runs on, the card a
number was taken on, the kernel wrappers' launch counters, and a snapshot
of a System's live state to run the same frames again from.
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys
from typing import Dict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssvio_tpu_torch import graphs  # noqa: E402
from ssvio_tpu_torch.frontend import resolve_device  # noqa: E402
from ssvio_tpu_torch.system import System  # noqa: E402

# what a snapshot shares with the live System instead of copying: the
# settings, the stateless engine and frontend, the upload stream; of the
# loop closer the settings, the sample hook, the generator (its state is
# copied) and the verification's graphs
SHARED = ("s", "frontend", "_engine", "_upload_stream", "loopclosing")
LC_SHARED = ("s", "sample_idx_fn", "_gen", "_graphs")


def tool_device(tool: str, device=None) -> torch.device:
    """The device a measurement tool runs on: `device` where one is given
    ("cpu" for the CPU), else the current CUDA device; without one, None
    raises (a tool never falls back to the CPU)."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: no CUDA device; pass --device cpu to "
                           "run on the CPU")
    return resolve_device(device)


def synchronize(device) -> None:
    """Wait for the work queued on a CUDA `device`; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters (each counts the launches of
    its CUDA kernel, a graph's replays included; the plain versions on CPU
    tensors count none)."""
    return graphs.launch_counts()


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """launch_counts() less `before`, the kernels launched since."""
    return {k: v - before[k] for k, v in launch_counts().items()}


def card_line(device) -> str:
    """The card a number was taken on: nvidia-smi's name and power limit
    (`--query-gpu=name,power.limit --format=csv,noheader`) where it runs,
    else torch's name of the device; "CPU" for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "CPU"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        out = None
    if out is not None and out.returncode == 0 and out.stdout.strip():
        return out.stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(index)


def snapshot(sys_: System) -> dict:
    """A deep copy of the System's state and of its LoopClosing's (one
    copy, so objects that two attributes share stay shared), with the
    loop closer's Generator state."""
    state = {k: v for k, v in vars(sys_).items() if k not in SHARED}
    lc = sys_.loopclosing
    if lc is not None:
        state["lc"] = {k: v for k, v in vars(lc).items()
                       if k not in LC_SHARED}
        state["lc_gen"] = lc._gen.get_state()
    return copy.deepcopy(state)


def restore(sys_: System, snap: dict):
    """Put the System (and its LoopClosing) back in the snapshot's state;
    the snapshot stays as it was, for another restore."""
    state = copy.deepcopy(snap)
    lc_state, gen = state.pop("lc", None), state.pop("lc_gen", None)
    for k, v in state.items():
        setattr(sys_, k, v)
    if lc_state is not None:
        for k, v in lc_state.items():
            setattr(sys_.loopclosing, k, v)
        sys_.loopclosing._gen.set_state(gen)
