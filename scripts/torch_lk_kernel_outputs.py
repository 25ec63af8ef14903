"""Run the port's LK level kernels on fixed seeded inputs, and compare two
checkouts' kernels on them.

    PYTHONPATH=<checkout> python scripts/torch_lk_kernel_outputs.py --out A.pt
    python scripts/torch_lk_kernel_outputs.py --compare A.pt B.pt

`--out` takes the `ssvio_tpu_torch` package that PYTHONPATH names (so the
same script runs another checkout's kernels), makes the four levels of a
KITTI-sized pyramid (384x1248 down to 48x156, a smooth random texture from
numpy seed 7 and a copy moved by (2.3, -1.4) px per level-0 pixel), 512
keypoints (448 live), and runs each LK kernel (serial #1, sw #3, pk #4, mm
and mm_f32 #5, and patch #2 on lk.patch_inputs' boxes) at every window of
WINDOWS its wrapper takes in that checkout (`--kernels` picks some). It
saves each output and flag, the device time a launch (_device_ms) at 30
iterations and at 1, and the longest keypoint
chain at each (the most iterations of any keypoint, counted by the
kernel's plain version).
`--compare` prints, per kernel, window and level, whether the two
checkouts' outputs are equal bit for bit, their largest difference, each
checkout's device time and its ratio to kernel #1's in the same file, and
its time per iteration as a slope, (device at 30 - device at 1) / (chain
at 30 - chain at 1), with the fixed part, device at 1 - slope x chain at
1. Kernels of one function (SAME_FUNCTION: sw is serial's) are also held
against the other in A. Needs a CUDA device.
"""

import argparse
import json
import subprocess

import numpy as np
import torch

LEVELS = ((384, 1248), (192, 624), (96, 312), (48, 156))
SHIFT = (2.3, -1.4)
N_KP, N_LIVE = 512, 448
KW = dict(iters=30, eps=0.01, min_eig=1e-4)
WINDOWS = (11, 16, 23, 24)
KERNELS = ("serial", "sw", "pk", "mm", "mm_f32", "patch")
SAME_FUNCTION = {"sw": "serial"}


def _texture(rng, h, w, sigma):
    img = rng.uniform(0, 255, (h, w))
    r = int(3 * sigma)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    for ax in (0, 1):
        img = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax,
                                  img)
    return img / img.max() * 255.0


def _shifted(img, sx, sy):
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    x = np.clip(xx - sx, 0, w - 1)
    y = np.clip(yy - sy, 0, h - 1)
    x0 = np.minimum(np.floor(x).astype(int), w - 2)
    y0 = np.minimum(np.floor(y).astype(int), h - 2)
    fx, fy = x - x0, y - y0
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))


def _inputs(dev, levels=LEVELS, n_live=N_LIVE, hard=False):
    """Per level of `levels` (level 0 first, each half the one before):
    (planes, pts, guess, frozen0, padded_hw), with the first n_live of the
    N_KP keypoints live. hard: the current image is independent noise
    (numpy seed 8) instead of the shifted texture, so tracks step to the
    iteration cap."""
    from ssvio_tpu_torch.ops import lk, pyramid
    rng = np.random.default_rng(7)
    img = _texture(rng, *levels[0], sigma=3.0)
    img2 = (np.random.default_rng(8).uniform(0, 255, levels[0]) if hard
            else _shifted(img, *SHIFT))
    pts0 = rng.uniform([16, 16], [levels[0][1] - 16, levels[0][0] - 16],
                       (N_KP, 2))
    out = []
    for l, (h, w) in enumerate(levels):
        a = torch.from_numpy(img[::2 ** l, ::2 ** l].astype(np.float32))
        b = torch.from_numpy(img2[::2 ** l, ::2 ** l].astype(np.float32))
        gx, gy = pyramid.sobel_gradients(a)
        planes = [t.contiguous().to(dev) for t in (a, gx, gy, b)]
        pts = torch.from_numpy((pts0 / 2 ** l).astype(np.float32)).to(dev)
        # the guess 0.6 of the level's motion, as a coarser level seeds it
        guess = pts + 0.6 * torch.tensor(SHIFT, device=dev) / 2 ** l
        frozen0 = torch.zeros((N_KP, 1), dtype=torch.int32, device=dev)
        frozen0[n_live:] = 1
        out.append((planes, pts, guess.contiguous(), frozen0,
                    lk.padded_dims(h, w)))
    return out


def _runners(name, planes, pts, guess, frozen0, padded, win):
    """(kernel(iters), plain(iters, counts)) of kernel `name` at one
    level."""
    from ssvio_tpu_torch.ops import lk, lk_cuda, lk_patch_cuda
    from ssvio_tpu_torch.ops import lk_variants_cuda as lkv
    if name == "patch":
        h, w = planes[3].shape
        args, kw, _ = lk.patch_inputs(h, w, pts, guess, frozen0[:, 0] == 0,
                                      lk.LKParams(window=win))
        kw = {k: v for k, v in kw.items() if k != "iters"}
        return (lambda it: lk_patch_cuda.lk_patch(*planes, *args, iters=it,
                                                  **kw),
                lambda it, counts: lk_patch_cuda.lk_patch_ref(
                    *planes, *args, iters=it, counts=counts, **kw))
    fn, ref, extra = {
        "serial": (lk_cuda.lk_level, lk_cuda.lk_level_ref, {}),
        "sw": (lkv.lk_level_sw, lkv.lk_level_sw_ref, {}),
        "pk": (lkv.lk_level_pk, lkv.lk_level_pk_ref, {}),
        "mm": (lkv.lk_level_mm, lkv.lk_level_mm_ref, dict(use_bf16=True)),
        "mm_f32": (lkv.lk_level_mm, lkv.lk_level_mm_ref,
                   dict(use_bf16=False))}[name]
    kw = dict(KW, win=win, padded_hw=padded, **extra)
    del kw["iters"]
    args = (*planes, pts, guess, frozen0)
    return (lambda it: fn(*args, iters=it, **kw),
            lambda it, counts: ref(*args, iters=it, counts=counts, **kw))


def _device_ms(fn, reps=20, tries=5) -> float:
    """Device time of one launch of the LK kernel `fn` launches: the mean
    duration of its launches in a torch.profiler trace of `reps` calls. A
    trace may hold only some of them, or none, when many are taken in one
    process (one H100); the mean is over those it holds, and a trace with
    fewer than reps // 4 is taken again."""
    fn()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if "level_kernel" in e.key or "lk_patch_kernel" in e.key]
        if len(evts) > 1:
            raise AssertionError(f"profiler: more than one LK kernel: "
                                 f"{[(e.key, e.count) for e in evts]}")
        if evts and reps // 4 <= evts[0].count <= reps:
            return evts[0].device_time_total / 1e3 / evts[0].count
    raise AssertionError(f"profiler: {tries} traces of {reps} launches "
                         "held too few of them")


def _chain(plain, iters) -> int:
    counts = {}
    plain(iters, counts)
    return int(counts.get("max_iters", 0))


def dump(path, kernels):
    dev = torch.device("cuda", 0)
    res = {}
    with torch.no_grad():
        for l, (planes, pts, guess, frozen0, padded) in enumerate(
                _inputs(dev)):
            for name in kernels:
                for win in WINDOWS:
                    kern, plain = _runners(name, planes, pts, guess,
                                           frozen0, padded, win)
                    try:
                        out, flag = kern(KW["iters"])
                    except ValueError:        # the window is past its limit
                        continue
                    res[f"{name} win {win} level {l}"] = dict(
                        out=out.cpu(), flag=flag.cpu(),
                        device_ms=_device_ms(lambda: kern(KW["iters"])),
                        device_ms_1=_device_ms(lambda: kern(1)),
                        chain=_chain(plain, KW["iters"]),
                        chain_1=_chain(plain, 1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.save(dict(card=smi, results=res), path)
    print(f"{smi}: {len(res)} kernel runs saved to {path}")


def _slope(r):
    """(us per iteration, fixed ms) of one kernel run; None where the
    file has no time at 1 iteration or the chains are equal."""
    if "device_ms_1" not in r or r["chain"] == r["chain_1"]:
        return None, None
    us = 1e3 * (r["device_ms"] - r["device_ms_1"]) / (r["chain"]
                                                       - r["chain_1"])
    return us, r["device_ms_1"] - 1e-3 * us * r["chain_1"]


def _row(key, ka, kb, ra, rb):
    d = (ka["out"] - kb["out"]).abs().max(dim=-1).values
    level = key.rsplit(" ", 1)[-1]
    l1a = ra.get("serial win 11 level " + level)
    l1b = rb.get("serial win 11 level " + level)
    (us_a, fix_a), (us_b, fix_b) = _slope(ka), _slope(kb)
    return dict(kernel=key, equal=bool(torch.equal(ka["out"], kb["out"])
                                       and torch.equal(ka["flag"],
                                                       kb["flag"])),
                flags_equal=bool(torch.equal(ka["flag"], kb["flag"])),
                max_diff_px=float(d.max()),
                share_within_0_02=float((d <= 0.02).float().mean()),
                ms_a=ka["device_ms"], ms_b=kb["device_ms"],
                ratio_to_1_a=ka["device_ms"] / l1a["device_ms"] if l1a
                else None,
                ratio_to_1_b=kb["device_ms"] / l1b["device_ms"] if l1b
                else None,
                us_per_iter_a=us_a, fixed_ms_a=fix_a, us_per_iter_b=us_b,
                fixed_ms_b=fix_b, chain_b=kb.get("chain"))


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    print(f"A {path_a} ({a['card']}), B {path_b} ({b['card']})")
    ra, rb = a["results"], b["results"]
    rows = []
    for key in ra:
        if key in rb:
            rows.append(_row(key, ra[key], rb[key], ra, rb))
            print(json.dumps(rows[-1]))
    # B's kernels of one function against A's other kernel
    for key in rb:
        name, rest = key.split(" ", 1)
        other = f"{SAME_FUNCTION.get(name)} {rest}"
        if name in SAME_FUNCTION and other in ra:
            row = _row(key, ra[other], rb[key], ra, rb)
            row["kernel"] = f"{key} (B) vs {other} (A)"
            rows.append(row)
            print(json.dumps(row))
    for key in rb:
        if key not in ra:
            kb = rb[key]
            l1 = rb.get("serial win 11 level " + key.rsplit(" ", 1)[-1])
            us, fix = _slope(kb)
            print(json.dumps(dict(
                kernel=key, only_in="B", ms_b=kb["device_ms"],
                ratio_to_1_b=kb["device_ms"] / l1["device_ms"] if l1
                else None, us_per_iter_b=us, fixed_ms_b=fix,
                chain_b=kb["chain"])))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    args = ap.parse_args()
    if args.out:
        dump(args.out, args.kernels.split(","))
    if args.compare:
        compare(*args.compare)


if __name__ == "__main__":
    main()
