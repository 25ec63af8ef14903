"""Run the port's LK level kernels on fixed seeded inputs, and compare two
checkouts' kernels on them.

    PYTHONPATH=<checkout> python scripts/torch_lk_kernel_outputs.py --out A.pt
    python scripts/torch_lk_kernel_outputs.py --compare A.pt B.pt

`--out` takes the `ssvio_tpu_torch` package and the `chip_smoke.py` that
PYTHONPATH names (so the same script runs another checkout's kernels, and
times them with that checkout's `_device_ms`), makes the four levels of a
KITTI-sized pyramid (384x1248 down to 48x156, a smooth random texture from
numpy seed 7 and a copy moved by (2.3, -1.4) px per level-0 pixel), 512
keypoints (448 live), and runs every level kernel with kernel #1's
function (serial #1, sw #3, pk #4, mm and mm_f32 #5) at win 11, and #4 and
#5 at win 16 where the checkout's wrappers take it. It saves each output,
flag and device time a launch (torch.profiler, mean over 20 launches).
`--compare` prints, per kernel and level, whether the two checkouts'
outputs are equal bit for bit, their largest difference, and each
checkout's device time and its ratio to kernel #1's in the same file.
Needs a CUDA device.
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


def _inputs(dev):
    """Per level: (planes, pts, guess, frozen0, padded_hw)."""
    from ssvio_tpu_torch.ops import lk, pyramid
    rng = np.random.default_rng(7)
    img = _texture(rng, *LEVELS[0], sigma=3.0)
    img2 = _shifted(img, *SHIFT)
    pts0 = rng.uniform([16, 16], [LEVELS[0][1] - 16, LEVELS[0][0] - 16],
                       (N_KP, 2))
    out = []
    for l, (h, w) in enumerate(LEVELS):
        a = torch.from_numpy(img[::2 ** l, ::2 ** l].astype(np.float32))
        b = torch.from_numpy(img2[::2 ** l, ::2 ** l].astype(np.float32))
        gx, gy = pyramid.sobel_gradients(a)
        planes = [t.contiguous().to(dev) for t in (a, gx, gy, b)]
        pts = torch.from_numpy((pts0 / 2 ** l).astype(np.float32)).to(dev)
        # the guess 0.6 of the level's motion, as a coarser level seeds it
        guess = pts + 0.6 * torch.tensor(SHIFT, device=dev) / 2 ** l
        frozen0 = torch.zeros((N_KP, 1), dtype=torch.int32, device=dev)
        frozen0[N_LIVE:] = 1
        out.append((planes, pts, guess.contiguous(), frozen0,
                    lk.padded_dims(h, w)))
    return out


def dump(path):
    from chip_smoke import _device_ms
    from ssvio_tpu_torch.ops import lk_cuda
    from ssvio_tpu_torch.ops import lk_variants_cuda as lkv
    dev = torch.device("cuda", 0)
    kernels = {"serial": (lk_cuda.lk_level, {}),
               "sw": (lkv.lk_level_sw, {}),
               "pk": (lkv.lk_level_pk, {}),
               "mm": (lkv.lk_level_mm, dict(use_bf16=True)),
               "mm_f32": (lkv.lk_level_mm, dict(use_bf16=False))}
    res = {}
    with torch.no_grad():
        for l, (planes, pts, guess, frozen0, padded) in enumerate(
                _inputs(dev)):
            for name, (fn, extra) in kernels.items():
                for win in (11, 16):
                    def run():
                        return fn(*planes, pts, guess, frozen0, win=win,
                                  padded_hw=padded, **KW, **extra)
                    try:
                        out, flag = run()
                    except ValueError:        # the window is past its limit
                        continue
                    res[f"{name} win {win} level {l}"] = dict(
                        out=out.cpu(), flag=flag.cpu(),
                        device_ms=_device_ms(run))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.save(dict(card=smi, results=res), path)
    print(f"{smi}: {len(res)} kernel runs saved to {path}")


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    print(f"A {path_a} ({a['card']}), B {path_b} ({b['card']})")
    ra, rb = a["results"], b["results"]
    rows = []
    for key in ra:
        if key not in rb:
            continue
        ka, kb = ra[key], rb[key]
        l1 = "serial win 11 level " + key[-1]
        d = (ka["out"] - kb["out"]).abs().max(dim=-1).values
        row = dict(kernel=key, equal=bool(torch.equal(ka["out"], kb["out"])
                                          and torch.equal(ka["flag"],
                                                          kb["flag"])),
                   flags_equal=bool(torch.equal(ka["flag"], kb["flag"])),
                   max_diff_px=float(d.max()),
                   share_within_0_02=float((d <= 0.02).float().mean()),
                   ms_a=ka["device_ms"], ms_b=kb["device_ms"],
                   ratio_to_1_a=ka["device_ms"] / ra[l1]["device_ms"],
                   ratio_to_1_b=kb["device_ms"] / rb[l1]["device_ms"])
        rows.append(row)
        print(json.dumps(row))
    for key in sorted(set(rb) - set(ra)):
        ms = rb[key]["device_ms"]
        print(json.dumps(dict(kernel=key, only_in="B", ms_b=ms,
                              ratio_to_1_b=ms / rb["serial win 11 level "
                                                   + key[-1]]["device_ms"])))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.out:
        dump(args.out)
    if args.compare:
        compare(*args.compare)


if __name__ == "__main__":
    main()
