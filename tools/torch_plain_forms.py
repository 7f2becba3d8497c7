#!/usr/bin/env python3
"""Time the plain PyTorch forms the port chose for median_blur, rect
morphology and the per-image histograms against the other exact forms, on
one CUDA card.

    python3 tools/torch_plain_forms.py      # from the repository root

Each line gives ms per call (CUDA events around 10 calls after 2 warm-up
calls), whether the form equals the port's op bit for bit, and for the
medians the peak device memory. The shipped forms are
``mies_tpu_torch.ops.filters.median_blur`` (a sorting network cut to the
middle wire, on strided views of the padded image),
``mies_tpu_torch.ops.morphology.dilate`` (an ``amax`` over an unfolded
view per axis) and ``mies_tpu_torch.ops.histogram._image_hists``
(``scatter_add_`` of ones). Without a card it exits 1.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F


def _ms(fn, x, iters=10) -> float:
    for _ in range(2):
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_plain_forms: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from mies_tpu_torch.ops import filters as TF
    from mies_tpu_torch.ops import histogram as TH
    from mies_tpu_torch.ops import morphology as TM

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((64, 512, 512), device=dev, generator=gen)

    def stacked(z, k):
        r = k // 2
        p = TF._pad2d(z, r, r, "nearest")
        h, w = z.shape[-2:]
        return [p[..., dy:dy + h, dx:dx + w]
                for dy in range(k) for dx in range(k)]

    forms = {
        "network (shipped)": lambda z, k: TF.median_blur(z, k),
        "stack + median(-1)": lambda z, k: torch.stack(
            stacked(z, k), -1).median(-1).values,
        "stack + median(0)": lambda z, k: torch.stack(
            stacked(z, k), 0).median(0).values,
        "stack + sort(-1)": lambda z, k: torch.stack(
            stacked(z, k), -1).sort(-1).values[..., k * k // 2],
        "stack + kthvalue(0)": lambda z, k: torch.stack(
            stacked(z, k), 0).kthvalue(k * k // 2 + 1, 0).values,
    }
    for k, batch in ((3, x), (5, x[:32]), (7, x[:32])):
        want = TF.median_blur(batch, k)
        for name, fn in forms.items():
            torch.cuda.reset_peak_memory_stats()
            t = _ms(lambda z: fn(z, k), batch)
            peak = torch.cuda.max_memory_allocated() / 2**20
            same = torch.equal(fn(batch, k), want)
            print(f"median k{k} {list(batch.shape)} {name}: {t:.3f} ms, "
                  f"equal {same}, peak {peak:.0f} MiB | {card}")
    x32 = x[:32]
    for k in (7, 31):
        want = TM.dilate(x32, k, "rect")
        pool = F.max_pool2d(x32, k, 1, k // 2)
        print(f"dilate rect k{k} {list(x32.shape)}: unfold + amax (shipped) "
              f"{_ms(lambda z: TM.dilate(z, k, 'rect'), x32):.3f} ms, "
              f"max_pool2d {_ms(lambda z: F.max_pool2d(z, k, 1, k // 2), x32):.3f}"
              f" ms, equal {torch.equal(pool, want)} | {card}")
    idx = (x32 * 255).long().reshape(32, -1)

    def bincount(i):
        off = torch.arange(i.shape[0], device=i.device)[:, None] * 256
        return torch.bincount((i + off).reshape(-1),
                              minlength=i.shape[0] * 256).reshape(-1, 256)

    same = torch.equal(bincount(idx), TH._image_hists(idx, 256))
    print(f"histograms {list(x32.shape)}: scatter_add_ (shipped) "
          f"{_ms(lambda i: TH._image_hists(i, 256), idx):.3f} ms, bincount "
          f"{_ms(bincount, idx):.3f} ms, equal {same} | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
