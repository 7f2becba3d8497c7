#!/usr/bin/env python3
"""Convert a denoiser checkpoint written by ``mies_tpu`` (orbax ``params/``
and ``meta.json``) into ``mies_tpu_torch``'s format (``params.pt``, a
PyTorch state dict, and the same ``meta.json``).

    python3 tools/convert_denoiser_ckpt.py ORBAX_DIR OUT_DIR

Run it where JAX, flax and orbax are installed (the JAX package restores
the checkpoint: ``mies_tpu.models.denoiser.load_denoiser``); the output
loads with ``mies_tpu_torch.models.denoiser.load_denoiser`` and runs as a
``learned_denoise`` stage of either package's chains, with PyTorch alone.
Prints one JSON line: the output directory, the architecture and the
number of tensors.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def convert(src: str | Path, dst: str | Path) -> dict:
    """Restore ``src`` with the JAX package and write it to ``dst`` in the
    port's format; returns the meta.json fields and the tensor count."""
    import jax
    import numpy as np

    from mies_tpu.models.denoiser import load_denoiser as load_orbax
    from mies_tpu_torch.models.convert import flax_to_torch
    from mies_tpu_torch.models.denoiser import save_denoiser

    params, features, depth, arch = load_orbax(str(Path(src).absolute()))
    state = flax_to_torch(jax.tree_util.tree_map(np.asarray, params), arch,
                          features, depth)
    save_denoiser(dst, state, features, depth, arch=arch)
    return {"output": str(dst), "arch": arch, "features": features,
            "depth": depth, "tensors": len(state)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="orbax checkpoint directory (mies_tpu)")
    ap.add_argument("dst", help="output directory (mies_tpu_torch format)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    print(json.dumps(convert(args.src, args.dst)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
