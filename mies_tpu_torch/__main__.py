"""``python -m mies_tpu_torch``: the command line (``mies_tpu_torch.cli``)."""

from mies_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
