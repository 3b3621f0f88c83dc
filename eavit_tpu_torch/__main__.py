"""CLI entry (counterpart of ``eavit_tpu/__main__.py``; reference
main.py:26-35): ``python -m eavit_tpu_torch --train|--eval --config_path ...
[--device cpu] [--config_options]``. Without ``--device`` the run needs a
CUDA GPU and fails without one. Launched by ``torchrun --nproc_per_node W``,
each process trains as one of W data-parallel ranks (``parallel/dp.py``);
launched alone, it is world size 1."""

from __future__ import annotations

import sys

from eavit_tpu_torch.config import get_args, print_config_options


def main(argv=None) -> None:
    if argv is None:
        argv = sys.argv[1:]
    if "--config_options" in argv:
        print_config_options()
        if not ("--train" in argv or "--eval" in argv):
            return
    args = get_args(argv)
    # lazy imports (reference main.py:29-35 imports train/eval lazily)
    if args.train:
        from eavit_tpu_torch.train import main as run
    else:
        from eavit_tpu_torch.eval import main as run
    run(args)


if __name__ == "__main__":
    main()
