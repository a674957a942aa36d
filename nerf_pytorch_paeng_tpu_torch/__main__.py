"""python -m nerf_pytorch_paeng_tpu_torch --config <file> --eval_only true
--testing_idx N [--device cpu]"""
import sys

from .driver import main

sys.exit(main())
