"""python -m nerf_pytorch_paeng_tpu_torch --config <file> [--device cpu]
(training), or ... --eval_only true --testing_idx N (evaluation), or ...
--render_only true --testing_idx N (novel views)"""
import sys

from .driver import main

sys.exit(main())
