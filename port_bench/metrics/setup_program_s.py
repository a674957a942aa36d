"""setup_program_s (s): the host seconds of the run spent in the program's
set-up spans (``utils/spans.setup_seconds``: the kernel library's hash and
load, ``pack_nerf``, the support grids, the ray pool, the train state and
the first chunk's eager steps and graph capture; nested spans counted
once), the part of ``setup_s`` that only the program can shorten.  Layer:
the entry and loops.  Nothing is read where the program has no set-up
spans."""


def read(rec):
    try:
        from nerf_pytorch_paeng_tpu_torch.utils.spans import (setup_seconds,
                                                              setup_table)
    except ImportError:
        return None
    return setup_seconds() if setup_table() else None
