from .batching import RayPool, build_ray_pool
from .state import (TrainState, create_train_state, make_optimizer,
                    set_lr)

__all__ = ["RayPool", "TrainState", "build_ray_pool", "create_train_state",
           "make_optimizer", "set_lr"]
